"""Parity of the port's elementwise ops, schedule, packing, rope, quantization and
config with the JAX package, on the CPU, in fp32.

Tolerances: elementwise fp32 ops agree to atol 1e-6 (both sides round once per op;
what is left is the order of a handful of fp32 operations). fp8 bytes must be
identical. The fp8 product is exact in both (fp8 values are exact in fp32/bf16), so it
differs only by fp32 summation order: rtol 1e-5.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu.ops import math as jmath
from flux_fp8_api_tpu.ops import packing as jpacking
from flux_fp8_api_tpu.ops import quant as jquant
from flux_fp8_api_tpu.ops import rope as jrope
from flux_fp8_api_tpu.ops import schedule as jschedule
from flux_fp8_api_tpu_torch.ops import math as tmath
from flux_fp8_api_tpu_torch.ops import packing as tpacking
from flux_fp8_api_tpu_torch.ops import quant as tquant
from flux_fp8_api_tpu_torch.ops import rope as trope
from flux_fp8_api_tpu_torch.ops import schedule as tschedule
from flux_fp8_api_tpu_torch.utils import config as tconfig

from .torch_parity import flatten, t

torch.set_num_threads(1)

ATOL = 1e-6


def rng(seed=0):
    return np.random.default_rng(seed)


class TestMath:
    def test_timestep_embedding(self):
        # t small enough that the fp32 argument reduction agrees between libraries
        ts = rng().uniform(0, 1e-3, size=(3,)).astype(np.float32)
        for dim in (256, 7):
            a = np.asarray(jmath.timestep_embedding(jnp.asarray(ts), dim))
            b = tmath.timestep_embedding(t(ts), dim).numpy()
            np.testing.assert_allclose(b, a, atol=ATOL)

    @pytest.mark.parametrize("op", ["rms_norm", "layer_norm", "gelu_tanh", "silu", "modulate", "clamp"])
    def test_elementwise(self, op):
        r = rng(1)
        x = r.normal(size=(2, 5, 32)).astype(np.float32)
        s = r.normal(size=(32,)).astype(np.float32)
        sh = r.normal(size=(2, 1, 32)).astype(np.float32)
        sc = r.normal(size=(2, 1, 32)).astype(np.float32)
        if op == "rms_norm":
            a, b = jmath.rms_norm(jnp.asarray(x), jnp.asarray(s)), tmath.rms_norm(t(x), t(s))
        elif op == "layer_norm":
            a, b = jmath.layer_norm(jnp.asarray(x)), tmath.layer_norm(t(x))
        elif op == "gelu_tanh":
            a, b = jmath.gelu_tanh(jnp.asarray(x)), tmath.gelu_tanh(t(x))
        elif op == "silu":
            a, b = jmath.silu(jnp.asarray(x)), tmath.silu(t(x))
        elif op == "modulate":
            a = jmath.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc))
            b = tmath.modulate(t(x), t(sh), t(sc))
        else:
            big = x * 40000
            a, b = jmath.clamp_policy(jnp.asarray(big), True), tmath.clamp_policy(t(big), True)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=1e-6)


class TestRope:
    def test_tables_and_apply(self):
        r = rng(2)
        ids = np.concatenate(
            [np.zeros((1, 5, 3)), np.asarray(jpacking.make_img_ids(8, 6, 1))], axis=1
        ).astype(np.float32)
        ca, sa = jrope.embed_nd_cos_sin(jnp.asarray(ids), (4, 6, 6), 10_000)
        cb, sb = trope.embed_nd_cos_sin(t(ids), (4, 6, 6), 10_000)
        np.testing.assert_allclose(cb.numpy(), np.asarray(ca), atol=ATOL)
        np.testing.assert_allclose(sb.numpy(), np.asarray(sa), atol=ATOL)
        q = r.normal(size=(1, 17, 2, 16)).astype(np.float32)
        k = r.normal(size=(1, 17, 2, 16)).astype(np.float32)
        qa, ka = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), ca[:, :, None], sa[:, :, None])
        qb, kb = trope.apply_rope(t(q), t(k), cb[:, :, None], sb[:, :, None])
        np.testing.assert_allclose(qb.numpy(), np.asarray(qa), atol=ATOL)
        np.testing.assert_allclose(kb.numpy(), np.asarray(ka), atol=ATOL)

    def test_deinterleave_permutation(self):
        np.testing.assert_array_equal(
            trope.deinterleave_permutation(128), jrope.deinterleave_permutation(128)
        )


class TestPackingSchedule:
    def test_pack_unpack_ids(self):
        x = rng(3).normal(size=(2, 4, 8, 6)).astype(np.float32)
        a, b = jpacking.pack_latents(jnp.asarray(x)), tpacking.pack_latents(t(x))
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(
            tpacking.unpack_latents(b, 64, 48).numpy(),
            np.asarray(jpacking.unpack_latents(a, 64, 48)),
        )
        np.testing.assert_array_equal(
            tpacking.make_img_ids(8, 6, 2).numpy(), np.asarray(jpacking.make_img_ids(8, 6, 2))
        )
        np.testing.assert_array_equal(
            tpacking.make_txt_ids(5, 2).numpy(), np.asarray(jpacking.make_txt_ids(5, 2))
        )

    @pytest.mark.parametrize("steps,seq,shift", [(28, 4096, True), (4, 1024, False), (12, 2304, True)])
    def test_schedule(self, steps, seq, shift):
        assert tschedule.get_schedule(steps, seq, shift=shift) == jschedule.get_schedule(steps, seq, shift=shift)


class TestQuant:
    def _weight(self, seed=4, shape=(48, 32)):
        # (in, out) for JAX; the port takes (out, in)
        return rng(seed).normal(scale=0.05, size=shape).astype(np.float32)

    def test_fp8_weight_bytes_and_scales(self):
        k = self._weight()
        bias = rng(5).normal(size=(32,)).astype(np.float32)
        a = jquant.quantize_linear_fp8(jnp.asarray(k), jnp.asarray(bias))
        b = tquant.quantize_linear_fp8(t(k.T), t(bias))
        np.testing.assert_array_equal(
            b.q.view(torch.uint8).numpy(), np.asarray(a.q).T.view(np.uint8)
        )
        assert float(b.w_scale) == float(a.w_scale)
        assert float(b.w_scale_inv) == float(a.w_scale_inv)

    def test_wo_fp8_weight_bytes_and_scales(self):
        k = self._weight(6)
        a = jquant.quantize_linear_wo_fp8(jnp.asarray(k), None)
        b = tquant.quantize_linear_wo_fp8(t(k.T), None)
        np.testing.assert_array_equal(
            b.q.view(torch.uint8).numpy(), np.asarray(a.q).T.view(np.uint8)
        )
        np.testing.assert_array_equal(b.w_scale_inv.numpy(), np.asarray(a.w_scale_inv))

    def test_e5m2_activation_bytes(self):
        x = (rng(7).normal(size=(4, 9, 48)) * 30).astype(np.float32)
        scale = np.float32(1234.5)
        a = jquant.to_fp8_saturated(jnp.asarray(x), scale, jquant.F8_INPUT_MAX).astype(jquant.INPUT_F8_DTYPE)
        b = tquant.to_fp8_saturated(t(x), torch.tensor(scale), tquant.F8_INPUT_MAX).to(tquant.INPUT_F8_DTYPE)
        np.testing.assert_array_equal(b.view(torch.uint8).numpy(), np.asarray(a).view(np.uint8))

    def test_amax_to_scale(self):
        """Bit-equal to JAX's, including the clamps (a true fp32 division)."""
        amax = np.concatenate([[0.0, 3e-13, 0.7, 1234.0], rng(11).lognormal(0, 4, 2000)]).astype(np.float32)
        for max_val in (tquant.F8_WEIGHT_MAX, tquant.F8_INPUT_MAX):
            a = np.asarray(jquant.amax_to_scale(jnp.asarray(amax), max_val))
            np.testing.assert_array_equal(tquant.amax_to_scale(t(amax), max_val).numpy(), a)

    @pytest.mark.parametrize("kind", ["float", "fp8", "wo_fp8"])
    def test_linear_apply_matches_jax(self, kind):
        from flux_fp8_api_tpu_torch.utils.convert import convert

        r = rng(8)
        k = self._weight(9)
        bias = r.normal(size=(32,)).astype(np.float32)
        x = r.normal(size=(2, 7, 48)).astype(np.float32)
        lin = jquant.Linear(kernel=jnp.asarray(k), bias=jnp.asarray(bias), kind="float")
        if kind == "fp8":
            lin = jquant.with_input_scale(
                jquant.quantize_linear_fp8(jnp.asarray(k), jnp.asarray(bias)), jnp.float32(np.abs(x).max())
            )
        elif kind == "wo_fp8":
            lin = jquant.quantize_linear_wo_fp8(jnp.asarray(k), jnp.asarray(bias))
        a, amax_a = jquant.linear_apply(lin, jnp.asarray(x), jnp.float32, collect_amax=True)
        tlin = convert(flatten(lin))
        b, amax_b = tquant.linear_apply(tlin, t(x), torch.float32, collect_amax=True)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
        assert float(amax_b) == float(amax_a)

    def test_with_input_scale(self):
        k = self._weight(10)
        a = jquant.with_input_scale(jquant.quantize_linear_fp8(jnp.asarray(k), None), jnp.float32(3.25))
        b = tquant.with_input_scale(tquant.quantize_linear_fp8(t(k.T), None), torch.tensor(3.25))
        assert float(b.in_scale) == float(a.in_scale)
        assert float(b.in_scale_inv) == float(a.in_scale_inv)

    def test_unported_kind_raises(self):
        # every kind the JAX package has is ported (tests/test_torch_quant_tiers.py)
        with pytest.raises(ValueError):
            tquant.Linear("nf4")


class TestConfig:
    def test_every_config_loads(self):
        import glob

        from flux_fp8_api_tpu.utils.config import ModelVersion
        from flux_fp8_api_tpu.utils.config import load_config_from_path as jload

        jax_versions = {v.value for v in ModelVersion}
        for path in sorted(glob.glob("configs/*.json") + glob.glob("configs/*/*.json")):
            b = tconfig.load_config_from_path(path)
            # a version only the port serves (Kontext) has flux-dev's flow and AE
            a = jload(path if b.version in jax_versions else "configs/config-dev.json")
            assert b.params.model_dump() == a.params.model_dump(), path
            assert b.ae_params.model_dump() == a.ae_params.model_dump(), path
            assert b.num_scale_trials == a.num_scale_trials

    def test_into_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for name in ("tpu:0", "gpu:0", "cuda:1"):
            with pytest.raises(RuntimeError, match="CUDA"):
                tconfig.into_device(name)
        assert tconfig.into_device("cpu") == torch.device("cpu")

    def test_into_device_maps_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert tconfig.into_device("tpu:0") == torch.device("cuda", 0)
        assert tconfig.into_device("gpu:1") == torch.device("cuda", 1)
        assert tconfig.into_device("cuda") == torch.device("cuda", 0)
        with pytest.raises(ValueError):
            tconfig.into_device("xpu:0")

    def test_into_dtype(self):
        assert tconfig.into_dtype("bfloat16") == torch.bfloat16
        assert tconfig.into_dtype(torch.float16) == torch.float16
        with pytest.raises(ValueError):
            tconfig.into_dtype("int3")


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax blocked. The FastAPI
    app (``api``) needs fastapi: where it is missing, that module's import must raise
    the ImportError that names the stdlib server, and nothing else."""
    code = (
        "import sys, pkgutil, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flux_fp8_api_tpu'] = None\n"
        "import flux_fp8_api_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "has_fastapi = importlib.util.find_spec('fastapi') is not None\n"
        "for n in names:\n"
        "    try:\n"
        "        importlib.import_module(n)\n"
        "    except ImportError as e:\n"
        "        if n != 'flux_fp8_api_tpu_torch.api' or has_fastapi or 'stdlib server' not in str(e):\n"
        "            raise\n"
        "import chip_smoke\n"
        "assert len(names) >= 20, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
