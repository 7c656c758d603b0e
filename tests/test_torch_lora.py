"""LoRA hot-load in the port against ``flux_fp8_api_tpu.lora``, on the CPU: the format
converters, the delta math, the fuse into float/fp8/int8/int4 Linears, the forward
after a fuse, the registry, and a fuse into a pipeline whose input scales were frozen
under ``torch.inference_mode``.

The LoRA files are ``tests/test_lora.py``'s kohya and diffusers writers (the diffusers
one leaves a q/k/v member out, so the zero fill and the rope permutation of the qkv
and linear1 rows are both exercised), plus the attention-only and mlp-only single
blocks of its zero-fill tests.

Tolerances: converted factors are equal. The delta is one fp32 product of rank 4
(12 for the fused qkv) in another summation order than numpy's: rtol 1e-6, atol 1e-7.
Fused float weights are equal. Fused fp8/int8/int4 bytes are equal, and so are the fp8
scales and every calibrated input scale. The int8/int4 per-channel weight scales of a
touched Linear differ from JAX's by one fp32 ulp in 10-24 of its 64 channels (relative
difference below 2^-22): XLA contracts the dequantize product and the delta sum inside
the JAX package's jitted fuse into one fused multiply-add, rounding once where the
port rounds twice, so the channel's amax can land one ulp apart. The forward after a
fuse agrees as the unfused forward does (test_torch_flux.py): relative norm 1e-4, for
fp8 on inputs where no e5m2 cast rounds differently on the two sides (on the inputs of
seed 1 one does, after this fuse, and the outputs part by 1.9e-3).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu import lora as jlora
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu_torch import lora as tlora
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops.quant import Linear
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from . import test_lora as jax_lora_tests
from .test_lora import HS, RANK, make_diffusers_lora, make_kohya_lora
from .test_torch_flux import make_inputs, run_jax, run_port
from .torch_parity import numpy_ae_params, numpy_flux_params, to_torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


def torch_sd(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def _mlp_only():
    r = np.random.RandomState(4)
    return {"transformer.single_transformer_blocks.0.proj_mlp.lora_A.weight": r.randn(RANK, HS).astype(np.float32) * 0.05,
            "transformer.single_transformer_blocks.0.proj_mlp.lora_B.weight": r.randn(4 * HS, RANK).astype(np.float32) * 0.05}


WRITERS = {
    "kohya": make_kohya_lora,
    "kohya_alpha": lambda: make_kohya_lora(seed=1, scale_alpha=2.0),
    "diffusers": make_diffusers_lora,
    "attention_only": lambda: jax_lora_tests.TestHeterogeneousZeroFill()._attn_only_lora(),
    "mlp_only": _mlp_only,
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_converters_match_jax(writer):
    sd = WRITERS[writer]()
    keys_a, a = jlora.resolve_lora_state_dict(dict(sd))
    keys_b, b = tlora.resolve_lora_state_dict(torch_sd(sd))
    assert keys_b == keys_a and sorted(b) == sorted(a)
    for k in a:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]), err_msg=k)


@pytest.mark.parametrize("alpha,a_rows", [(None, RANK), (RANK / 2, RANK), (np.float32(8.0), RANK),
                                          (np.array([2.0], np.float32), RANK), (None, 3 * RANK), (1.0, 3 * RANK)])
def test_delta_matches_jax(alpha, a_rows):
    r = np.random.default_rng(a_rows)
    A = r.normal(size=(a_rows, 24)).astype(np.float32)
    B = r.normal(size=(18, RANK)).astype(np.float32)
    want = jlora.calculate_lora_delta(A, B, alpha, 0.7)
    got = tlora.calculate_lora_delta(torch.from_numpy(A), torch.from_numpy(B),
                                     None if alpha is None else torch.as_tensor(alpha), 0.7)
    assert got.dtype == torch.float32 and got.shape == (18, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    return cfg, numpy_flux_params(cfg, seed=2)


@pytest.fixture(scope="module")
def port_cfg():
    return tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")


@pytest.fixture(scope="module")
def tier(jax_model):
    """kind → JAX params at that tier with calibrated input scales (float: as drawn),
    each made once."""
    cfg, params = jax_model
    made = {"float": params}

    def get(kind):
        if kind not in made:
            q = jflux.quantize_flux_tree(params, kind=kind)
            _, amaxes = run_jax(q, cfg, make_inputs(1), collect_amax=True)
            made[kind] = jcal.apply_input_scales(q, amaxes)
        return made[kind]

    return get


def _linears(model):
    for stack in ("double_blocks", "single_blocks"):
        for i, blk in enumerate(model[stack]):
            for name, lin in blk.items():
                if isinstance(lin, Linear):
                    yield f"{stack}.{i}.{name}", lin


@pytest.mark.parametrize("kind", ["float", "fp8", "int8", "int4"])
@pytest.mark.parametrize("writer", ["kohya", "diffusers"])
def test_fuse_matches_jax_bytes_and_scales(jax_model, port_cfg, tier, kind, writer):
    cfg, _ = jax_model
    params = tier(kind)
    keys, sd = jlora.resolve_lora_state_dict(WRITERS[writer]())
    want = dict(_linears(to_torch(jlora.fuse_lora(params, cfg, sd, keys, 0.7))))
    before = dict(_linears(to_torch(params)))
    model = to_torch(params)
    tkeys, tsd = tlora.resolve_lora_state_dict(torch_sd(WRITERS[writer]()))
    assert tlora.fuse_lora(model, port_cfg, tsd, tkeys, 0.7) is model
    touched = 0
    for name, lin in _linears(model):
        w = want[name]
        assert lin.kind == w.kind == kind, name
        if kind == "float":
            assert torch.equal(lin.weight, w.weight), name
        else:
            assert torch.equal(lin.q.view(torch.uint8), w.q.view(torch.uint8)), name
            assert torch.equal(lin.in_scale, w.in_scale) and torch.equal(lin.in_scale_inv, w.in_scale_inv), name
            if kind == "fp8":
                assert torch.equal(lin.w_scale, w.w_scale) and torch.equal(lin.w_scale_inv, w.w_scale_inv), name
            else:
                for f in ("w_scale", "w_scale_inv"):
                    torch.testing.assert_close(getattr(lin, f), getattr(w, f), rtol=2**-22, atol=0, msg=name)
        old = before[name]
        touched += not torch.equal(*(x.weight if kind == "float" else x.q.view(torch.uint8) for x in (lin, old)))
    assert touched == 3 if writer == "kohya" else touched >= 3


@pytest.mark.parametrize("kind", ["float", "fp8"])
def test_forward_after_fuse_matches_jax(jax_model, port_cfg, tier, kind):
    cfg, _ = jax_model
    params = tier(kind)
    sd = make_diffusers_lora()
    fused, reg = jlora.pipeline_load_lora(params, cfg, [], dict(sd), 1.3, "d")
    model, treg = tlora.pipeline_load_lora(to_torch(params), port_cfg, [], torch_sd(sd), 1.3, "d")
    assert [e.name for e in treg] == [e.name for e in reg] == ["d"]
    x = make_inputs(2)  # inputs that cross no e5m2 rounding boundary differently on the two sides
    a, b = np.asarray(run_jax(fused, cfg, x)), run_port(model, port_cfg, x).numpy()
    unfused = np.asarray(run_jax(params, cfg, x))
    assert np.linalg.norm(a - unfused) / np.linalg.norm(unfused) > 1e-3  # the fuse did something
    assert np.linalg.norm(b - a) / np.linalg.norm(a) < 1e-4


def test_registry_noop_rescale_unload_and_unknown(jax_model, port_cfg, caplog):
    _, params = jax_model
    x = make_inputs(2)
    base = to_torch(params)
    ref = run_port(base, port_cfg, x)
    sd = torch_sd(make_kohya_lora())

    model, reg = tlora.pipeline_load_lora(to_torch(params), port_cfg, [], dict(sd), 1.0, "x")
    held = dict(_linears(model))
    with caplog.at_level(logging.WARNING, logger="flux_fp8_api_tpu_torch.lora"):
        model, reg2 = tlora.pipeline_load_lora(model, port_cfg, reg, dict(sd), 1.0, "x")
    assert reg2 is reg and len(reg) == 1 and "same scale" in caplog.text
    assert all(lin is held[name] for name, lin in _linears(model))  # the same scale: no-op

    # rescale: 1.0 then 2.0 equals loading at 2.0
    model, reg = tlora.pipeline_load_lora(model, port_cfg, reg, dict(sd), 2.0, "x")
    direct, _ = tlora.pipeline_load_lora(to_torch(params), port_cfg, [], dict(sd), 2.0, "x")
    assert reg[0].scale == 2.0 and len(reg) == 1
    torch.testing.assert_close(run_port(model, port_cfg, x), run_port(direct, port_cfg, x), rtol=1e-4, atol=1e-4)

    # unload: the float weights come back to fp32 rounding of the sums
    model, reg = tlora.pipeline_unload_lora(model, port_cfg, reg, "x")
    assert reg == []
    torch.testing.assert_close(run_port(model, port_cfg, x), ref, rtol=1e-4, atol=1e-4)

    # an unknown name: nothing changes, a warning is logged
    held = dict(_linears(model))
    with caplog.at_level(logging.WARNING, logger="flux_fp8_api_tpu_torch.lora"):
        model, reg = tlora.pipeline_unload_lora(model, port_cfg, reg, "nope")
    assert reg == [] and "nope" in caplog.text
    assert all(lin is held[name] for name, lin in _linears(model))


def test_registry_dedupes_by_path_and_names_files(tmp_path, jax_model, port_cfg):
    _, params = jax_model
    path = tmp_path / "style.safetensors"
    save_safetensors(path, torch_sd(make_diffusers_lora()))
    model, reg = tlora.pipeline_load_lora(to_torch(params), port_cfg, [], str(path), 0.5)
    assert [(e.name, e.path, e.scale) for e in reg] == [("style.safetensors", str(path), 0.5)]
    model, reg = tlora.pipeline_load_lora(model, port_cfg, reg, str(path), 0.8)
    assert len(reg) == 1 and reg[0].scale == 0.8
    model, reg = tlora.pipeline_unload_lora(model, port_cfg, reg, "style.safetensors")
    assert reg == []


def test_guidance_keys_skipped_on_a_schnell_tree(port_cfg):
    """A LoRA touching guidance_in is skipped on a model without that embedder."""
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS.model_copy(update={"guidance_embed": False}))
    model = to_torch(numpy_flux_params(cfg))
    assert model["guidance_in"] is None
    r = np.random.RandomState(5)
    sd = {"guidance_in.in_layer.lora_A.weight": torch.from_numpy(r.randn(RANK, 256).astype(np.float32)),
          "guidance_in.in_layer.lora_B.weight": torch.from_numpy(r.randn(HS, RANK).astype(np.float32))}
    tlora.fuse_lora(model, dataclasses.replace(port_cfg, guidance_embed=False), sd, ["guidance_in.in_layer"], 1.0)
    assert model["guidance_in"] is None


def test_fuse_after_a_calibrated_generate(jax_model, port_cfg):
    """``generate`` runs under inference mode, so the input scales that calibration
    froze are inference tensors; a fuse must leave them as they were (no in-place
    write), and the pipeline serves before, after and past an unload."""
    params = jflux.quantize_flux_tree(jax_model[1])
    spec = tiny_spec(num_scale_trials=2, flow_dtype="float32", ae_dtype="float32")
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=port_cfg,
                        ae=to_torch(numpy_ae_params(TINY_AE_PARAMS)), config=spec)
    r = np.random.default_rng(6)
    vec = torch.from_numpy(r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32))
    txt = torch.from_numpy(r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32))
    pipe._encode_prompts = lambda prompts: {p: (vec, txt) for p in prompts}
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert not pipe._needs_calibration
    lin = pipe.model_params["double_blocks"][0]["img_attn_proj"]
    assert lin.in_scale.is_inference() and float(lin.in_scale) != 1.0
    in_scale = lin.in_scale.clone()
    unfused = pipe.last_latents.clone()

    pipe.load_lora(torch_sd(make_kohya_lora()), 1.0, name="k")
    fused_lin = pipe.model_params["double_blocks"][0]["img_attn_proj"]
    assert fused_lin is not lin and torch.equal(fused_lin.in_scale, in_scale)
    assert not torch.equal(fused_lin.q.view(torch.uint8), lin.q.view(torch.uint8))
    assert [e.name for e in pipe.loras] == ["k"]
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    assert torch.isfinite(pipe.last_latents).all() and not torch.equal(pipe.last_latents, unfused)

    pipe.unload_lora("k")
    assert pipe.loras == []
    pipe.generate("a cat", 64, 64, 3, seed=4, silent=True)
    rel = float((pipe.last_latents - unfused).norm() / unfused.norm())
    assert rel < 5e-2  # two requantizations: e4m3 rounding noise, as JAX's roundtrip test
