"""Every quantization tier of the port against the JAX package's, on the CPU: the
quantizers' bytes and scales, the int linears' integer products and epilogues,
dequantization and re-quantization, the input-scale laws, the tiny flux model at
int8 and int4 with calibration, T5 and CLIP at every weight-only tier, and the VAE
with weight-only fp8.

Tolerances: quantized bytes and scales are equal (the same fp32 operations on both
sides). The int32 products are equal (integer arithmetic); the int linear's output
is within one fp32 rounding of the epilogue (a fused multiply-add on one side and
not the other moves it by one ulp of the product): |Δ| ≤ 2^-21·max|out|. T5 and CLIP
at the weight-only tiers agree to 1e-5 (fp32 matmuls, summation order); the VAE
decode with fp8 weights to 1e-4 (a dozen convolutions summed in other orders). The
tiny flux model runs in fp32 with the JAX side's Pallas attention in interpret mode
(FORCE_PALLAS_INTERPRET, as tests/test_torch_flux.py does), so that both sides round
p to bf16 before P·V; what is left is fp32 summation order, and an activation that
crosses an int8 rounding step (1/127 of its layer's amax) on one side only: the
calibration amaxes agree to 1e-4 and the prediction to 1e-4 in norm. Against XLA
attention (``use_pallas=False``), which keeps p in fp32, the same forward differs by
about 1e-2: p's bf16 rounding moves activations across int8 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu.models import autoencoder as jae
from flux_fp8_api_tpu.models import clip as jclip
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.models import t5 as jt5
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.ops import quant as jquant
from flux_fp8_api_tpu_torch import calibration as tcal
from flux_fp8_api_tpu_torch.models import autoencoder as tae
from flux_fp8_api_tpu_torch.models import clip as tclip
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.models import t5 as tt5
from flux_fp8_api_tpu_torch.ops import quant as tquant

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS
from .test_torch_flux import make_inputs
from .torch_parity import amax_leaves, flatten, numpy_ae_params, numpy_flux_params, t, to_torch

torch.set_num_threads(1)

JAX_QUANTIZERS = {
    "int8": jquant.quantize_linear_int8, "int4": jquant.quantize_linear_int4,
    "wo_int8": jquant.quantize_linear_wo_int8, "wo_int4": jquant.quantize_linear_wo_int4,
    "wo_int2": jquant.quantize_linear_wo_int2,
}
PORT_QUANTIZERS = {
    "int8": tquant.quantize_linear_int8, "int4": tquant.quantize_linear_int4,
    "wo_int8": tquant.quantize_linear_wo_int8, "wo_int4": tquant.quantize_linear_wo_int4,
    "wo_int2": tquant.quantize_linear_wo_int2,
}


def rng(seed):
    return np.random.default_rng(seed)


def kernel(seed, in_f, out_f):
    """A JAX (in, out) kernel with channels of different magnitudes."""
    r = rng(seed)
    return (r.normal(size=(in_f, out_f)) * r.uniform(0.01, 0.2, size=(1, out_f))).astype(np.float32)


def jax_quantize(kind, k, bias=None):
    """The JAX quantizer as the JAX package runs it: the flow kinds jitted per leaf
    (quantize_flux_tree), where XLA forms the reciprocal scale as amax·(1/127); the
    weight-only kinds eagerly (quantize_stacked_weight_only)."""
    fn = JAX_QUANTIZERS[kind]
    if kind in ("int8", "int4"):
        fn = jax.jit(fn)
    return fn(jnp.asarray(k), None if bias is None else jnp.asarray(bias))


def both(kind, k, bias=None):
    """(JAX Linear, the port's Linear from the same weights)."""
    a = jax_quantize(kind, k, bias)
    b = PORT_QUANTIZERS[kind](t(k.T), None if bias is None else t(bias))
    return a, b


def assert_same_linear(b, a_converted):
    assert b.kind == a_converted.kind
    for name in ("q", "w_scale", "w_scale_inv", "in_scale", "in_scale_inv"):
        x, y = getattr(b, name), getattr(a_converted, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.shape == y.shape and x.dtype == y.dtype, name
            assert torch.equal(x, y), name


# in = 96: blocks of 64 do not divide it, so the blockwise kinds use one block per row
@pytest.mark.parametrize("in_f", [128, 96])
@pytest.mark.parametrize("kind", list(JAX_QUANTIZERS))
def test_quantizer_bytes_and_scales_match_jax(kind, in_f):
    k = kernel(1, in_f, 40)
    a, b = both(kind, k, rng(2).normal(size=(40,)).astype(np.float32))
    assert_same_linear(b, to_torch(a))
    assert b.in_features == in_f
    if kind in ("wo_int4", "wo_int2"):
        assert b.w_scale_inv.shape == (40, in_f // 64 if in_f % 64 == 0 else 1)


def test_int4_half_split_repack_after_transpose():
    """JAX packs rows i and i + in/2 of its (in, out) kernel into one byte; the
    transpose gives the port's (out, in/2) with the same pairing along in."""
    k = kernel(3, 64, 24)
    a, b = both("int4", k)
    qa = np.asarray(a.q)  # (in/2, out)
    np.testing.assert_array_equal(b.q.numpy(), qa.T)
    levels = np.round(np.clip(k * np.asarray(a.w_scale)[None, :], -7, 7)).astype(np.int8)  # (in, out)
    np.testing.assert_array_equal(tquant._unpack_int4(b.q).numpy(), levels.T)
    np.testing.assert_array_equal(tquant._unpack_int4(b.q).numpy(), np.asarray(jquant._unpack_int4(a.q)).T)
    assert np.all((b.q.numpy() & 0xF) == levels[:32].T + 7)
    assert np.all((b.q.numpy() >> 4) == levels[32:].T + 7)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_int_linear_product_and_epilogue_match_jax(kind):
    k = kernel(4, 64, 48)
    bias = rng(5).normal(size=(48,)).astype(np.float32)
    x = (rng(6).normal(size=(2, 9, 64)) * 3).astype(np.float32)
    a, b = both(kind, k, bias)
    amax = np.float32(np.abs(x).max())
    a = jax.jit(jquant.with_input_scale)(a, jnp.float32(amax))
    tquant.with_input_scale(b, torch.tensor(amax))
    assert float(b.in_scale) == float(a.in_scale) and float(b.in_scale_inv) == float(a.in_scale_inv)

    # the int32 product, as the JAX _linear_base forms it
    sc = a.in_scale.astype(jnp.bfloat16)
    x8a = jnp.round(jnp.clip(jnp.asarray(x).astype(jnp.bfloat16) * sc, -127, 127)).astype(jnp.int8)
    qa = jquant._unpack_int4(a.q) if kind == "int4" else a.q
    acc_a = jax.lax.dot_general(x8a, qa, (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    x8b = tquant.quantize_activation_int8(t(x), b.in_scale)
    np.testing.assert_array_equal(x8b.numpy(), np.asarray(x8a))
    qb = tquant._unpack_int4(b.q) if kind == "int4" else b.q
    acc_b = tquant.int_mm(x8b.reshape(-1, 64), qb)
    assert acc_b.dtype == torch.int32
    np.testing.assert_array_equal(acc_b.numpy().reshape(2, 9, 48), np.asarray(acc_a))

    out_a = np.asarray(jquant.linear_apply(a, jnp.asarray(x), jnp.float32)[0])
    out_b = tquant.linear_apply(b, t(x), torch.float32)[0].numpy()
    assert out_b.shape == out_a.shape == (2, 9, 48)
    np.testing.assert_allclose(out_b, out_a, rtol=0, atol=2**-21 * np.abs(out_a).max())


def test_int_mm_plain_version_is_exact_at_the_largest_sum():
    """|x8·q| summed over linear2's 15360 inputs: 127²·15360 < 2^31, exact in the
    fp64 product (an fp32 one is not above 2^24)."""
    x8 = torch.full((3, 15360), 127, dtype=torch.int8)
    q = torch.full((8, 15360), -127, dtype=torch.int8)
    q[1, 0] = 126
    out = tquant.int_mm(x8, q)
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == -127 * 127 * 15360
    assert int(out[0, 1]) == -127 * 127 * 15359 + 127 * 126


@pytest.mark.parametrize("kind", ["fp8", "int8", "int4", "wo_fp8", "wo_int8", "wo_int4", "wo_int2"])
def test_dequantize_kernel_matches_jax(kind):
    k = kernel(7, 128, 32)
    if kind in ("fp8", "wo_fp8"):
        qa = {"fp8": jquant.quantize_linear_fp8, "wo_fp8": jquant.quantize_linear_wo_fp8}[kind]
        a = qa(jnp.asarray(k), None)
        b = to_torch(a)
    else:
        a, b = both(kind, k)
    np.testing.assert_array_equal(tquant.dequantize_kernel(b).numpy(), np.asarray(jquant.dequantize_kernel(a)).T)


@pytest.mark.parametrize("kind", ["fp8", "int8", "int4"])
def test_with_kernel_keeps_input_scale_and_matches_jax(kind):
    k, k2 = kernel(8, 64, 32), kernel(9, 64, 32)
    a = jquant.with_input_scale({"fp8": jquant.quantize_linear_fp8, **JAX_QUANTIZERS}[kind](jnp.asarray(k), None),
                                jnp.float32(2.5))
    b = to_torch(a)
    a2 = jax.jit(jquant.with_kernel)(a, jnp.asarray(k2))
    b2 = tquant.with_kernel(b, t(k2.T))
    assert_same_linear(b2, to_torch(a2))
    assert float(b2.in_scale) == float(b.in_scale) != 1.0


def test_with_kernel_refuses_weight_only_kinds():
    _, b = both("wo_int4", kernel(10, 64, 16))
    with pytest.raises(ValueError, match="weight-only"):
        tquant.with_kernel(b, torch.zeros(16, 64))


@pytest.mark.parametrize("kind", ["fp8", "int8", "int4", "wo_int8"])
def test_with_input_scale_laws_match_jax(kind):
    quantizers = {"fp8": jquant.quantize_linear_fp8, **JAX_QUANTIZERS}
    a = quantizers[kind](jnp.asarray(kernel(11, 64, 16)), None)
    b = to_torch(a)
    set_scale = jax.jit(jquant.with_input_scale)  # as the JAX pipeline's calibration runs it
    for amax in (0.37, 3.25, 4000.0):
        a = set_scale(a, jnp.float32(amax))
        tquant.with_input_scale(b, torch.tensor(amax, dtype=torch.float32))
        if kind == "wo_int8":  # weight-only kinds quantize no activation
            assert a.in_scale is None and b.in_scale is None
            continue
        assert float(b.in_scale) == float(a.in_scale) and float(b.in_scale_inv) == float(a.in_scale_inv)
    if kind in ("int8", "int4"):
        assert float(b.in_scale) == np.float32(127.0) / np.float32(4000.0)


# ------------------------------------------------------------------- tiny flux model


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def flux_pair():
    jcfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    return jcfg, numpy_flux_params(jcfg, seed=3), tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_tiny_flux_int_tier_calibrates_and_matches_jax(flux_pair, kind, monkeypatch):
    """quantize (gigaquant's rules for int4: embedders too), calibrate 2 trials,
    apply: against JAX flux_apply."""
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)
    jcfg, params, pcfg = flux_pair
    embedders = kind == "int4"
    qa = jflux.quantize_flux_tree(params, True, embedders, kind=kind)
    model = tflux.quantize_flux_tree(to_torch(params), True, embedders, kind=kind)
    conv = to_torch(qa)
    mods = dict(conv.named_modules())
    for name, m in model.named_modules():
        if isinstance(m, tquant.Linear):
            assert_same_linear(m, mods[name])
    assert model["img_in"].kind == (kind if embedders else "float")
    assert model["final_layer"]["linear"].kind == "float"

    running_a = running_b = None
    for seed in (1, 2):
        x = make_inputs(seed)
        _, am_a = jflux.flux_apply(qa, jcfg, **{k: jnp.asarray(v) for k, v in x.items()}, collect_amax=True)
        _, am_b = tflux.flux_apply(model, pcfg, **{k: t(v) for k, v in x.items()}, collect_amax=True)
        running_a = jcal.merge_amax(running_a, am_a)
        running_b = tcal.merge_amax(running_b, am_b)
        qa = jcal.apply_input_scales_jit(qa, running_a)
        tcal.apply_input_scales(model, running_b)
    la, lb = amax_leaves(running_a), amax_leaves(running_b)
    assert sorted(la) == sorted(lb)
    for key in la:
        np.testing.assert_allclose(lb[key], la[key], rtol=1e-4, err_msg=key)
    scales = torch.stack([blk["linear2"].in_scale for blk in model["single_blocks"]]).numpy()
    np.testing.assert_allclose(scales, np.asarray(qa["single_blocks"]["linear2"].in_scale), rtol=1e-4)

    x = make_inputs(0)
    a = np.asarray(jflux.flux_apply(qa, jcfg, **{k: jnp.asarray(v) for k, v in x.items()}))
    b = tflux.flux_apply(model, pcfg, **{k: t(v) for k, v in x.items()}).numpy()
    assert b.shape == a.shape and np.isfinite(b).all()
    assert _rel(b, a) < 1e-4


# --------------------------------------------------------------- text encoders and VAE

T5_CFG = dict(vocab_size=64, d_model=64, d_ff=128, num_layers=2, num_heads=4, d_kv=16)
CLIP_CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2, num_heads=2,
                max_position_embeddings=77, eos_token_id=2)
TIERS = ["qfloat8", "qint8", "qint4", "qint2"]


@pytest.fixture(scope="module")
def encoders():
    t5_cfg, clip_cfg = jt5.T5Config(**T5_CFG), jclip.CLIPConfig(**CLIP_CFG)
    return (t5_cfg, jt5.init_t5_params(jax.random.PRNGKey(21), t5_cfg, jnp.float32),
            clip_cfg, jclip.init_clip_params(jax.random.PRNGKey(22), clip_cfg, jnp.float32))


def _same_blocks(port_params, jax_params):
    conv = to_torch(jax_params)
    for i, blk in enumerate(port_params["blocks"]):
        for name, m in blk.items():
            if isinstance(m, tquant.Linear):
                assert_same_linear(m, conv["blocks"][i][name])


@pytest.mark.parametrize("tier", TIERS)
def test_t5_weight_only_tier_matches_jax(encoders, tier):
    cfg, params, _, _ = encoders
    qa = jt5.quantize_t5_params(params, tier)
    qb = tt5.quantize_t5_params(to_torch(params), tier)
    _same_blocks(qb, qa)
    assert qb["blocks"][0]["wo"].kind == {"qfloat8": "wo_fp8"}.get(tier, "wo_" + tier[1:])
    ids = rng(12).integers(0, 64, size=(2, 16)).astype(np.int32)
    a = np.asarray(jt5.t5_encode(qa, cfg, jnp.asarray(ids), jnp.float32))
    b = tt5.t5_encode(qb, tt5.T5Config(**T5_CFG), torch.from_numpy(ids).long(), torch.float32).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tier", TIERS)
def test_clip_weight_only_tier_matches_jax(encoders, tier):
    _, _, cfg, params = encoders
    qa = jclip.quantize_clip_params(params, tier)
    qb = tclip.quantize_clip_params(to_torch(params), tier)
    _same_blocks(qb, qa)
    ids = rng(13).integers(3, 64, size=(2, 12)).astype(np.int32)
    ids[:, 7] = 2
    a_h, a_p = jclip.clip_encode(qa, cfg, jnp.asarray(ids), jnp.float32)
    b_h, b_p = tclip.clip_encode(qb, tclip.CLIPConfig(**CLIP_CFG), torch.from_numpy(ids).long(), torch.float32)
    np.testing.assert_allclose(b_h.numpy(), np.asarray(a_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b_p.numpy(), np.asarray(a_p), rtol=1e-5, atol=1e-5)


def test_vae_weight_only_fp8_decode_matches_jax():
    params = numpy_ae_params(TINY_AE_PARAMS, seed=8)
    qa = jae.quantize_ae_params(params)
    qb = tae.quantize_ae_params(to_torch(params))
    conv = to_torch(qa)
    for name, m in qb.named_modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor) and w.dim() == 4:
            ref = dict(conv.named_modules())[name]
            assert w.dtype == torch.float8_e4m3fn
            assert torch.equal(w.view(torch.uint8), ref.weight.view(torch.uint8)), name
            assert torch.equal(m.kscale_inv, ref.kscale_inv), name
    z = rng(9).normal(size=(1, 8, 6, TINY_AE_PARAMS.z_channels)).astype(np.float32)
    a = np.asarray(jax.jit(lambda p, z: jae.ae_decode(p, TINY_AE_PARAMS, z))(qa, jnp.asarray(z)))
    b = tae.ae_decode(qb, TINY_AE_PARAMS, t(z)).numpy()
    assert b.shape == a.shape == (1, 64, 48, 3)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
    # the converter carries a JAX-quantized VAE as well
    np.testing.assert_allclose(tae.ae_decode(conv, TINY_AE_PARAMS, t(z)).numpy(), a, rtol=1e-4, atol=1e-4)


def test_converter_round_trips_flatten():
    """flatten → convert keeps every blockwise field's shape in the port's layout."""
    a = jquant.quantize_linear_wo_int2(jnp.asarray(kernel(14, 128, 24)), None)
    d = flatten(a)
    assert d["q"].shape == (32, 24) and d["w_scale_inv"].shape == (2, 24)
    b = to_torch(a)
    assert b.q.shape == (24, 32) and b.w_scale_inv.shape == (24, 2)
