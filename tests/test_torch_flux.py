"""The port's flux model against the JAX package's, through the converter, on the CPU:
float and fp8 forwards, the calibration amax tree and scale write, the fp8 tier rules,
the logit bound and the random-init path.

Both sides run in fp32 and through the same attention function: the JAX side takes
the Pallas kernel in interpret mode (FORCE_PALLAS_INTERPRET, as tests/test_parallel.py
does), the port its kernel's plain version, so both round p to bf16 before P·V.
Tolerances: float forward relative norm 1e-4, elements 1e-3, amaxes rtol 1e-4: fp32
summation order, plus the odd p that the two sides round to neighbouring bf16 values,
which moves an attention output by about 2^-8 of that p's share and propagates. fp8
blocks: from the same inputs each block agrees to a relative norm of 1e-5, and so
does the whole fp8 forward (1e-4) on inputs that cross no e5m2 rounding boundary
differently on the two sides (e5m2 keeps 2 mantissa bits, so a crossing moves an
element by up to 25%; see the forward's test). Weight bytes, weight scales and the
scale write from given amaxes must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.ops import rope as jrope
from flux_fp8_api_tpu.ops.packing import make_img_ids, make_txt_ids
from flux_fp8_api_tpu_torch import calibration as tcal
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import rope as trope
from flux_fp8_api_tpu_torch.ops.quant import Linear

from .helpers import TINY_FLUX_PARAMS
from .torch_parity import amax_leaves, numpy_flux_params, t, to_torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    params = numpy_flux_params(cfg)
    return cfg, params


@pytest.fixture(scope="module")
def port_cfg():
    return tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")


def make_inputs(seed=0, h_latent=8, w_latent=6, txt_len=7):
    """numpy inputs: a tail-masked joint sequence (7 + 12 tokens)."""
    r = np.random.default_rng(seed)
    seq = (h_latent // 2) * (w_latent // 2)
    p = TINY_FLUX_PARAMS
    return dict(
        img=r.normal(size=(1, seq, p.in_channels)).astype(np.float32),
        img_ids=np.asarray(make_img_ids(h_latent, w_latent, 1)),
        txt=r.normal(size=(1, txt_len, p.context_in_dim)).astype(np.float32),
        txt_ids=np.asarray(make_txt_ids(txt_len, 1)),
        timesteps=np.full((1,), 0.7, np.float32),
        y=r.normal(size=(1, p.vec_in_dim)).astype(np.float32),
        guidance=np.full((1,), 3.5, np.float32),
    )


def run_jax(params, cfg, x, **kw):
    return jflux.flux_apply(params, cfg, **{k: jnp.asarray(v) for k, v in x.items()}, **kw)


def run_port(model, cfg, x, **kw):
    return tflux.flux_apply(model, cfg, **{k: t(v) for k, v in x.items()}, **kw)


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def test_float_forward_and_amax_tree_match_jax(jax_model, port_cfg):
    cfg, params = jax_model
    x = make_inputs()
    a, amax_a = run_jax(params, cfg, x, collect_amax=True)
    b, amax_b = run_port(to_torch(params), port_cfg, x, collect_amax=True)
    a, b = np.asarray(a), b.numpy()
    assert b.shape == a.shape == (1, 12, TINY_FLUX_PARAMS.in_channels)
    assert _rel(b, a) < 1e-4
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)
    la, lb = amax_leaves(amax_a), amax_leaves(amax_b)
    assert sorted(la) == sorted(lb)
    for key in la:
        assert lb[key].shape == la[key].shape, key
        np.testing.assert_allclose(lb[key], la[key], rtol=1e-4, err_msg=key)
    assert lb["double_blocks.img_attn_qkv"].shape == (TINY_FLUX_PARAMS.depth,)
    assert lb["single_blocks.linear1"].shape == (TINY_FLUX_PARAMS.depth_single_blocks,)


@pytest.fixture(scope="module")
def calibrated(jax_model):
    """fp8 params with JAX-calibrated input scales, and the amaxes they came from."""
    cfg, params = jax_model
    q = jflux.quantize_flux_tree(params)
    _, amaxes = run_jax(q, cfg, make_inputs(1), collect_amax=True)
    return jcal.apply_input_scales(q, amaxes), amaxes


def _block_inputs(cfg, port_cfg, seed=5):
    r = np.random.default_rng(seed)
    hs = TINY_FLUX_PARAMS.hidden_size
    img = r.normal(size=(1, 12, hs)).astype(np.float32)
    txt = r.normal(size=(1, 7, hs)).astype(np.float32)
    vec_silu = r.normal(size=(1, hs)).astype(np.float32)
    x = make_inputs()
    ids = np.concatenate([x["txt_ids"], x["img_ids"]], 1)
    jc, js = jrope.embed_nd_cos_sin(jnp.asarray(ids), cfg.axes_dim, cfg.theta)
    tc, ts = trope.embed_nd_cos_sin(t(ids), port_cfg.axes_dim, port_cfg.theta)
    return img, txt, vec_silu, (jc[:, :, None], js[:, :, None]), (tc[:, :, None], ts[:, :, None])


@pytest.mark.parametrize("i", [0, 1])
def test_fp8_blocks_match_jax(jax_model, port_cfg, calibrated, i):
    """One double and one single block, fp8 with calibrated scales, from the same
    inputs: every fp8 linear sees the same activations up to fp32 order, so the
    e5m2 casts agree and so do the blocks (relative norm 1e-5)."""
    cfg, _ = jax_model
    qa, _ = calibrated
    model = to_torch(qa)
    img, txt, vs, (jc, js), (tc, ts) = _block_inputs(cfg, port_cfg, seed=5 + i)
    jblk = jax.tree.map(lambda v: v[i], qa["double_blocks"])
    ji, jt = jflux._double_block(cfg, jblk, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(vs),
                                 jc, js, jflux._Tape(False))
    ti, tt = tflux._double_block(port_cfg, model["double_blocks"][i], t(img), t(txt), t(vs),
                                 tc, ts, tflux._Tape(False))
    assert _rel(ti.numpy(), np.asarray(ji)) < 1e-5
    assert _rel(tt.numpy(), np.asarray(jt)) < 1e-5
    x = np.concatenate([txt, img], 1)
    jo = jflux._single_block(cfg, jax.tree.map(lambda v: v[i], qa["single_blocks"]),
                             jnp.asarray(x), jnp.asarray(vs), jc, js, jflux._Tape(False))
    to = tflux._single_block(port_cfg, model["single_blocks"][i], t(x), t(vs), tc, ts, tflux._Tape(False))
    assert _rel(to.numpy(), np.asarray(jo)) < 1e-5


def test_fp8_forward_and_calibration_match_jax(jax_model, port_cfg, calibrated):
    """The whole fp8 forward and the amax protocol. These inputs cross no e5m2
    rounding boundary differently on the two sides, so the forward agrees to fp32
    order (relative norm 1e-4). Other inputs can: one crossing in the 1×hidden
    modulation input moves every token's shift and scale, and the output by a few
    percent — which is why the blocks are also held one by one above."""
    cfg, params = jax_model
    qa, amax_a = calibrated
    x = make_inputs(1)
    q = jflux.quantize_flux_tree(params)
    a, amax_j = run_jax(q, cfg, x, collect_amax=True)
    model = to_torch(q)
    b, amax_b = run_port(model, port_cfg, x, collect_amax=True)
    assert _rel(b.numpy(), np.asarray(a)) < 1e-4
    la, lb = amax_leaves(amax_j), amax_leaves(amax_b)
    assert sorted(la) == sorted(lb)
    for key in la:
        assert lb[key].shape == la[key].shape, key
        np.testing.assert_allclose(lb[key], la[key], rtol=1e-4, err_msg=key)

    # the scale write, from the same (JAX's) amaxes, must agree exactly
    conv = lambda d: {k: conv(v) if isinstance(v, dict) else t(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    tcal.apply_input_scales(model, conv(amax_a))
    for name in ("img_attn_qkv", "txt_mlp_2", "img_mod_lin"):
        ja = np.asarray(qa["double_blocks"][name].in_scale)
        tb = torch.stack([blk[name].in_scale for blk in model["double_blocks"]]).numpy()
        np.testing.assert_array_equal(tb, ja, err_msg=name)
    ja = np.asarray(qa["single_blocks"]["linear2"].in_scale_inv)
    tb = torch.stack([blk["linear2"].in_scale_inv for blk in model["single_blocks"]]).numpy()
    np.testing.assert_array_equal(tb, ja)
    assert model["img_in"].kind == "float" and model["final_layer"]["linear"].kind == "float"
    a2, b2 = np.asarray(run_jax(qa, cfg, x)), run_port(model, port_cfg, x).numpy()
    assert _rel(b2, a2) < 1e-4


def test_port_quantizer_gives_jax_bytes(jax_model):
    _, params = jax_model
    q_jax = to_torch(jflux.quantize_flux_tree(params))
    q_port = tflux.quantize_flux_tree(to_torch(params))
    names = [n for n, m in q_port.named_modules() if isinstance(m, Linear)]
    assert names
    mods_j = dict(q_jax.named_modules())
    for name, m in q_port.named_modules():
        if not isinstance(m, Linear):
            continue
        j = mods_j[name]
        assert m.kind == j.kind, name
        if m.kind == "fp8":
            assert torch.equal(m.q.view(torch.uint8), j.q.view(torch.uint8)), name
            assert torch.equal(m.w_scale, j.w_scale), name


@pytest.mark.parametrize("modulation,embedders", [(True, False), (False, False), (True, True)])
def test_tier_rules_match_jax(jax_model, modulation, embedders):
    _, params = jax_model
    qj = jflux.quantize_flux_tree(params, modulation, embedders)
    model = tflux.quantize_flux_tree(to_torch(params), modulation, embedders)
    assert model["double_blocks"][0]["img_mod_lin"].kind == qj["double_blocks"]["img_mod_lin"].kind
    assert model["single_blocks"][1]["mod_lin"].kind == qj["single_blocks"]["mod_lin"].kind
    assert model["time_in"]["in_layer"].kind == qj["time_in"]["in_layer"].kind
    assert model["img_in"].kind == qj["img_in"].kind
    assert model["final_layer"]["linear"].kind == "float" == qj["final_layer"]["linear"].kind
    assert model["single_blocks"][0]["linear1"].kind == "fp8"


def test_max_logit_bound_matches_jax(jax_model, port_cfg):
    cfg, params = jax_model
    params = dict(params)
    sb = dict(params["single_blocks"])
    sb["knorm"] = sb["knorm"] * 3.0
    params["single_blocks"] = sb
    a = jflux.max_logit_bound(params, cfg)
    b = tflux.max_logit_bound(to_torch(params), port_cfg)
    assert b == pytest.approx(a, rel=1e-6)


def test_merge_amax_matches_jax():
    r = np.random.default_rng(3)
    tree = lambda: {"img_in": r.random(), "double_blocks": {"img_attn_qkv": r.random(2)}}  # noqa: E731
    x, y = tree(), tree()
    a = jcal.merge_amax(jax.tree.map(jnp.float32, x), jax.tree.map(jnp.float32, y))
    conv = lambda d: {k: conv(v) if isinstance(v, dict) else t(np.float32(v) if np.ndim(v) == 0 else v) for k, v in d.items()}  # noqa: E731
    b = tcal.merge_amax(conv(x), conv(y))
    for k, v in amax_leaves(a).items():
        np.testing.assert_array_equal(amax_leaves(b)[k], v)
    assert tcal.merge_amax(None, b) is b


def test_random_init_builds_leaf_by_leaf(port_cfg):
    seen = []

    def leaf(path, lin):
        seen.append(path)
        return tflux.quant_tier()(path, lin)

    gen = torch.Generator().manual_seed(0)
    model = tflux.init_flux_params(port_cfg, gen, torch.bfloat16, leaf)
    p = TINY_FLUX_PARAMS
    # every Linear passed through the leaf transform once, in build order
    assert len(seen) == 2 + 3 * 2 + 10 * p.depth + 3 * p.depth_single_blocks + 2
    assert seen[0] == ("img_in",) and seen[-1] == ("final_layer", "adaln")
    assert len(model["double_blocks"]) == p.depth
    assert model["single_blocks"][0]["linear1"].q.shape == (3 * p.hidden_size + 4 * p.hidden_size, p.hidden_size)
    assert model["single_blocks"][0]["linear1"].q.dtype == torch.float8_e4m3fn
    again = tflux.init_flux_params(port_cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    assert torch.equal(again["txt_in"].weight, model["txt_in"].weight)
    out = run_port(model, tflux.FluxStatic.from_params(p), make_inputs(2))
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
