"""The rope pass in front of the attention kernel, and the TMA parameters the kernel's
tensor maps are built from, on the CPU.

On the card ``qknorm_attention`` rotates q and k once per call (``rope_rotate``, a
kernel of its own) and hands the rotated copies to an attention kernel that has no
rope; the Pallas kernel rotates each tile inside. These tests hold the split against
the fused function: the plain rope followed by the plain attention without tables is
the plain attention with tables, bit for bit (same roundings, in the same order), and
both agree with the JAX Pallas kernel in interpret mode with its rope fused, at
test_torch_attention.py's tolerance (rtol 1e-4, atol 1e-4: fp32 summation order and
the odd p rounded to the neighbouring bf16 value). The rope itself is one fp32
product per term and one sum, rounded to bf16 once, the expression of the Pallas
kernel's ``_rope_rotate``: equal to it bit for bit.

``tma_params`` is checked on the views the model really hands the kernel (the double
block's ``torch.cat`` outputs, the single block's slice of linear1's output, and the
B = 2 fold), captured from a forward at head dim 128 and two heads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu.ops.attention_kernel import _rope_rotate as jax_rope_rotate
from flux_fp8_api_tpu.ops.attention_kernel import qknorm_attention as jax_kernel
from flux_fp8_api_tpu_torch.models.flux import FluxStatic, flux_apply, init_flux_params
from flux_fp8_api_tpu_torch.ops import attention as tattn
from flux_fp8_api_tpu_torch.ops.attention_kernel import (
    BLOCKS,
    BOX_COLS,
    LAUNCHES,
    qknorm_attention,
    qknorm_attention_ref,
    rope_rotate,
    rope_rotate_ref,
    tma_params,
)
from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
from flux_fp8_api_tpu_torch.utils.config import FluxParams

from .test_torch_attention import _normed, _tables
from .torch_parity import t

torch.set_num_threads(1)

# (heads, lq, lkv, d): square, a ragged length, and q shards shorter than the sequence
SHAPES = [(2, 256, 256, 32), (2, 200, 200, 32), (3, 64, 200, 32), (1, 136, 300, 128)]


def _rope_case(h, lq, lkv, d, dtype=torch.float32):
    """qk-normed q/k, randn v and tables (the last lq positions for q), as tensors."""
    r = np.random.default_rng(lq * lkv + d)
    q, k = _normed(r, (h, lq, d)), _normed(r, (h, lkv, d))
    v = r.normal(size=(h, lkv, d)).astype(np.float32)
    cos, sin = _tables(lkv, d)
    tables = dict(cos=t(cos), sin=t(sin), cos_q=t(cos[-lq:].copy()), sin_q=t(sin[-lq:].copy()))
    return t(q, dtype), t(k, dtype), t(v, dtype), tables


@pytest.mark.parametrize("h,lq,lkv,d", SHAPES)
@pytest.mark.parametrize("build", ["serving", "stats", "ablate_exp"])
def test_rope_then_attention_is_fused_attention_bit_for_bit(h, lq, lkv, d, build):
    """Every build: rope_rotate_ref, then the plain attention without tables, equals the
    plain attention with tables exactly (output, and the stats build's max)."""
    q, k, v, tb = _rope_case(h, lq, lkv, d)
    kw = {"stats": dict(return_max_logit=True), "ablate_exp": dict(ablate_exp=True)}.get(build, {})
    fused = qknorm_attention_ref(q, k, v, d**-0.5, **tb, **kw)
    qr = rope_rotate_ref(q, tb["cos_q"], tb["sin_q"])
    kr = rope_rotate_ref(k, tb["cos"], tb["sin"])
    split = qknorm_attention_ref(qr, kr, v, d**-0.5, **kw)
    for a, b in zip(fused if build == "stats" else [fused], split if build == "stats" else [split]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,lq,lkv,d", SHAPES)
def test_rope_pass_wrapper_on_cpu_is_the_plain_version(h, lq, lkv, d):
    """rope_rotate on CPU tensors is rope_rotate_ref for q (cos_q/sin_q) and k
    (cos/sin), launches nothing, and defaults cos_q/sin_q to cos/sin."""
    q, k, _, tb = _rope_case(h, lq, lkv, d, torch.bfloat16)
    before = dict(LAUNCHES)
    qr, kr = rope_rotate(q, k, **tb)
    assert LAUNCHES == before
    assert torch.equal(qr, rope_rotate_ref(q, tb["cos_q"], tb["sin_q"]))
    assert torch.equal(kr, rope_rotate_ref(k, tb["cos"], tb["sin"]))
    assert qr.dtype == kr.dtype == torch.bfloat16
    if lq == lkv:
        qd, _ = rope_rotate(q, k, tb["cos"], tb["sin"])
        assert torch.equal(qd, rope_rotate_ref(q, tb["cos"], tb["sin"]))


@pytest.mark.parametrize("h,lq,lkv,d", SHAPES)
def test_rotated_attention_matches_pallas_kernel_with_fused_rope(h, lq, lkv, d):
    """The split (rope pass, then the attention with no tables) against the Pallas
    kernel rotating inside, interpret mode."""
    q, k, v, tb = _rope_case(h, lq, lkv, d)
    bq = 64 if lq < 128 else 128
    a = jax_kernel(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), d**-0.5,
                   block_q=bq, block_kv=128, interpret=True, **{n: jnp.asarray(x.numpy()) for n, x in tb.items()})
    qr, kr = rope_rotate(q, k, **tb)
    b = qknorm_attention(qr, kr, v, d**-0.5)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_rotate_ref_is_the_pallas_kernels_rotation(dtype):
    """bf16 (the kernel's feed) and fp32 tiles, against the Pallas kernel's own
    ``_rope_rotate`` on a (1, L, D) block: equal bit for bit."""
    r = np.random.default_rng(2)
    l, d = 96, 128
    x = t(_normed(r, (1, l, d)), dtype)
    cos, sin = _tables(l, d)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_rope_rotate(jnp.asarray(x.float().numpy(), jdtype), jnp.asarray(cos), jnp.asarray(sin), jdtype)
    got = rope_rotate_ref(x[0], t(cos), t(sin))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# ------------------------------------------------------------------- TMA parameters

def _model_views(batch, monkeypatch):
    """(q, k, v) of every attention call of a forward at head dim 128 (two heads,
    one double and one single block), as attention_core folds them."""
    params = FluxParams(in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=256,
                        mlp_ratio=4.0, num_heads=2, depth=1, depth_single_blocks=1,
                        axes_dim=[16, 56, 56], theta=10_000, qkv_bias=True, guidance_embed=True)
    cfg = FluxStatic.from_params(params)
    model = init_flux_params(cfg, torch.Generator().manual_seed(0), torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    seen = []

    def record(q, k, v, *args, **kw):
        seen.append((q, k, v))
        return qknorm_attention(q, k, v, *args, **kw)

    x = dict(img=torch.randn(batch, 12, 16, generator=g), img_ids=make_img_ids(8, 6, batch),
             txt=torch.randn(batch, 7, 48, generator=g), txt_ids=make_txt_ids(7, batch),
             timesteps=torch.full((batch,), 0.5), y=torch.randn(batch, 32, generator=g),
             guidance=torch.full((batch,), 3.5))
    monkeypatch.setattr(tattn, "qknorm_attention", record)
    flux_apply(model, cfg, **x)
    return seen


@pytest.mark.parametrize("batch", [1, 2])
def test_tma_params_of_the_models_views(batch, monkeypatch):
    """Every q/k/v the model hands the kernel maps: dims (128, L, B·N), byte strides of
    the view itself (16-byte multiples), a box of 64 columns × 128 rows × 1 head whose
    128-byte rows are what the 128-byte swizzle spans. At B = 1 the views are read in
    place: the double block's cat outputs (row stride N·D) and the single block's
    slice of linear1 (row stride 7·N·D, 3·N·D of qkv and 4·N·D of mlp)."""
    views = _model_views(batch, monkeypatch)
    assert len(views) == 2  # one double, one single block
    row_strides = set()
    for q, k, v in views:
        for x in (q, k, v):
            p = tma_params(x)
            h, l, d = x.shape
            assert p[:3] == (d, l, h) == (128, 19, 2 * batch)
            assert p[3] == x.stride(1) * 2 and p[4] == x.stride(0) * 2
            assert p[3] % 16 == 0 and p[4] % 16 == 0
            assert p[5:] == (BOX_COLS, BLOCKS[1], 1) and BOX_COLS * x.element_size() == 128
            row_strides.add(p[3])
    if batch == 1:  # views of the activations, no copy
        assert row_strides == {2 * 256, 2 * 7 * 256}
    else:  # the fold copies: packed (B·N, L, D)
        assert row_strides == {256}


def test_tma_params_of_packed_and_strided_tensors():
    x = torch.zeros(24, 3392, 128, dtype=torch.bfloat16)
    assert tma_params(x) == (128, 3392, 24, 256, 3392 * 256, 64, 128, 1)
    # the single block's view at flux-dev width: row stride 21504 elements
    lin1 = torch.zeros(1, 40, 21504, dtype=torch.bfloat16)
    q = tattn.fold_heads(lin1[..., : 3 * 3072].unflatten(-1, (3, 24, 128))[:, :, 0])
    assert tma_params(q) == (128, 40, 24, 43008, 256, 64, 128, 1)
    # an axis of size 1 is never stepped over: its stride is given as the packed one
    assert tma_params(torch.zeros(1, 1, 128, dtype=torch.bfloat16)[:, :, :]) == (128, 1, 1, 256, 256, 64, 128, 1)


@pytest.mark.parametrize("case", ["float32", "head_dim_64", "last_dim_strided", "base_unaligned",
                                  "row_stride_unaligned", "head_stride_unaligned", "empty"])
def test_tma_params_reject_what_tma_cannot_take(case):
    buf = torch.zeros(4 * 64 * 136 + 8, dtype=torch.bfloat16)
    x = {
        "float32": lambda: torch.zeros(2, 64, 128),
        "head_dim_64": lambda: torch.zeros(2, 64, 64, dtype=torch.bfloat16),
        "last_dim_strided": lambda: torch.zeros(2, 64, 256, dtype=torch.bfloat16)[..., ::2],
        "base_unaligned": lambda: buf[1: 1 + 2 * 64 * 128].view(2, 64, 128),
        "row_stride_unaligned": lambda: buf[: 2 * 64 * 132].view(2, 64, 132)[..., :128],
        "head_stride_unaligned": lambda: buf.as_strided((2, 64, 128), (64 * 128 + 4, 128, 1)),
        "empty": lambda: torch.zeros(2, 0, 128, dtype=torch.bfloat16),
    }[case]()
    with pytest.raises(ValueError):
        tma_params(x)


@pytest.mark.parametrize("case", ["short_table", "float64_table", "strided_table", "float32_q"])
def test_rope_pass_rejects_what_its_kernel_cannot_take(case):
    """CUDA-only checks, reached on the CPU through a tensor that claims CUDA."""

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    cos = sin = torch.zeros(8, 128)
    if case == "short_table":
        cos = torch.zeros(4, 128)
    elif case == "float64_table":
        cos = torch.zeros(8, 128, dtype=torch.float64)
    elif case == "strided_table":
        cos = torch.zeros(8, 256)[:, ::2]
    else:
        q = q.float()
    q = q.as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="float32 table" if case != "float32_q" else "bfloat16"):
        rope_rotate(q, q, cos, sin)
