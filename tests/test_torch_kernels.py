"""The port's CUDA kernels and fp8 linear on the card, against their plain PyTorch
versions. Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Tolerances: the kernel and its plain version round p to bf16 the same way; the rest is
fp32 summation order and the final bf16 rounding of the output (2^-8 relative), so
|kernel − plain| ≤ 1e-3 + 1e-2·|plain|. The stats build's output is the serving
build's, bit for bit, and its max |logit| is the plain version's to 1e-3 relative (the
logits differ by summation order). The ablate build's output is acc·1e30 (den < 0 is
clamped) with elements near 0 wherever Σ p·v cancels, so it is compared relative in
norm, in fp64, to 1e-2. The bare two-dot (a build of the same body): bf16 logits and
output on both sides, so max|kernel − plain| ≤ 1e-2·max|plain|. The fp8 GEMM: fast accumulation and the bf16
output each cost about 2^-8, so max|out − plain| ≤ 2e-2·max|plain|. The int linears:
the int32 product equals the exact one (fp64, |sum| < 2^53), and the bf16 output is
the plain epilogue's to one bf16 rounding, |out − plain| ≤ 2^-8·|plain| + 1e-6.
"""

import pytest
import torch

from flux_fp8_api_tpu_torch.ablate_attention import bare_two_dot, bare_two_dot_ref
from flux_fp8_api_tpu_torch.ops.attention import attention_core, benchmark_blocks
from flux_fp8_api_tpu_torch.ops.attention_kernel import (
    LAUNCHES,
    MAX_SAFE_LOGIT,
    TILE_LAUNCHES,
    TILES,
    qknorm_attention,
    qknorm_attention_checked,
    qknorm_attention_ref,
    rope_rotate,
    rope_rotate_ref,
)
from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
from flux_fp8_api_tpu_torch.ops.quant import (
    F8_INPUT_MAX,
    FLOW_QUANTIZERS,
    INPUT_F8_DTYPE,
    _unpack_int4,
    fp8_linear_ref,
    int_mm,
    linear_apply,
    quantize_activation_int8,
    quantize_linear_fp8,
    to_fp8_saturated,
    with_input_scale,
)
from flux_fp8_api_tpu_torch.ops.rope import embed_nd_cos_sin

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _normed(gen, *shape):
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)


def _tables(dev, h_latent, w_latent, txt=512):
    ids = torch.cat([make_txt_ids(txt, 1, dev), make_img_ids(h_latent, w_latent, 1, dev)], 1)
    cos, sin = embed_nd_cos_sin(ids, (16, 56, 56), 10_000)
    return cos[0].contiguous(), sin[0].contiguous()


@pytest.mark.parametrize("h_latent,w_latent,rope,lq", [
    (128, 128, True, None),   # 1024², L = 4608
    (90, 128, True, None),    # 720×1024, L = 3392: tail-masked kv tile
    (64, 64, False, None),    # 512², L = 1536, no rope
    (128, 128, True, 1536),   # a q shard against the full sequence
])
def test_kernel_matches_plain_version(dev, h_latent, w_latent, rope, lq):
    gen = torch.Generator(device=dev).manual_seed(h_latent * w_latent)
    l = 512 + (h_latent // 2) * (w_latent // 2)
    h, d = 24, 128
    q, k = _normed(gen, h, l, d), _normed(gen, h, l, d)
    v = torch.randn(h, l, d, generator=gen, device=dev).to(torch.bfloat16)
    kw = {}
    if rope:
        cos, sin = _tables(dev, h_latent, w_latent)
        kw = dict(cos=cos, sin=sin)
        if lq:
            kw.update(cos_q=cos[:lq].contiguous(), sin_q=sin[:lq].contiguous())
    if lq:
        q = q[:, :lq]
    before = dict(LAUNCHES)
    out = qknorm_attention(q, k, v, d**-0.5, **kw)
    assert _launched(before) == {"qknorm_attention": 1, **({"rope_rotate": 1} if rope else {})}
    ref = qknorm_attention_ref(q, k, v, d**-0.5, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("heads,h_latent,w_latent,sp", [
    (12, 128, 128, 1),  # tp 2 at 1024²
    (6, 128, 128, 1),   # tp 4: six heads fill half of the rope pass's second group of four
    (24, 128, 128, 2),  # sp 2 at 1024²: Lq = 2304 against Lkv = 4608
    (24, 90, 128, 2),   # sp 2 at 720×1024: Lq = 1696, not a multiple of K1's 128-row tile
    (24, 64, 64, 2),    # sp 2 at 512²: Lq = 768 against Lkv = 1536
    (12, 90, 128, 2),   # tp 2 × sp 2
])
def test_kernels_at_the_meshs_local_shapes(dev, heads, h_latent, w_latent, sp):
    """What a mesh rank runs (parallel/mesh.py): its heads, and under sp the second
    rank's q rows with their rows of the q tables against the whole k and v. The rope
    pass is its plain version bit for bit, K1 within its tolerance."""
    l = _l(h_latent, w_latent)
    lq = l // sp
    gen = torch.Generator(device=dev).manual_seed(heads * l)
    q, k = _normed(gen, heads, l, 128), _normed(gen, heads, l, 128)
    v = torch.randn(heads, l, 128, generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = _tables(dev, h_latent, w_latent)
    rows = slice(l - lq, l)  # the last rank's rows
    q, cos_q, sin_q = q[:, rows], cos[rows].contiguous(), sin[rows].contiguous()
    before = dict(LAUNCHES)
    qr, kr = rope_rotate(q, k, cos, sin, cos_q, sin_q)
    out = qknorm_attention(q, k, v, 128**-0.5, cos=cos, sin=sin, cos_q=cos_q, sin_q=sin_q)
    assert _launched(before) == {"rope_rotate": 2, "qknorm_attention": 1}
    assert torch.equal(qr, rope_rotate_ref(q, cos_q, sin_q)) and torch.equal(kr, rope_rotate_ref(k, cos, sin))
    ref = qknorm_attention_ref(q, k, v, 128**-0.5, cos, sin, cos_q, sin_q)
    assert out.shape == (heads, lq, 128)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


def _l(h_latent, w_latent, txt=512):
    """The joint sequence of an image of h_latent × w_latent latents and 512 text tokens."""
    return txt + (h_latent // 2) * (w_latent // 2)


@pytest.mark.parametrize("h_latent,w_latent,lq", [(128, 128, None), (90, 128, None), (128, 128, 1536)])
def test_rope_pass_is_its_plain_version_bit_for_bit(dev, h_latent, w_latent, lq):
    """The rope pass on strided q/k views (a row stride of 3·24·128, as a packed qkv
    gives) equals rope_rotate_ref exactly, into contiguous outputs."""
    l = _l(h_latent, w_latent)
    gen = torch.Generator(device=dev).manual_seed(l + (lq or 0))
    qkv = _normed(gen, l, 3, 24, 128).permute(1, 2, 0, 3)  # (3, H, L, D) view
    q, k = qkv[0], qkv[1]
    cos, sin = _tables(dev, h_latent, w_latent)
    cos_q, sin_q = cos, sin
    if lq:
        q, cos_q, sin_q = q[:, :lq], cos[:lq].contiguous(), sin[:lq].contiguous()
    before = dict(LAUNCHES)
    qr, kr = rope_rotate(q, k, cos, sin, cos_q, sin_q)
    assert _launched(before) == {"rope_rotate": 1}
    assert qr.is_contiguous() and kr.is_contiguous()
    assert torch.equal(qr, rope_rotate_ref(q, cos_q, sin_q))
    assert torch.equal(kr, rope_rotate_ref(k, cos, sin))


@pytest.mark.parametrize("l", [200, 3392])
def test_all_underflow_rows_are_zero(dev, l):
    q = torch.ones(2, l, 128, device=dev, dtype=torch.bfloat16)
    k = torch.full((2, l, 128), -90.0 / 128, device=dev, dtype=torch.bfloat16)
    out = qknorm_attention(q, k, q, 1.0)
    assert torch.equal(out.float(), torch.zeros_like(out, dtype=torch.float32))


def test_rows_past_the_sequence_are_never_read(dev):
    """A 3-D tensor map zero-fills the rows past Lkv, and p is masked there: an inf
    just past the end of v (the next head's rows, were the map flat) cannot reach the
    output."""
    gen = torch.Generator(device=dev).manual_seed(9)
    h, l = 4, 1000
    buf = torch.randn(h * l + 128, 128, generator=gen, device=dev).to(torch.bfloat16)
    buf[h * l:] = float("inf")
    v = buf[: h * l].view(h, l, 128)
    q, k = _normed(gen, h, l, 128), _normed(gen, h, l, 128)
    out = qknorm_attention(q, k, v, 128**-0.5)
    assert bool(torch.isfinite(out.float()).all())
    ref = qknorm_attention_ref(q, k, v, 128**-0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("block", ["double", "single"])
def test_kernel_on_the_blocks_strided_views(dev, block):
    """The views models/flux.py hands attention_core at B = 1: the double block's
    torch.cat outputs, and the single block's q/k/v sliced out of linear1's output
    (row stride 3·3072 + 12288 = 21504 elements), read in place by the tensor maps."""
    gen = torch.Generator(device=dev).manual_seed(11)
    l, n, d = _l(64, 64), 24, 128
    if block == "double":
        txt, img = _normed(gen, 1, 512, 3, n, d), _normed(gen, 1, l - 512, 3, n, d)
        q, k, v = (torch.cat([txt[:, :, i], img[:, :, i]], dim=1) for i in range(3))
    else:
        lin1 = _normed(gen, 1, l, 7 * n * d)
        q, k, v = lin1[..., : 3 * n * d].unflatten(-1, (3, n, d)).unbind(2)
        assert q.stride(1) == 21504
    cos, sin = _tables(dev, 64, 64)
    out = attention_core(q, k, v, cos=cos, sin=sin)
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(n, l, d)  # noqa: E731
    ref = qknorm_attention_ref(fold(q), fold(k), fold(v), d**-0.5, cos=cos, sin=sin)
    torch.testing.assert_close(out.float(), ref.reshape(1, n, l, d).permute(0, 2, 1, 3).float(),
                               atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("batch", [1, 2])
def test_attention_core_on_strided_views(dev, batch):
    """attention_core hands the kernel head-folded views of (B, L, N, D) tensors
    (B = 1) or copies (B = 2); both must match the plain version."""
    gen = torch.Generator(device=dev).manual_seed(batch)
    l, n, d = 1536, 24, 128
    qkv = _normed(gen, batch, l, 3, n, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cos, sin = _tables(dev, 64, 64)
    out = attention_core(q, k, v, cos=cos, sin=sin)
    fold = lambda x: x.permute(0, 2, 1, 3).reshape(batch * n, l, d)  # noqa: E731
    ref = qknorm_attention_ref(fold(q), fold(k), fold(v), d**-0.5, cos=cos, sin=sin)
    ref = ref.reshape(batch, n, l, d).permute(0, 2, 1, 3)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


def test_wrapper_raises_on_what_the_kernel_cannot_take(dev):
    x = torch.zeros(2, 64, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        qknorm_attention(x, x, x, 0.1)
    y = torch.zeros(2, 64, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128"):
        qknorm_attention(y, y, y, 0.1)


def _launched(before):
    """{build: launches since ``before``} for the builds that launched."""
    return {k: n - before[k] for k, n in LAUNCHES.items() if n != before[k]}


@pytest.mark.parametrize("l,rope", [(4608, True), (3392, True), (1536, True), (1000, False)])  # 1000: a tail kv tile
def test_stats_build_matches_serving_build_and_plain_version(dev, l, rope):
    gen = torch.Generator(device=dev).manual_seed(l)
    q, k = _normed(gen, 24, l, 128), _normed(gen, 24, l, 128)
    v = torch.randn(24, l, 128, generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = _tables(dev, 128, 128)
    kw = dict(cos=cos[:l].contiguous(), sin=sin[:l].contiguous()) if rope else {}
    before = dict(LAUNCHES)
    out, m = qknorm_attention(q, k, v, 128**-0.5, return_max_logit=True, **kw)
    assert _launched(before) == {"qknorm_attention_stats": 1, **({"rope_rotate": 1} if rope else {})}
    assert m.shape == () and m.dtype == torch.float32 and m.is_cuda
    assert torch.equal(out, qknorm_attention(q, k, v, 128**-0.5, **kw))
    ref, ref_m = qknorm_attention_ref(q, k, v, 128**-0.5, return_max_logit=True, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    assert abs(float(m) - float(ref_m)) <= 1e-3 * float(ref_m)


def test_guard_rail_on_the_card(dev):
    """qk-normed inputs pass; ×60 inputs and a NaN logit raise (a max built on fmaxf
    would drop the NaN)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k = _normed(gen, 24, 1536, 128), _normed(gen, 24, 1536, 128)
    v = torch.randn(24, 1536, 128, generator=gen, device=dev).to(torch.bfloat16)
    out = qknorm_attention_checked(q, k, v, 128**-0.5)
    assert bool(torch.isfinite(out.float()).all())
    with pytest.raises(FloatingPointError, match="safe bound"):
        qknorm_attention_checked(q * 60, k * 60, v, 128**-0.5)
    q_nan = q.clone()
    q_nan[3, 700, 5] = float("nan")
    _, m = qknorm_attention(q_nan, k, v, 128**-0.5, return_max_logit=True)
    assert bool(torch.isnan(m))
    with pytest.raises(FloatingPointError, match="safe bound"):
        qknorm_attention_checked(q_nan, k, v, 128**-0.5)
    _, m = qknorm_attention(q * 60, k * 60, v, 128**-0.5, return_max_logit=True)
    assert float(m) > MAX_SAFE_LOGIT


@pytest.mark.parametrize("l,rope", [(4608, True), (1000, False)])
def test_ablate_build_matches_plain_version(dev, l, rope):
    gen = torch.Generator(device=dev).manual_seed(l + 1)
    q, k = _normed(gen, 24, l, 128), _normed(gen, 24, l, 128)
    v = torch.randn(24, l, 128, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(zip(("cos", "sin"), _tables(dev, 128, 128))) if rope else {}
    before = dict(LAUNCHES)
    out = qknorm_attention(q, k, v, 128**-0.5, ablate_exp=True, **kw)
    assert _launched(before) == {"qknorm_attention_ablate_exp": 1, **({"rope_rotate": 1} if rope else {})}
    ref = qknorm_attention_ref(q, k, v, 128**-0.5, ablate_exp=True, **kw)
    o, r = out.double(), ref.double()
    assert bool(torch.isfinite(o).all())
    assert float((o - r).norm() / r.norm()) <= 1e-2


@pytest.mark.parametrize("lq,lkv", [(4608, 4608), (3392, 3392), (1536, 4608), (3392, 1536)])  # 3392: half tiles
def test_bare_two_dot_matches_plain_version(dev, lq, lkv):
    gen = torch.Generator(device=dev).manual_seed(lq + lkv)
    q = torch.randn(24, lq, 128, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(24, lkv, 128, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    before = dict(LAUNCHES)
    out = bare_two_dot(q, k, v)
    assert _launched(before) == {"bare_two_dot": 1}
    ref = bare_two_dot_ref(q, k, v).float()
    assert float((out.float() - ref).abs().max()) <= 1e-2 * float(ref.abs().max())
    with pytest.raises(ValueError, match="multiples"):
        bare_two_dot(q[:, :1000], k, v)


@pytest.mark.parametrize("tile", [t[:2] for t in TILES])
@pytest.mark.parametrize("heads,lq,lkv", [(24, 1536, 1536), (6, 3392, 3392), (24, 1000, 1000), (24, 1536, 4608)])
def test_every_build_at_every_tile_matches_plain_and_the_default_tile(dev, tile, heads, lq, lkv):
    """Each build at each compiled tile: within its plain version's tolerance, and bit
    for bit the default tile's output (a row's sums run in one order at every tile).
    L = 3392 and 1000 leave a tail kv tile at 128 rows (1000 at 64 too); 1000 is no
    multiple of 64, so it has no bare build."""
    gen = torch.Generator(device=dev).manual_seed(lq * 7 + lkv + heads)
    q, k = _normed(gen, heads, lq, 128), _normed(gen, heads, lkv, 128)
    v = torch.randn(heads, lkv, 128, generator=gen, device=dev).to(torch.bfloat16)
    scale = 128**-0.5
    before, tiles_before = dict(LAUNCHES), dict(TILE_LAUNCHES)
    out = qknorm_attention(q, k, v, scale, blocks=tile)
    so, m = qknorm_attention(q, k, v, scale, return_max_logit=True, blocks=tile)
    ao = qknorm_attention(q, k, v, scale, ablate_exp=True, blocks=tile)
    bare = lq % 64 == 0 and lkv % 64 == 0
    bo = bare_two_dot(q, k, v, tile) if bare else None
    builds = ["qknorm_attention", "qknorm_attention_stats", "qknorm_attention_ablate_exp"] + ["bare_two_dot"] * bare
    assert _launched(before) == {b: 1 for b in builds}
    assert {key: n - tiles_before[key] for key, n in TILE_LAUNCHES.items() if n != tiles_before[key]} == {
        (b, tuple(tile)): 1 for b in builds}
    ref = qknorm_attention_ref(q, k, v, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)
    _, ref_m = qknorm_attention_ref(q, k, v, scale, return_max_logit=True)
    assert torch.equal(so, out) and abs(float(m) - float(ref_m)) <= 1e-3 * float(ref_m)
    ra = qknorm_attention_ref(q, k, v, scale, ablate_exp=True).double()
    assert float((ao.double() - ra).norm() / ra.norm()) <= 1e-2
    default = [qknorm_attention(q, k, v, scale), qknorm_attention(q, k, v, scale, return_max_logit=True)[1],
               qknorm_attention(q, k, v, scale, ablate_exp=True)]
    assert torch.equal(out, default[0]) and float(m) == float(default[1]) and torch.equal(ao, default[2])
    if bare:
        rb = bare_two_dot_ref(q, k, v).float()
        assert float((bo.float() - rb).abs().max()) <= 1e-2 * float(rb.abs().max())
        assert torch.equal(bo, bare_two_dot(q, k, v))


def test_the_default_tile_is_the_single_tile_kernel_bit_for_bit(dev):
    """(128, 128) on chip_smoke's tile-phase inputs at L = 1536 and tp 4's local shape:
    the digests of the single-tile kernel the tiles were templated from."""
    from chip_smoke import SINGLE_TILE_OUTPUTS, TILE_SHAPES, output_digest, tile_inputs

    scale = 128**-0.5
    for index, (shape, heads, lq, lkv) in enumerate(TILE_SHAPES):
        if shape not in ("L=1536", "tp4 L=3392"):
            continue
        q, k, v = tile_inputs(heads, lq, lkv, index)
        _, m = qknorm_attention(q, k, v, scale, return_max_logit=True)
        got = (output_digest(qknorm_attention(q, k, v, scale)), float(m),
               output_digest(qknorm_attention(q, k, v, scale, ablate_exp=True)), output_digest(bare_two_dot(q, k, v)))
        assert got == SINGLE_TILE_OUTPUTS[shape], shape


@pytest.mark.parametrize("batch", [1, 2])
def test_attention_core_without_pallas(dev, batch):
    """use_pallas=False on the card: the rope pass (one launch), then
    F.scaled_dot_product_attention, and no build of the attention kernel. It matches
    the same call on the CPU (the rope pass's plain version, then the math backend)
    on the same inputs to 1e-2 relative in norm: the backends differ in bf16 rounding
    and summation order."""
    gen = torch.Generator(device=dev).manual_seed(20 + batch)
    l, n, d = 1536, 24, 128
    qkv = _normed(gen, batch, l, 3, n, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    cos, sin = _tables(dev, 64, 64)
    before = dict(LAUNCHES)
    out = attention_core(q, k, v, cos=cos, sin=sin, use_pallas=False)
    torch.cuda.synchronize()
    assert _launched(before) == {"rope_rotate": 1}
    assert out.shape == (batch, l, n, d) and out.dtype == torch.bfloat16
    ref = attention_core(q.cpu(), k.cpu(), v.cpu(), cos=cos.cpu(), sin=sin.cpu(), use_pallas=False)
    o, r = out.float().cpu(), ref.float()
    assert bool(torch.isfinite(o).all())
    assert float((o - r).norm() / r.norm()) <= 1e-2


def test_benchmark_blocks_launches_what_it_times(dev):
    before = dict(LAUNCHES)
    seconds = benchmark_blocks(1536, iters=3, ablate_exp=True)
    assert seconds > 0
    assert _launched(before) == {"qknorm_attention_ablate_exp": 4, "rope_rotate": 4}  # one warm + 3 timed


@pytest.mark.parametrize("tile", [t[:2] for t in TILES])
def test_benchmark_blocks_times_the_tile_it_is_given(dev, tile):
    before = dict(TILE_LAUNCHES)
    assert benchmark_blocks(1536, tile, folded_heads=6, iters=2) > 0
    assert {key: n - before[key] for key, n in TILE_LAUNCHES.items() if n != before[key]} == {
        ("qknorm_attention", tuple(tile)): 3}


@pytest.mark.parametrize("m,k,n", [(4608, 3072, 9216), (1, 3072, 18432), (512, 15360, 3072)])
@pytest.mark.parametrize("fast", [True, False])
def test_fp8_linear_matches_plain_version(dev, m, k, n, fast):
    gen = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(1, m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = ((torch.rand(n, k, generator=gen, device=dev) * 2 - 1) * (3 / k) ** 0.5).to(torch.bfloat16)
    b = ((torch.rand(n, generator=gen, device=dev) * 2 - 1) / k**0.5).to(torch.bfloat16)
    lin = with_input_scale(quantize_linear_fp8(w, b), x.abs().max().float())
    out, amax = linear_apply(lin, x, torch.bfloat16, collect_amax=True, fast_accum=fast)
    x8 = to_fp8_saturated(x.float(), lin.in_scale, F8_INPUT_MAX).to(INPUT_F8_DTYPE)
    ref = fp8_linear_ref(lin, x8, torch.float32)
    assert out.shape == (1, m, n) and out.dtype == torch.bfloat16
    assert float((out.float() - ref).abs().max() / ref.abs().max()) <= 2e-2
    assert float(amax) == float(x.abs().max())


@pytest.mark.parametrize("m", [1, 17, 4608])
@pytest.mark.parametrize("kind,n,k", [("int8", 9216, 3072), ("int4", 9216, 3072), ("int8", 3072, 15360)])
def test_int_linear_matches_exact_product(dev, kind, n, k, m):
    """torch._int_mm refuses M <= 16 rows on the card; int_mm pads them. The product
    must be exact at every M, and the linear its plain epilogue."""
    gen = torch.Generator(device=dev).manual_seed(m + n)
    x = torch.randn(1, m, k, generator=gen, device=dev).to(torch.bfloat16)
    w = ((torch.rand(n, k, generator=gen, device=dev) * 2 - 1) * (3 / k) ** 0.5).to(torch.bfloat16)
    b = ((torch.rand(n, generator=gen, device=dev) * 2 - 1) / k**0.5).to(torch.bfloat16)
    lin = with_input_scale(FLOW_QUANTIZERS[kind](w, b), x.abs().max().float())
    x8 = quantize_activation_int8(x, lin.in_scale).reshape(m, k)
    q = _unpack_int4(lin.q) if kind == "int4" else lin.q
    acc = int_mm(x8, q)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc.long(), torch.matmul(x8.double(), q.double().t()).long())
    out, _ = linear_apply(lin, x, torch.bfloat16)
    ref = acc.float() * ((1.0 / lin.in_scale.to(torch.bfloat16).float()) * lin.w_scale_inv) + b.float()
    assert out.shape == (1, m, n) and out.dtype == torch.bfloat16
    assert bool(((out.float()[0] - ref).abs() <= 1e-6 + 2**-8 * ref.abs()).all())


@pytest.mark.parametrize("h_latent,w_latent", [(128, 128), (90, 128), (64, 64)])
def test_rope_backward_is_its_plain_version_bit_for_bit(dev, h_latent, w_latent):
    """The rope pass's backward build, one launch for q and k, equals
    rope_rotate_ref_backward exactly (±0 equal), on a contiguous gradient and on a
    head-folded strided one, into contiguous outputs."""
    from flux_fp8_api_tpu_torch.ops.attention import fold_heads
    from flux_fp8_api_tpu_torch.ops.attention_kernel import rope_rotate_backward, rope_rotate_ref_backward

    l = _l(h_latent, w_latent)
    gen = torch.Generator(device=dev).manual_seed(l + 7)
    gq = torch.randn((24, l, 128), generator=gen, device=dev).to(torch.bfloat16)
    gk = fold_heads(torch.randn((1, l, 24, 128), generator=gen, device=dev).to(torch.bfloat16))
    cos, sin = _tables(dev, h_latent, w_latent)
    before = dict(LAUNCHES)
    dq, dk = rope_rotate_backward(gq, gk, cos, sin)
    assert _launched(before) == {"rope_rotate_backward": 1}
    assert dq.is_contiguous() and dk.is_contiguous()
    assert torch.equal(dq, rope_rotate_ref_backward(gq, cos, sin))
    assert torch.equal(dk, rope_rotate_ref_backward(gk, cos, sin))


def test_rope_function_on_the_card_is_autograd_of_the_plain_version(dev):
    """Through the autograd Function: one forward and one backward launch, and the
    grads of q and k equal autograd's through rope_rotate_ref on the card, bit for bit."""
    l = _l(64, 64)
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, gq, gk = (torch.randn((24, l, 128), generator=gen, device=dev).to(torch.bfloat16) for _ in range(4))
    cos, sin = _tables(dev, 64, 64)
    qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
    before = dict(LAUNCHES)
    got = torch.autograd.grad(rope_rotate(qa, ka, cos, sin), (qa, ka), (gq, gk))
    assert _launched(before) == {"rope_rotate": 1, "rope_rotate_backward": 1}
    qb, kb = q.clone().requires_grad_(), k.clone().requires_grad_()
    want = torch.autograd.grad((rope_rotate_ref(qb, cos, sin), rope_rotate_ref(kb, cos, sin)), (qb, kb), (gq, gk))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k1_refuses_a_gradient_on_the_card(dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (_normed(gen, 24, 256, 128).requires_grad_() for _ in range(3))
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        qknorm_attention(q, k, v, 128**-0.5)


def test_adapter_step_on_the_card_matches_the_cpu(dev):
    """A QLoRA step of a small flux (two heads of 128, 2 + 2 blocks, int8 base) on the
    card in bf16 against the same step on the CPU in fp32, from the same weights,
    adapters, batch and draws: the card launches no K1 and per block two rope-pass
    forwards (remat recomputes) and one backward. Loss 2e-2 relative and adapter
    gradients 5e-2 relative in norm: bf16 rounding of activations (2^-8 each) across
    the forward and the backward."""
    import dataclasses

    from flux_fp8_api_tpu_torch.lora import adapter_tensors, init_lora_adapters, merge_lora_adapters
    from flux_fp8_api_tpu_torch.models.flux import FluxStatic, init_flux_params, quant_tier
    from flux_fp8_api_tpu_torch.parallel.train import flow_matching_loss, make_dummy_batch, train_cfg
    from flux_fp8_api_tpu_torch.utils.config import FluxParams
    from flux_fp8_api_tpu_torch.utils.tree import tree_to

    params = FluxParams(in_channels=64, vec_in_dim=64, context_in_dim=128, hidden_size=256, mlp_ratio=4.0,
                        num_heads=2, depth=2, depth_single_blocks=2, axes_dim=[16, 56, 56], theta=10_000,
                        qkv_bias=True, guidance_embed=True)
    cfg = FluxStatic.from_params(params, compute_dtype="float32", use_pallas=False)
    cpu = torch.Generator().manual_seed(0)
    model = init_flux_params(cfg, cpu, torch.float32, quant_tier("int8"))
    adapters = init_lora_adapters(model, 4, cpu, dtype=torch.float32)
    with torch.no_grad():
        for p in adapter_tensors(adapters):
            p.copy_(torch.randn(p.shape, generator=cpu) * 0.02)
    batch = make_dummy_batch(cfg, 1, 32, 32, 16, cpu)
    tt = torch.rand((1,), generator=cpu)
    eps = torch.randn(batch["latents"].shape, generator=cpu)

    def run(device, dtype):
        m = tree_to(model, device)
        ad = {s: [{n: {k: v.detach().to(device, dtype).requires_grad_() for k, v in ab.items()}
                   for n, ab in e.items()} for e in blocks] for s, blocks in adapters.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        c = train_cfg(dataclasses.replace(cfg, compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32"),
                      remat=True, dequant=True)
        loss = flow_matching_loss(merge_lora_adapters(m, ad), c, b, t=tt.to(device), noise=eps.to(device))
        grads = torch.autograd.grad(loss, adapter_tensors(ad))
        return float(loss.detach()), torch.cat([g.float().flatten().cpu() for g in grads])

    before = dict(LAUNCHES)
    loss_card, g_card = run(dev, torch.bfloat16)
    blocks = params.depth + params.depth_single_blocks
    assert _launched(before) == {"rope_rotate": 2 * blocks, "rope_rotate_backward": blocks}
    loss_cpu, g_cpu = run("cpu", torch.float32)
    assert abs(loss_card - loss_cpu) <= 2e-2 * abs(loss_cpu)
    assert float((g_card - g_cpu).norm() / g_cpu.norm()) <= 5e-2


def test_row_parallel_fp32_partial_is_differentiable_on_the_card(dev):
    """The row-parallel partial ``_f32_product`` (cuBLAS's bf16 GEMM with an fp32
    output, which has no derivative of its own) under autograd: its value and its
    gradients equal those of the same product through ``F.linear`` on the fp32-cast
    operands, the gradients taken in bf16 as a bf16 ``F.linear``'s backward takes them
    (the products of bf16 values are exact in fp32; 2^-8 relative covers the one
    rounding of each gradient to bf16)."""
    from flux_fp8_api_tpu_torch.ops.quant import _f32_product

    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((3, 40, 256), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    w = torch.randn((96, 256), generator=gen, device=dev).to(torch.bfloat16).requires_grad_()
    g = torch.randn((3, 40, 96), generator=gen, device=dev).to(torch.bfloat16).float()
    out = _f32_product(x, w)
    assert out.dtype == torch.float32
    dx, dw = torch.autograd.grad(out, (x, w), g)
    xr, wr = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    ref = torch.nn.functional.linear(xr, wr)
    rx, rw = torch.autograd.grad(ref, (xr, wr), g)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)
    for got, want in ((dx, rx), (dw, rw)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want).norm() / want.norm()) < 2**-8
