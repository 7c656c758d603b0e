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
