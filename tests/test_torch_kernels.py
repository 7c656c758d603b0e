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
norm, in fp64, to 1e-2. The bare two-dot: bf16 logits and output on both sides, so
max|kernel − plain| ≤ 1e-2·max|plain|. The fp8 GEMM: fast accumulation and the bf16
output each cost about 2^-8, so max|out − plain| ≤ 2e-2·max|plain|.
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
)
from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
from flux_fp8_api_tpu_torch.ops.quant import (
    F8_INPUT_MAX,
    INPUT_F8_DTYPE,
    fp8_linear_ref,
    linear_apply,
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
    before = LAUNCHES["qknorm_attention"]
    out = qknorm_attention(q, k, v, d**-0.5, **kw)
    assert LAUNCHES["qknorm_attention"] == before + 1
    ref = qknorm_attention_ref(q, k, v, d**-0.5, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-3, rtol=1e-2)


def test_all_underflow_rows_are_zero(dev):
    q = torch.ones(2, 200, 128, device=dev, dtype=torch.bfloat16)
    k = torch.full((2, 200, 128), -90.0 / 128, device=dev, dtype=torch.bfloat16)
    out = qknorm_attention(q, k, q, 1.0)
    assert torch.equal(out.float(), torch.zeros_like(out, dtype=torch.float32))


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


@pytest.mark.parametrize("l,rope", [(4608, True), (1000, False)])  # 1000: a tail kv tile
def test_stats_build_matches_serving_build_and_plain_version(dev, l, rope):
    gen = torch.Generator(device=dev).manual_seed(l)
    q, k = _normed(gen, 24, l, 128), _normed(gen, 24, l, 128)
    v = torch.randn(24, l, 128, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(zip(("cos", "sin"), _tables(dev, 128, 128))) if rope else {}
    before = dict(LAUNCHES)
    out, m = qknorm_attention(q, k, v, 128**-0.5, return_max_logit=True, **kw)
    assert _launched(before) == {"qknorm_attention_stats": 1}
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
    assert _launched(before) == {"qknorm_attention_ablate_exp": 1}
    ref = qknorm_attention_ref(q, k, v, 128**-0.5, ablate_exp=True, **kw)
    o, r = out.double(), ref.double()
    assert bool(torch.isfinite(o).all())
    assert float((o - r).norm() / r.norm()) <= 1e-2


@pytest.mark.parametrize("lq,lkv", [(4608, 4608), (1536, 4608)])
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


def test_benchmark_blocks_launches_what_it_times(dev):
    before = dict(LAUNCHES)
    seconds = benchmark_blocks(1536, iters=3, ablate_exp=True)
    assert seconds > 0
    assert _launched(before) == {"qknorm_attention_ablate_exp": 4}  # one warm + 3 timed


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
