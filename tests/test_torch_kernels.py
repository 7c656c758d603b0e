"""The port's CUDA kernel and fp8 linear on the card, against their plain PyTorch
versions. Every test here needs a CUDA device and skips without one; the file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

Tolerances: the kernel and its plain version round p to bf16 the same way; the rest is
fp32 summation order and the final bf16 rounding of the output (2^-8 relative), so
|kernel − plain| ≤ 1e-3 + 1e-2·|plain|. The fp8 GEMM: fast accumulation and the bf16
output each cost about 2^-8, so max|out − plain| ≤ 2e-2·max|plain|.
"""

import pytest
import torch

from flux_fp8_api_tpu_torch.ops.attention import attention_core
from flux_fp8_api_tpu_torch.ops.attention_kernel import (
    LAUNCHES,
    qknorm_attention,
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
