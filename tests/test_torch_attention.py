"""The attention kernel's plain version against the JAX Pallas kernel (interpret mode,
as the JAX package's own tests run it on the CPU), and attention_core against the JAX
package's XLA path. The CUDA kernel itself runs only on the card
(tests/test_torch_kernels.py).

Tolerances: the plain version and the Pallas kernel compute the same function with
the same roundings (bf16 p before P·V), in fp32 otherwise, so they agree to fp32
summation order, except where a p sits on a bf16 rounding boundary and the two round
it apart: that moves an output by about 2^-8·p·|v|/den, so rtol 1e-4, atol 1e-4.
Against the XLA path (exact softmax, p not rounded) the gap is the bf16 rounding of p,
which the JAX tests bound at 5e-3 relative in norm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.ops.attention_kernel import qknorm_attention as jax_kernel
from flux_fp8_api_tpu.ops.rope import embed_nd_cos_sin as jembed
from flux_fp8_api_tpu_torch.ops import attention as tattn
from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES, qknorm_attention

from .torch_parity import t

torch.set_num_threads(1)


def _normed(r, shape):
    x = r.normal(size=shape).astype(np.float32)
    return x / np.sqrt(np.mean(x * x, -1, keepdims=True))


def _tables(l, d):
    ids = np.zeros((1, l, 3), np.float32)
    ids[0, :, 1] = np.arange(l) // 7
    ids[0, :, 2] = np.arange(l) % 7
    axes = (d // 4, 3 * d // 8, 3 * d // 8)
    cos, sin = jembed(jnp.asarray(ids), axes, 10_000)
    return np.asarray(cos[0]), np.asarray(sin[0])


CASES = [
    # (heads, lq, lkv, d, rope, block_q, block_kv): lengths that are not block
    # multiples exercise the padded q rows and the tail-masked kv block
    (2, 256, 256, 32, True, 128, 128),
    (2, 200, 200, 32, True, 128, 128),
    (3, 136, 136, 16, False, 64, 64),
    (2, 64, 200, 32, True, 64, 128),
]


@pytest.mark.parametrize("h,lq,lkv,d,rope,bq,bkv", CASES)
def test_plain_version_matches_pallas_kernel(h, lq, lkv, d, rope, bq, bkv):
    r = np.random.default_rng(lq + lkv + d)
    q, k = _normed(r, (h, lq, d)), _normed(r, (h, lkv, d))
    v = r.normal(size=(h, lkv, d)).astype(np.float32)
    scale = d**-0.5
    jkw, tkw = {}, {}
    if rope:
        cos, sin = _tables(lkv, d)
        jkw = dict(cos=jnp.asarray(cos), sin=jnp.asarray(sin))
        tkw = dict(cos=t(cos), sin=t(sin))
        if lq != lkv:  # a q shard: the last lq positions
            jkw.update(cos_q=jnp.asarray(cos[-lq:]), sin_q=jnp.asarray(sin[-lq:]))
            tkw.update(cos_q=t(cos[-lq:]), sin_q=t(sin[-lq:]))
    a = jax_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                   block_q=bq, block_kv=bkv, interpret=True, **jkw)
    b = qknorm_attention(t(q), t(k), t(v), scale, **tkw)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)


def test_all_underflow_rows_emit_zero_not_nan():
    """Port of tests/test_attention_kernel.py TestUnderflowRows: every logit is -90,
    exp(-90 - SHIFT) underflows in fp32, den is 0 → the clamp makes the rows 0."""
    h, l, d = 1, 128, 32
    q = torch.ones((h, l, d))
    k = -torch.ones((h, l, d)) * (90.0 / d)
    v = torch.ones((h, l, d))
    out = qknorm_attention(q, k, v, 1.0)
    jout = jax_kernel(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                      1.0, block_q=128, block_kv=128, interpret=True)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_array_equal(out.numpy(), 0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_cpu_tensors_do_not_count_as_launches():
    before = LAUNCHES["qknorm_attention"]
    x = torch.randn(2, 16, 8)
    qknorm_attention(x, x, x, 0.3)
    assert LAUNCHES["qknorm_attention"] == before


@pytest.mark.parametrize("batch", [1, 2])
def test_attention_core_matches_jax_xla_path(batch):
    r = np.random.default_rng(batch)
    b, l, n, d = batch, 40, 2, 16
    q, k = _normed(r, (b, l, n, d)), _normed(r, (b, l, n, d))
    v = r.normal(size=(b, l, n, d)).astype(np.float32)
    cos, sin = _tables(l, d)
    cos4 = np.broadcast_to(cos[None, :, None, :], (b, l, 1, d)).copy()
    sin4 = np.broadcast_to(sin[None, :, None, :], (b, l, 1, d)).copy()
    a = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(cos4), jnp.asarray(sin4), use_pallas=False))
    out = tattn.attention(t(q), t(k), t(v), t(cos4), t(sin4))
    assert out.shape == (b, l, n * d)
    rel = np.linalg.norm(out.numpy() - a) / np.linalg.norm(a)
    assert rel < 5e-3, rel
    core = tattn.attention_core(t(q), t(k), t(v))
    a_core = np.asarray(jattn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=False))
    assert np.linalg.norm(core.numpy() - a_core) / np.linalg.norm(a_core) < 5e-3


def test_wrapper_rejects_what_the_kernel_cannot_take():
    """CUDA-only checks, reached on the CPU through a tensor that claims CUDA."""
    from flux_fp8_api_tpu_torch.ops import attention_kernel

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    q = torch.zeros(2, 8, 64, dtype=torch.bfloat16).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="128"):
        attention_kernel.qknorm_attention(q, q, q, 0.1)
    q32 = torch.zeros(2, 8, 128).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="bfloat16"):
        attention_kernel.qknorm_attention(q32, q32, q32, 0.1)
