"""The port's attention ceiling ablation (flux_fp8_api_tpu_torch.ablate_attention)
against the root ablate_attention.py: the bare two-dot kernel's plain version against
the Pallas kernel in interpret mode, and the arithmetic of an ablation row against the
JAX tool's ``ablate`` fed the same timings. The CUDA kernels and the timing itself run
only on the card (tests/test_torch_kernels.py, chip_smoke.py).

Tolerances: the bare two-dot rounds the fp32 logits to bf16 and the output to bf16 on
both sides; fp32 summation order can put a logit or an output on the other side of a
bf16 rounding step, 2^-8 relative, so the gap is at most about 2^-8·max|out|: checked
at 1e-2·max|plain|, as the JAX package's own test of the kernel checks it. The row's
fields are the same float expressions of the same inputs: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ablate_attention as jablate
from flux_fp8_api_tpu_torch import ablate_attention as tablate
from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES

from .torch_parity import t

torch.set_num_threads(1)


@pytest.mark.parametrize("h,lq,lkv,d,bq,bkv", [
    (2, 256, 256, 32, 128, 128),
    (3, 128, 256, 16, 64, 128),
])
def test_bare_two_dot_plain_version_matches_pallas_kernel(h, lq, lkv, d, bq, bkv):
    r = np.random.default_rng(lq + lkv + d)
    q, k, v = (r.normal(size=(h, n, d)).astype(np.float32) for n in (lq, lkv, lkv))
    a = np.asarray(jablate._bare_two_dot(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        block_q=bq, block_kv=bkv, interpret=True,
    ).astype(jnp.float32))
    before = dict(LAUNCHES)
    b = tablate.bare_two_dot(*(t(x, torch.bfloat16) for x in (q, k, v)))
    assert LAUNCHES == before  # the plain version is no launch
    assert b.shape == (h, lq, d) and b.dtype == torch.bfloat16
    b = b.float().numpy()
    assert np.abs(b - a).max() <= 1e-2 * np.abs(b).max()


@pytest.mark.parametrize("lq,lkv", [(200, 256), (256, 200)])
def test_bare_two_dot_refuses_lengths_off_the_tile(lq, lkv):
    q = torch.zeros(2, lq, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, lkv, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples"):
        tablate.bare_two_dot(q, k, k)


def _timings(l):
    """Seconds per call of the four builds, made up and distinct, shaped like L²."""
    base = 1.8734e-3 * (l / 4608) ** 2
    return {
        (True, False): base,               # full
        (True, True): base * 0.6713,       # no_exp
        (False, False): base * 0.9411,     # no_rope
        (False, True): base * 0.6102,      # matmul_only
    }


@pytest.mark.parametrize("l", [4608, 3392, 2816, 200])
def test_ablation_row_matches_jax_ablate(monkeypatch, l):
    """Both tools fed the same timings and the same bf16 rate give the same derived
    fields; only the tile differs (K1's one 128 × 128 tile against the Pallas kernel's
    blocks). L = 200 divides no bare two-dot tile (64 rows): no bare two-dot time."""
    tm = _timings(l)
    bare_ms = 1.2345 * (l / 4608) ** 2 if l % tablate.BARE_BLOCKS[0] == 0 else None

    def fake_benchmark(l_, blocks, fuse_rope=True, ablate_exp=False, **kw):
        return tm[(fuse_rope, ablate_exp)]

    monkeypatch.setattr(jablate, "benchmark_blocks", fake_benchmark)
    monkeypatch.setattr(jablate, "bare_two_dot_ms", lambda l_, blocks, **kw: bare_ms)
    monkeypatch.setattr(jablate, "BF16_TFLOPS", 181.0)
    want = jablate.ablate(l)
    timings = {"full": tm[(True, False)], "no_exp": tm[(True, True)],
               "no_rope": tm[(False, False)], "matmul_only": tm[(False, True)]}
    got = tablate.ablation_row(l, timings, bare_ms, 181.0)
    assert got["blocks"] == list(tablate.BLOCKS) == [128, 128] and got["const_tables"] is False
    assert tablate.BARE_BLOCKS == (64, 64)
    for key in ("blocks", "const_tables"):
        got.pop(key), want.pop(key)
    assert got == want


@pytest.mark.parametrize("measure", ["bare_two_dot_ms", "bf16_matmul_tflops", "main"])
def test_measurements_need_the_card(measure):
    """The bare two-dot's time, the bf16 rate and the whole tool time CUDA kernels
    only: without a card they raise instead of timing a plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py runs the tool there")
    call = {"bare_two_dot_ms": lambda: tablate.bare_two_dot_ms(128, heads=2, iters=1),
            "bf16_matmul_tflops": lambda: tablate.bf16_matmul_tflops(n=64, iters=1),
            "main": lambda: tablate.main(["128"])}[measure]
    with pytest.raises(RuntimeError, match="CUDA device"):
        call()
