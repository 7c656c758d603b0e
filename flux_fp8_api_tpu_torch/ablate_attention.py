"""Attention ceiling ablation on the card: how the attention call's time splits
between the exp, the rope and the two products, at the serving shapes.

    python -m flux_fp8_api_tpu_torch.ablate_attention [L ...]   # default 2816 3392 4608

JAX counterpart: the root ``ablate_attention.py``. Four variants of the attention call
are timed per joint sequence length (``ops.attention.benchmark_blocks``):

    full        — serving: the rope pass, then K1 with the exp softmax
    no_exp      — the rope pass, then K1's build without the exp   (full − no_exp = exp cost)
    no_rope     — K1 alone, no tables, so no rope pass             (full − no_rope = rope cost)
    matmul_only — both off: the two products, mask, den and epilogue

and set against two ceilings: the bare two-dot kernel (``csrc/bare_two_dot.cu``, the
two products alone, ``mma.sync`` on 64-row tiles) and the analytic time of 4·H·L²·D
FLOP at the card's bf16 matmul rate, measured at the start of the run with a large
``torch.matmul`` (a yardstick, not a kernel of this repository). Prints the card line
and the rate on stderr, one JSON line per L, then a markdown table.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Optional

import torch

from .ops.attention import benchmark_blocks, cuda_device, fed_back_seconds
from .ops.attention_kernel import BLOCKS, LAUNCHES, check_heads, head_strides, load_library

HEADS, HEAD_DIM = 24, 128
CALLS_PER_STEP = 19 + 38  # one joint attention per double + single block
# BLOCKS, imported above, is K1's one compiled tile (q rows per CTA, kv rows per stage)
BARE_BLOCKS = (64, 64)  # the bare two-dot's one compiled tile: (q rows, kv rows)


def bare_two_dot_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the bare two-dot kernel: ``bf16(Σ_kv bf16(q·kᵀ)·v)`` with fp32
    products, no softmax, rope, mask or normalisation. (H, Lq, D) × (H, Lkv, D) →
    (H, Lq, D) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.matmul(s.to(torch.bfloat16).float(), v.float()).to(q.dtype)


def bare_two_dot(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bare two-dot kernel (JAX: ``ablate_attention._bare_two_dot``). Lq and Lkv
    must be multiples of its 64-row tile, ``BARE_BLOCKS`` (ValueError otherwise: the
    kernel has no tail mask). CPU tensors run :func:`bare_two_dot_ref`; CUDA tensors launch the
    kernel, which takes what the attention kernel takes (bf16, D = 128, contiguous
    last dimension), or raise."""
    lq, lkv = q.shape[1], k.shape[1]
    if lq % BARE_BLOCKS[0] or lkv % BARE_BLOCKS[1]:
        raise ValueError(f"Lq={lq} and Lkv={lkv} must be multiples of the {BARE_BLOCKS} tile")
    if not q.is_cuda:
        return bare_two_dot_ref(q, k, v)
    check_heads(q, k, v)
    h, _, d = q.shape
    out = torch.empty((h, lq, d), dtype=q.dtype, device=q.device)
    err = load_library().bare_two_dot_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *head_strides(q, k, v, out),
        h, lq, lkv, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bare_two_dot kernel launch failed: cudaError {err}")
    LAUNCHES["bare_two_dot"] += 1
    return out


def bare_two_dot_ms(l: int, heads: int = HEADS, head_dim: int = HEAD_DIM, iters: int = 24) -> float:
    """Per-call ms of the bare two-dot kernel at L = ``l`` (a multiple of 64), timed as
    ``benchmark_blocks`` times the attention kernel: inputs from a generator seeded
    with 17, each output fed back as the next q (it overflows after a few calls, which
    does not change the time)."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn((heads, l, head_dim), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    return fed_back_seconds(lambda x: bare_two_dot(x, k, v), q, iters) * 1e3


def bf16_matmul_tflops(n: int = 8192, iters: int = 20) -> float:
    """The card's bf16 matmul rate in TFLOP/s: ``torch.matmul`` of two (n, n) bf16
    matrices, timed with CUDA events over ``iters`` calls after one warm call."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    c = torch.empty_like(a)
    seconds = fed_back_seconds(lambda x: torch.matmul(a, b, out=x), c, iters)
    return 2 * n**3 / seconds / 1e12


def ablation_row(l: int, timings: Dict[str, float], bare_ms: Optional[float],
                 bf16_tflops: float) -> dict:
    """The derived fields of one ablation row (those of the JAX tool's ``ablate``):
    ``timings`` maps full / no_exp / no_rope / matmul_only to seconds per call,
    ``bare_ms`` is the bare two-dot's ms per call (None where L is not a multiple of
    its tile), ``bf16_tflops`` the matmul rate the analytic roofline uses. ``blocks``
    is K1's tile."""
    t = timings
    flops = 4 * HEADS * l * l * HEAD_DIM
    roofline = flops / (bf16_tflops * 1e12)
    return {
        "L": l,
        "blocks": list(BLOCKS),
        "const_tables": False,
        "ms": {k: round(v * 1e3, 3) for k, v in t.items()},
        "roofline_ms": round(roofline * 1e3, 3),
        "bare_two_dot_ms": round(bare_ms, 3) if bare_ms is not None else None,
        "exp_cost_ms": round((t["full"] - t["no_exp"]) * 1e3, 3),
        "rope_cost_ms": round((t["full"] - t["no_rope"]) * 1e3, 3),
        "slack_ms": round((t["matmul_only"] - roofline) * 1e3, 3),
        "attained_pct": round(100.0 * roofline / t["full"], 1),
        "attained_vs_bare_pct": (
            round(100.0 * bare_ms / (t["full"] * 1e3), 1) if bare_ms is not None else None
        ),
        "per_step_ms": round(t["full"] * 1e3 * CALLS_PER_STEP, 1),
    }


def ablate(l: int, bf16_tflops: float, iters: int = 24) -> dict:
    """Time the four attention variants and the bare two-dot at L = ``l`` on the card."""
    kw = dict(folded_heads=HEADS, head_dim=HEAD_DIM, iters=iters)
    t = {
        "full": benchmark_blocks(l, **kw),
        "no_exp": benchmark_blocks(l, ablate_exp=True, **kw),
        "no_rope": benchmark_blocks(l, fuse_rope=False, **kw),
        "matmul_only": benchmark_blocks(l, fuse_rope=False, ablate_exp=True, **kw),
    }
    divides = l % BARE_BLOCKS[0] == 0 and l % BARE_BLOCKS[1] == 0
    bare_ms = bare_two_dot_ms(l, iters=iters) if divides else None
    return ablation_row(l, t, bare_ms, bf16_tflops)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> list:
    """Run the ablation at each L of ``argv`` (default the serving lengths); print and
    return the rows."""
    ls = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [2816, 3392, 4608]
    cuda_device()
    rate = bf16_matmul_tflops()
    print(f"card: {card_line()} | bf16 torch.matmul 8192^3: {rate:.1f} TFLOP/s", file=sys.stderr)
    rows = [ablate(l, rate) for l in ls]
    for r in rows:
        print(json.dumps(r))
    print("\n| L | blocks | full ms | exp cost | rope cost | matmul-only | bare two-dot "
          "| analytic roofline | attained % | attained vs bare % |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['L']} | {tuple(r['blocks'])} | {r['ms']['full']} | {r['exp_cost_ms']} "
            f"| {r['rope_cost_ms']} | {r['ms']['matmul_only']} | {r['bare_two_dot_ms']} "
            f"| {r['roofline_ms']} | {r['attained_pct']} | {r['attained_vs_bare_pct']} |"
        )
    return rows


if __name__ == "__main__":
    main()
