"""The card's published peaks and the least time of a piece of work against them: the
yardstick of the roofline and MFU metrics. A family counts its own model's work
(``families/<family>.py``: ``evaluation_ms``, ``fp8_linears_ms``, ``attention_ms``)
through these.

Peaks are NVIDIA's for one H100 SXM, dense: 1,979 TFLOP/s fp8, 989 TFLOP/s bf16,
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s. ``bound``,
``attention_bound`` and ``rope_bound`` are frozen copies of the repository's
``chip_smoke.py`` yardsticks.
"""

from __future__ import annotations

PEAK_FP8_FLOPS, PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 1979e12, 989e12, 67e12, 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take for work of
    ``flops`` operations that must move ``nbytes``, against its published peaks."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound(h: int, l: int, d: int = 128):
    """K1's bound at Lq = Lkv = l: 4·H·L²·D bf16 tensor-core operations; q, k, v read
    and the output written once, bf16."""
    return bound(4 * h * l * l * d, 4 * h * l * d * 2)


def rope_bound(h: int, l: int, d: int = 128):
    """The rope pass's bound at Lq = Lkv = l: 3 fp32 operations per element (two
    products, one sum); q and k read and written once in bf16, and the one pair of fp32
    tables they share."""
    return bound(3 * h * d * 2 * l, 2 * 2 * h * d * 2 * l + 2 * 4 * d * l, PEAK_F32_FLOPS)
