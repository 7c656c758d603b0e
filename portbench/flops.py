"""The work of a flow evaluation, counted from the configuration's shapes, and the
card's published peaks: the yardstick of the roofline and MFU metrics.

Peaks are NVIDIA's for one H100 SXM, dense: 1,979 TFLOP/s fp8, 989 TFLOP/s bf16,
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s. ``bound``,
``attention_bound`` and ``rope_bound`` are frozen copies of the repository's
``chip_smoke.py`` yardsticks.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

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


def lengths(params: Dict, width: int, height: int, txt_len: int) -> Tuple[int, int]:
    """(image tokens, joint tokens) of a request."""
    img = (height // 16) * (width // 16)
    return img, img + txt_len


def block_linears(params: Dict, l_img: int, l_txt: int) -> Iterator[Tuple[str, int, int, int]]:
    """(name, M, K, N) of every linear of the 57 blocks in one evaluation, modulation
    included (M = 1: the conditioning vector)."""
    hs = params["hidden_size"]
    mh = int(hs * params["mlp_ratio"])
    for _ in range(params["depth"]):
        for m in (l_img, l_txt):
            yield "mod", 1, hs, 6 * hs
            yield "qkv", m, hs, 3 * hs
            yield "proj", m, hs, hs
            yield "mlp0", m, hs, mh
            yield "mlp2", m, mh, hs
    for _ in range(params["depth_single_blocks"]):
        m = l_img + l_txt
        yield "mod", 1, hs, 3 * hs
        yield "linear1", m, hs, 3 * hs + mh
        yield "linear2", m, hs + mh, hs


def block_linear_flops(params: Dict, l_img: int, l_txt: int, modulation: bool = False) -> float:
    """2·M·K·N over the blocks' linears (the token-wise ones; with ``modulation`` the
    M = 1 modulation products too)."""
    return float(sum(2 * m * k * n for name, m, k, n in block_linears(params, l_img, l_txt)
                     if modulation or name != "mod"))


def fp8_linears_ms(params: Dict, l_img: int, l_txt: int) -> float:
    """The least time of one evaluation's fp8 linears: each at the larger of its
    operations at the fp8 peak and its bytes (e5m2 activation and e4m3 weight read
    once, bf16 output written once)."""
    return sum(bound(2 * m * k * n, m * k + k * n + 2 * m * n, PEAK_FP8_FLOPS)[0]
               for _, m, k, n in block_linears(params, l_img, l_txt))


def attention_flops(params: Dict, l_joint: int) -> float:
    blocks = params["depth"] + params["depth_single_blocks"]
    hd = params["hidden_size"] // params["num_heads"]
    return float(blocks * 4 * params["num_heads"] * l_joint * l_joint * hd)


def float_linear_flops(params: Dict, l_img: int, l_txt: int) -> float:
    """The bf16 linears outside the blocks: img_in, txt_in, the conditioning MLPs and
    the final layer."""
    hs, c = params["hidden_size"], params["in_channels"]
    emb = 2 * (256 * hs + hs * hs) + 2 * (params["vec_in_dim"] * hs + hs * hs)
    if params["guidance_embed"]:
        emb += 2 * (256 * hs + hs * hs)
    return float(2 * l_img * c * hs + 2 * l_txt * params["context_in_dim"] * hs + emb
                 + 2 * hs * 2 * hs + 2 * l_img * hs * c)


def evaluation_ms(params: Dict, l_img: int, l_txt: int) -> float:
    """The least time of one flow evaluation, each operation at the peak of its
    precision: the blocks' linears at fp8, attention and the other linears at bf16."""
    fp8 = block_linear_flops(params, l_img, l_txt, modulation=True) / PEAK_FP8_FLOPS
    bf16 = (attention_flops(params, l_img + l_txt) + float_linear_flops(params, l_img, l_txt)) / PEAK_BF16_FLOPS
    return (fp8 + bf16) * 1e3
