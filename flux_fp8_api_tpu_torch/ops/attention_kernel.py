"""Max-free qk-norm attention: the hand-written CUDA kernel in its three builds
(serving, stats, ablate) and the rope pass in front of it with its backward build,
their plain PyTorch versions, the wrappers that pick between them by device, the
autograd Function of the rope pass, the guard rail built on the stats build, and the
kernels' build.

JAX counterpart: ``flux_fp8_api_tpu.ops.attention_kernel`` (the Pallas TPU kernel),
whose docstring argues why FLUX's qk-RMSNorm makes a constant-shift softmax safe:
``p = exp(s - SHIFT)``, ``out = Σp·v / Σp``. The Pallas kernel rotates q and k inside
the kernel; on the card the rope pass (``csrc/rope_rotate.cu``) rotates them once per
call and the attention kernel (``csrc/qknorm_attention.cu``: TMA loads, ``wgmma``,
warp-specialised) reads the rotated copies.

The CUDA sources are those two files in ``csrc/``; ``qknorm_attention.cu`` also holds a
fourth build of the same body, the bare two products that
``flux_fp8_api_tpu_torch.ablate_attention`` measures as the ceiling. The attention
kernel's tile (q rows per CTA, kv rows per stage, ring depth) is a compile-time choice:
its source is compiled once per tile of :data:`TILES`, each compile's entry points
named by the tile, and a call takes a tile (``blocks``, as the Pallas kernel takes
``block_q`` / ``block_kv``; ``ops/attention.py`` picks it per shape). Every compile is
``nvcc`` for ``sm_90a`` at first use, all started at once, linked into one shared
library with a plain C interface in ``build/kernels/<hash of the sources and tiles>/``
at the repository root, loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

SHIFT = 20.0
MAX_SAFE_LOGIT = 100.0
HEAD_DIM = 128  # the only head dim the CUDA kernels take
# The attention kernel's compiled tiles: (q rows per CTA, kv rows per stage, stages of the
# k/v ring). csrc/qknorm_attention.cu's note says what each trades; ops/attention.py's
# autotuner measures them. A call names its tile by (q rows, kv rows), its ``blocks``.
TILES = ((128, 128, 2), (128, 64, 2), (64, 128, 2), (64, 64, 2))
BLOCKS = (128, 128)  # the default tile: what every call runs unless a tuned table says otherwise
BOX_COLS = 64  # head columns per TMA box: 128 bytes, the span of the 128-byte swizzle

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("qknorm_attention.cu", "rope_rotate.cu")
_TILED_SOURCE = "qknorm_attention.cu"  # compiled once per tile
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Launch count of each CUDA kernel build: its wrapper adds one per launch and nowhere
# else. Drivers reset them to 0 before a run and read them after, to show the path
# used each build.
LAUNCHES = {
    "qknorm_attention": 0,
    "qknorm_attention_stats": 0,
    "qknorm_attention_ablate_exp": 0,
    "rope_rotate": 0,
    "rope_rotate_backward": 0,
    "bare_two_dot": 0,
}
_TILED_BUILDS = ("qknorm_attention", "qknorm_attention_stats", "qknorm_attention_ablate_exp", "bare_two_dot")
# The same launches by build and tile, ``(build, (q rows, kv rows))``: which tile ran.
TILE_LAUNCHES = {(build, tuple(t[:2])): 0 for build in _TILED_BUILDS for t in TILES}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the attention kernels are built with the CUDA toolkit")


def tile_suffix(tile) -> str:
    """The suffix of a compiled tile's entry points: (128, 64, 2) → ``_128x64x2``."""
    return "_" + "x".join(str(int(x)) for x in tile)


def check_tile(blocks) -> tuple:
    """The compiled tile (q rows, kv rows, stages) of ``blocks`` = (q rows, kv rows).
    Raises ValueError for a pair that is not in :data:`TILES`: no other tile is
    compiled, and none is substituted."""
    key = tuple(int(b) for b in blocks)
    for tile in TILES:
        if key == tile[:2]:
            return tile
    raise ValueError(f"no compiled attention tile {tuple(blocks)}: the kernel is built at "
                     f"{[t[:2] for t in TILES]} (ops/attention_kernel.py:TILES)")


def _compiles():
    """(label, source, extra nvcc flags) of every compile of the library: the attention
    source once per tile, each with the macros that choose the tile and name its entry
    points, then every other source once."""
    out = []
    for src in _SOURCES:
        if src != _TILED_SOURCE:
            out.append((src, src, ()))
            continue
        for tile in TILES:
            bq, bkv, st = tile
            out.append((f"{src} tile {bq}x{bkv}x{st}", src,
                        (f"-DFLUX_BLOCK_Q={bq}", f"-DFLUX_BLOCK_KV={bkv}", f"-DFLUX_STAGES={st}",
                         f"-DFLUX_TILE_SUFFIX={tile_suffix(tile)}")))
    return out


def library_path() -> Path:
    """Where the built library lives: keyed by a hash of the kernel sources and the
    compiled tiles."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    h.update(repr(TILES).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libflux_kernels.so"


def build_library() -> Path:
    """Compile the kernels for sm_90a if this hash has no library yet: one ``nvcc -c``
    per source and tile (:func:`_compiles`), all started together, then one link. The
    ptxas report of every kernel goes to ``ptxas.log`` beside the library, each
    compile's under its label. Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compiles = _compiles()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{i}_{Path(src).stem}.o") for i, (_, src, _) in enumerate(compiles)]
        procs = [
            subprocess.Popen([nvcc, *_NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c", "-o", obj, str(_CSRC / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for (_, src, flags), obj in zip(compiles, objs)
        ]
        logs = [p.communicate()[1] for p in procs]  # waits for every compile
        for (label, _, _), p, err in zip(compiles, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {label} ({p.returncode}):\n{err}")
        so = str(Path(tmp) / out.name)
        proc = subprocess.run([nvcc, *_NVCC_FLAGS, "-shared", "-o", so, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        (out.parent / "ptxas.log").write_text(
            "".join(f"== {label}\n{err}" for (label, _, _), err in zip(compiles, logs)))
        os.replace(so, out)
    return out


def load_library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        maps = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int64)] * 3
        for tile in TILES:
            fn = getattr(lib, "qknorm_attention_bf16" + tile_suffix(tile))
            fn.argtypes = maps + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            fn = getattr(lib, "bare_two_dot_bf16" + tile_suffix(tile))
            fn.argtypes = maps + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        job = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        for fn in (lib.rope_rotate_bf16, lib.rope_rotate_backward_bf16):
            fn.argtypes = job + job + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or in fp64 when it is fp64 (gradcheck's dtype)."""
    return x if x.dtype == torch.float64 else x.float()


def rope_rotate_ref(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Plain version of the rope pass: half-split RoPE of x (..., L, D) with (L, D)
    tables, in fp32 (each product and the sum rounded on their own), cast back to x's
    dtype once. The JAX kernel's ``_rope_rotate``."""
    x32 = _wide(x)
    half = x32.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos.to(x32.dtype) + rotated * sin.to(x32.dtype)).to(x.dtype)


def rope_rotate_ref_backward(g: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Plain version of the rope pass's backward: the gradient of x from the gradient g
    of ``rope_rotate_ref(x, cos, sin)``, the rotation's transpose
    ``dx₁ = g₁·c₁ + g₂·s₂``, ``dx₂ = g₂·c₂ − g₁·s₁`` (halves of the last axis), with the
    products and sums that autograd forms through :func:`rope_rotate_ref`, so it equals
    autograd's gradient bit for bit."""
    g32 = _wide(g)
    c, s = cos.to(g32.dtype), sin.to(g32.dtype)
    half = g32.shape[-1] // 2
    g1, g2 = g32[..., :half], g32[..., half:]
    dx1 = g1 * c[..., :half] + g2 * s[..., half:]
    dx2 = g2 * c[..., half:] - g1 * s[..., :half]
    return torch.cat([dx1, dx2], dim=-1).to(g.dtype)


def qknorm_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
    *,
    return_max_logit: bool = False,
    ablate_exp: bool = False,
):
    """Plain PyTorch version of the kernel: the same function with the same roundings
    — rope in fp32 cast back to q's dtype (:func:`rope_rotate_ref`), fp32 logits,
    ``exp(s·scale − SHIFT)``, ``bf16(p)`` before ``P·V``, den from the unrounded p, den
    clamped at 1e-30.

    q (H, Lq, D), k/v (H, Lkv, D); cos/sin (Lkv, D) fp32, cos_q/sin_q (Lq, D)
    defaulting to cos/sin. Returns (H, Lq, D) in q's dtype; with ``return_max_logit``
    also ``max |s|·|sm_scale|`` as a 0-d fp32 tensor (NaN if any logit is NaN).
    ``ablate_exp`` drops the exp (``p = s·scale − SHIFT``): a measurement build whose
    output is not a softmax.
    """
    if cos is not None:
        cos_q = cos if cos_q is None else cos_q
        sin_q = sin if sin_q is None else sin_q
        q = rope_rotate_ref(q, cos_q, sin_q)
        k = rope_rotate_ref(k, cos, sin)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = s * sm_scale - SHIFT
    if not ablate_exp:
        p = torch.exp(p)
    den = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    out = (acc / torch.clamp(den, min=1e-30)).to(q.dtype)
    if return_max_logit:
        return out, s.abs().amax() * abs(sm_scale)
    return out


def _check_table(t: torch.Tensor, rows: int, name: str, device: torch.device) -> None:
    if t.shape != (rows, HEAD_DIM) or t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned ({rows}, {HEAD_DIM}) float32 table")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}")


def check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the CUDA kernels take: bf16 (H, L, 128) on one device, k and v of one
    shape, a contiguous and 16-byte aligned last dimension. Raises ValueError."""
    h = q.shape[0]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on {q.device}, got {t.dtype} on {t.device}")
        if t.dim() != 3 or t.shape[0] != h or t.shape[2] != HEAD_DIM:
            raise ValueError(f"{name} must be (H={h}, L, {HEAD_DIM}), got {tuple(t.shape)}")
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned last dimension")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")


def tma_params(t: torch.Tensor, rows: int = BLOCKS[1]) -> tuple:
    """The parameters of the 3-D TMA tensor map over an (H, L, 128) bf16 view, as
    ``csrc/qknorm_attention.cu`` encodes them: dims (head dim, L, H), innermost first;
    byte strides of the row and head axes (the caller's, so head-folded strided views
    need no copy); the box (``BOX_COLS`` columns, ``rows`` rows, one head: the tile's
    q rows for q, its kv rows for k and v; the default tile's 128 unless given), whose
    128-byte rows are what the 128-byte swizzle spans. A 3-D map, not an (H·L, D) one:
    rows past L read as zeros instead of the next head's rows.

    Raises ValueError on what TMA cannot take: another dtype or head dim, a
    non-contiguous last dimension, a base that is not 16-byte aligned, or a stride that
    is not a positive multiple of 16 bytes (below 2^40). The stride of an axis of size 1
    is never followed and is given as the packed one."""
    if t.dtype != torch.bfloat16 or t.dim() != 3 or t.shape[2] != HEAD_DIM:
        raise ValueError(f"a TMA map takes a bfloat16 (H, L, {HEAD_DIM}) view, got {t.dtype} {tuple(t.shape)}")
    h, l, d = t.shape
    es = t.element_size()
    if t.stride(2) != 1 or t.data_ptr() % 16:
        raise ValueError("a TMA map needs a contiguous last dimension and a 16-byte aligned base")
    row = t.stride(1) * es if l > 1 else d * es
    head = t.stride(0) * es if h > 1 else l * d * es
    for name, stride in (("row", row), ("head", head)):
        if stride <= 0 or stride % 16 or stride >= 2**40:
            raise ValueError(f"a TMA map needs 16-byte multiple strides, got a {name} stride of {stride} bytes")
    if not 0 < l < 2**31 or not 0 < h < 2**31:
        raise ValueError(f"a TMA map takes 1 <= L, H < 2^31, got {tuple(t.shape)}")
    return (d, l, h, row, head, BOX_COLS, int(rows), 1)


def _rope_launch(entry: str, build: str, q, k, cos, sin, cos_q, sin_q):
    """One launch of a rope-pass build (``entry`` in the library) on CUDA q (H, Lq, 128)
    and k (H, Lkv, 128) with their tables, into new contiguous outputs. Raises on what
    the kernel cannot take and on a failed launch."""
    check_heads(q, k, k)
    h, lq, d = q.shape
    lkv = k.shape[1]
    for name, t, rows in (("cos_q", cos_q, lq), ("sin_q", sin_q, lq), ("cos", cos, lkv), ("sin", sin, lkv)):
        _check_table(t, rows, name, q.device)
    q_out = torch.empty((h, lq, d), dtype=q.dtype, device=q.device)
    k_out = torch.empty((h, lkv, d), dtype=k.dtype, device=k.device)
    err = getattr(load_library(), entry)(
        q.data_ptr(), q.stride(0), q.stride(1), q_out.data_ptr(), cos_q.data_ptr(), sin_q.data_ptr(), lq,
        k.data_ptr(), k.stride(0), k.stride(1), k_out.data_ptr(), cos.data_ptr(), sin.data_ptr(), lkv,
        h, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{build} kernel launch failed: cudaError {err}")
    LAUNCHES[build] += 1
    return q_out, k_out


def _kernel_view(g: torch.Tensor) -> torch.Tensor:
    """g as the rope kernels take it: a copy when its last dimension is not contiguous
    or its strides or base are not 16-byte aligned (a gradient may arrive in any
    layout), else g itself."""
    if g.stride(-1) != 1 or g.stride(0) % 8 or g.stride(1) % 8 or g.data_ptr() % 16:
        return g.contiguous()
    return g


def rope_rotate_backward(
    gq: torch.Tensor,
    gk: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
):
    """The rope pass's backward: (dq, dk) from the gradients of the rotated q and k,
    with the forward's tables (``cos_q``/``sin_q`` default to ``cos``/``sin``).

    CPU tensors run :func:`rope_rotate_ref_backward`. CUDA tensors launch the backward
    build of ``csrc/rope_rotate.cu`` (one launch for both), which gives what the plain
    version gives, bit for bit; a gradient whose layout the kernel cannot take is
    copied first, and anything else it cannot take raises.
    """
    cos_q = cos if cos_q is None else cos_q
    sin_q = sin if sin_q is None else sin_q
    if not gq.is_cuda:
        return rope_rotate_ref_backward(gq, cos_q, sin_q), rope_rotate_ref_backward(gk, cos, sin)
    return _rope_launch("rope_rotate_backward_bf16", "rope_rotate_backward",
                        _kernel_view(gq), _kernel_view(gk), cos, sin, cos_q, sin_q)


class RopeRotate(torch.autograd.Function):
    """The rope pass under autograd: forward :func:`rope_rotate`'s kernel (or its plain
    version on the CPU), backward :func:`rope_rotate_backward`'s. q and k get
    gradients; the tables get none."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, cos_q, sin_q):
        ctx.save_for_backward(cos, sin, cos_q, sin_q)
        if not q.is_cuda:
            return rope_rotate_ref(q, cos_q, sin_q), rope_rotate_ref(k, cos, sin)
        return _rope_launch("rope_rotate_bf16", "rope_rotate", q, k, cos, sin, cos_q, sin_q)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin, cos_q, sin_q = ctx.saved_tensors
        dq, dk = rope_rotate_backward(gq, gk, cos, sin, cos_q, sin_q)
        return dq, dk, None, None, None, None


def rope_rotate(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
):
    """The rope pass: (q rotated with ``cos_q``/``sin_q``, k rotated with ``cos``/``sin``),
    each a contiguous (H, L, D) tensor. ``cos_q``/``sin_q`` default to ``cos``/``sin``.

    CPU tensors run :func:`rope_rotate_ref`. CUDA tensors launch the kernel
    (``csrc/rope_rotate.cu``, one launch for both), which takes bf16 (H, L, 128) with a
    contiguous last dimension and contiguous (L, 128) float32 tables, and gives what
    the plain version gives, bit for bit; anything else raises. It runs through
    :class:`RopeRotate`, so gradients of q and k flow through the backward build.
    """
    cos_q = cos if cos_q is None else cos_q
    sin_q = sin if sin_q is None else sin_q
    return RopeRotate.apply(q, k, cos, sin, cos_q, sin_q)


def qknorm_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
    *,
    return_max_logit: bool = False,
    ablate_exp: bool = False,
    blocks=None,
):
    """(H, Lq, D) q × (H, Lkv, D) k/v → (H, Lq, D), q and k rotated first when
    ``cos``/``sin`` are given (see :func:`qknorm_attention_ref` for the function).

    ``return_max_logit=True`` selects the stats build and returns ``(out, max_logit)``,
    ``max_logit`` a 0-d fp32 tensor on q's device (no host sync here): the input of
    :func:`qknorm_attention_checked`. ``ablate_exp=True`` selects the measurement build
    without the exp. The two do not combine. ``blocks`` (q rows, kv rows) names the
    compiled tile (default :data:`BLOCKS`); a pair outside :data:`TILES` raises
    ValueError on both devices.

    It has no backward: asked for a gradient (grad enabled and q, k or v requiring
    one) it raises, on both devices. CPU tensors run the plain version, which has no
    tile and ignores ``blocks``. CUDA tensors launch the rope pass
    (:func:`rope_rotate`, when there are tables) and then the attention kernel at the
    tile, which takes bf16 with D = 128, a contiguous last dimension and 16-byte
    aligned strides (:func:`tma_params`); anything else raises. The output is allocated
    token-major, (Lq, H, D), and returned as its (H, Lq, D) view.
    """
    if return_max_logit and ablate_exp:
        raise ValueError("the stats and ablate_exp builds do not combine")
    tile = check_tile(BLOCKS if blocks is None else blocks)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError(
            "the max-free attention kernel has no backward: train with use_pallas=False "
            "(the rope pass and scaled_dot_product_attention, both differentiable)"
        )
    if not q.is_cuda:
        return qknorm_attention_ref(q, k, v, sm_scale, cos, sin, cos_q, sin_q,
                                    return_max_logit=return_max_logit, ablate_exp=ablate_exp)

    h, lq, d = q.shape
    lkv = k.shape[1]
    check_heads(q, k, v)
    if cos is not None:
        q, k = rope_rotate(q, k, cos, sin, cos_q, sin_q)
    maps = [(ctypes.c_int64 * 8)(*tma_params(t, rows)) for t, rows in ((q, tile[0]), (k, tile[1]), (v, tile[1]))]
    out = torch.empty((lq, h, d), dtype=q.dtype, device=q.device).transpose(0, 1)
    # a fresh zero on the launch stream: the stats build atomicMax-es into it
    max_logit = torch.zeros((), dtype=torch.float32, device=q.device) if return_max_logit else None
    err = getattr(load_library(), "qknorm_attention_bf16" + tile_suffix(tile))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *maps,
        out.stride(0), out.stride(1), h, lq, lkv, float(sm_scale),
        None if max_logit is None else max_logit.data_ptr(),
        int(ablate_exp), torch.cuda.current_stream(q.device).cuda_stream,
    )
    build = ("qknorm_attention_stats" if return_max_logit
             else "qknorm_attention_ablate_exp" if ablate_exp else "qknorm_attention")
    if err != 0:
        raise RuntimeError(f"{build} kernel launch failed: cudaError {err}")
    LAUNCHES[build] += 1
    TILE_LAUNCHES[(build, tile[:2])] += 1
    return (out, max_logit) if return_max_logit else out


def qknorm_attention_checked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
    blocks=None,
) -> torch.Tensor:
    """Guard-railed attention: runs the stats build (at the tile ``blocks``, as
    :func:`qknorm_attention`) and raises ``FloatingPointError``
    when ``max |logit|`` exceeds ``MAX_SAFE_LOGIT`` or is NaN (the regime where the
    max-free softmax would overflow exp to inf → NaN images with no diagnostic).

    It reads one scalar back per call (a host sync), so it is for validation moments
    — after a LoRA fuse or loading an unusual checkpoint — not the serving loop.
    """
    out, m = qknorm_attention(q, k, v, sm_scale, cos, sin, cos_q, sin_q, return_max_logit=True, blocks=blocks)
    m_val = float(m)
    if not (m_val <= MAX_SAFE_LOGIT):
        raise FloatingPointError(
            f"qk-norm attention logits reached |{m_val:.1f}| > safe bound "
            f"{MAX_SAFE_LOGIT}: the max-free softmax would overflow. Check qk-norm "
            "scale weights (LoRA fuse / checkpoint), or fall back to "
            "ops.attention.attention_core with use_pallas=False."
        )
    return out
