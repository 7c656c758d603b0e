"""Max-free qk-norm attention: the hand-written CUDA kernel, its plain PyTorch
version, the wrapper that picks between them by device, and the kernel's build.

JAX counterpart: ``flux_fp8_api_tpu.ops.attention_kernel.qknorm_attention`` (the Pallas
TPU kernel, serving build), whose docstring argues why FLUX's qk-RMSNorm makes a
constant-shift softmax safe: ``p = exp(s - SHIFT)``, ``out = Σp·v / Σp``.

The CUDA source is ``csrc/qknorm_attention.cu``. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``build/kernels/<hash of the sources>/`` at the repository root, and loaded with
``ctypes``.
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
HEAD_DIM = 128  # the only head dim the CUDA kernel takes

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("qknorm_attention.cu",)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"

# Launch count of the CUDA kernel: the wrapper adds one per launch and nowhere else.
# Drivers reset it to 0 before a run and read it after, to show the path used it.
LAUNCHES = {"qknorm_attention": 0}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the attention kernel is built with the CUDA toolkit")


def library_path() -> Path:
    """Where the built library lives: keyed by a hash of the kernel sources."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libflux_kernels.so"


def build_library() -> Path:
    """Compile the kernel sources for sm_90a if this source hash has no library yet.
    Returns the library's path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
        *[str(_CSRC / s) for s in _SOURCES],
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (out.parent / "ptxas.log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.qknorm_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def qknorm_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same function with the same roundings
    — rope in fp32 cast back to q's dtype, fp32 logits, ``exp(s·scale − SHIFT)``,
    ``bf16(p)`` before ``P·V``, den from the unrounded p, den clamped at 1e-30.

    q (H, Lq, D), k/v (H, Lkv, D); cos/sin (Lkv, D) fp32, cos_q/sin_q (Lq, D)
    defaulting to cos/sin. Returns (H, Lq, D) in q's dtype.
    """
    if cos is not None:
        cos_q = cos if cos_q is None else cos_q
        sin_q = sin if sin_q is None else sin_q
        q = _rotate(q, cos_q, sin_q)
        k = _rotate(k, cos, sin)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp(s * sm_scale - SHIFT)
    den = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return (acc / torch.clamp(den, min=1e-30)).to(q.dtype)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    half = x32.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos.float() + rotated * sin.float()).to(x.dtype)


def _check_table(t: torch.Tensor, rows: int, name: str) -> None:
    if t.shape != (rows, HEAD_DIM) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({rows}, {HEAD_DIM}) float32 table")


def qknorm_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    cos_q: Optional[torch.Tensor] = None,
    sin_q: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(H, Lq, D) q × (H, Lkv, D) k/v → (H, Lq, D), with the rope rotation fused in
    when ``cos``/``sin`` are given (see :func:`qknorm_attention_ref` for the function).

    CPU tensors run the plain version. CUDA tensors launch the kernel, which takes bf16
    with D = 128 and a contiguous last dimension; anything else raises. The output is
    allocated token-major, (Lq, H, D), and returned as its (H, Lq, D) view.
    """
    if not q.is_cuda:
        return qknorm_attention_ref(q, k, v, sm_scale, cos, sin, cos_q, sin_q)

    h, lq, d = q.shape
    lkv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on {q.device}, got {t.dtype} on {t.device}")
        if t.dim() != 3 or t.shape[0] != h or t.shape[2] != HEAD_DIM:
            raise ValueError(f"{name} must be (H={h}, L, {HEAD_DIM}), got {tuple(t.shape)}")
        if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned last dimension")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    tables = [None] * 4
    if cos is not None:
        cos_q = cos if cos_q is None else cos_q
        sin_q = sin if sin_q is None else sin_q
        for name, t, rows in (("cos_q", cos_q, lq), ("sin_q", sin_q, lq), ("cos", cos, lkv), ("sin", sin, lkv)):
            _check_table(t, rows, name)
            if t.device != q.device:
                raise ValueError(f"{name} must be on {q.device}")
        tables = [cos_q.data_ptr(), sin_q.data_ptr(), cos.data_ptr(), sin.data_ptr()]

    out = torch.empty((lq, h, d), dtype=q.dtype, device=q.device).transpose(0, 1)
    err = _library().qknorm_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *tables,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        h, lq, lkv, float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attention kernel launch failed: cudaError {err}")
    LAUNCHES["qknorm_attention"] += 1
    return out
