"""ctypes bridge to the checkpoint reader's C++ data plane, ``csrc/stload.cpp``
(JAX counterpart: ``flux_fp8_api_tpu.utils.native_io``, whose source is the JAX
package's ``native/stload.cpp``; the port builds its own copy and never writes into
``native/``).

The library is built with ``g++`` at first use into ``build/native/<hash of the
source>/libstload.so`` at the repository root, so a changed source builds anew and a
stale library is never loaded. Where there is no toolchain, or the build or the ABI
check fails, :func:`get_lib` returns None, :func:`parallel_read` None and
:func:`prefetch` False, and ``utils/safetensors_io.py`` reads through its mmap: the
bytes are the same either way (host I/O, not a device kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "stload.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
ABI_VERSION = 1  # stload_abi_version() of the source this bridge is written for

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the built library lives: keyed by a hash of the source."""
    return BUILD_ROOT / hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16] / "libstload.so"


def _build(out: Path) -> bool:
    """``g++`` the source into ``out`` (through a temporary file in its directory, so
    concurrent builds never load a half-written library). False where it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            so = Path(tmp) / out.name
            subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-pthread", "-o", str(so), str(_SRC)],
                           check=True, capture_output=True, timeout=120)
            os.replace(so, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built first where needed; None where it is unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.stload_read.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
        lib.stload_read.restype = ctypes.c_int
        lib.stload_prefetch.argtypes = [ctypes.c_char_p]
        lib.stload_prefetch.restype = ctypes.c_int
        lib.stload_abi_version.restype = ctypes.c_int
        if lib.stload_abi_version() != ABI_VERSION:
            return None
        _lib = lib
        return _lib


def parallel_read(path, offset: int, size: int, n_threads: int = 16) -> Optional[torch.Tensor]:
    """Bytes ``[offset, offset + size)`` of the file at ``path`` as a new ``uint8``
    tensor on the host, read by ``n_threads`` parallel ``pread`` calls outside the GIL.
    None where the library is unavailable (the caller reads through its mmap); an
    OSError where the read fails."""
    lib = get_lib()
    if lib is None:
        return None
    buf = torch.empty(size, dtype=torch.uint8)
    rc = lib.stload_read(str(path).encode(), offset, size, ctypes.c_void_p(buf.data_ptr()), n_threads)
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc), str(path))
    return buf


def prefetch(path) -> bool:
    """Advise the kernel to read the whole file ahead (``posix_fadvise`` WILLNEED).
    False where the library is unavailable or the file cannot be opened."""
    lib = get_lib()
    if lib is None:
        return False
    return lib.stload_prefetch(str(path).encode()) == 0
