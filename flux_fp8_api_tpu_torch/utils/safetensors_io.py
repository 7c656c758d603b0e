"""safetensors reader and writer on torch tensors
(JAX counterpart: ``flux_fp8_api_tpu.utils.safetensors_io``).

The format: an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}`` (plus ``__metadata__``), then one flat byte
buffer. A :class:`SafetensorsFile` parses the header once and maps the file; ``get``
returns one tensor as a view over the map, so a 24 GB checkpoint is read tensor by
tensor as the loader moves each to its device, never whole. bf16 and fp8 tensors are
moved as raw bytes (a ``uint8`` view), so a file either package writes reads back
byte for byte in the other.

With ``use_native=True`` tensors of ``_NATIVE_READ_THRESHOLD`` bytes and more read
through the native reader (``utils/native_io.py``: parallel ``pread`` outside the GIL,
after a prefetch hint), as the JAX package's do by default, into a fresh host tensor
with the same bytes; where that reader is unavailable they read through the map. The
port's default is the map: on the host of an NVIDIA H100 80GB HBM3 (700 W), with the
12 GB flow file in the page cache, the native reader ran at 2.5-3.0 GB/s against the
map's 3.6-4.6 GB/s (chip_smoke phase 19(d)). :data:`READS` counts the large reads by reader, and the reader taken is logged
once.
"""

from __future__ import annotations

import json
import logging
import mmap
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from . import native_io

logger = logging.getLogger(__name__)

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

_NATIVE_READ_THRESHOLD = 64 << 20  # tensors of 64 MiB and more go through the native reader
# reads of tensors at or above the threshold, by the reader that served them
READS = {"native": 0, "mmap": 0}
_logged = set()


def _log_reader(reader: str) -> None:
    if reader not in _logged:
        _logged.add(reader)
        if reader == "native":
            logger.info("safetensors: tensors of %d MiB and more read through the native parallel reader "
                        "(csrc/stload.cpp)", _NATIVE_READ_THRESHOLD >> 20)
        else:
            logger.info("safetensors: the native reader is unavailable (no g++, or its build failed): "
                        "large tensors read through the mmap")


class SafetensorsFile:
    """Reader: ``keys()``, ``in``, ``metadata``, ``get(name)``, on the CPU. Tensors
    are views over a map of the file, which stays open as long as any view or the file
    object does; with ``use_native`` (off by default here, on in JAX's
    ``SafetensorsFile``) tensors of 64 MiB and more are read by the native reader into
    fresh tensors instead, after a prefetch hint for the whole file."""

    def __init__(self, path, use_native: bool = False):
        self.path = Path(path)
        self.use_native = use_native
        with open(self.path, "rb") as f:
            # copy-on-write: views are writable without touching the file
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header_len = int.from_bytes(self._mm[:8], "little")
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries = header
        self._data_start = 8 + header_len
        if use_native:
            native_io.prefetch(self.path)

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str, index: Optional[int] = None) -> torch.Tensor:
        """Tensor ``name``; with ``index``, only ``tensor[index]`` along its leading axis
        (one block of a stacked leaf), whose bytes alone are read. Whether the native
        reader reads them is decided by the whole tensor's size, as in JAX."""
        ent = self._entries[name]
        start, end = ent["data_offsets"]
        dtype = DTYPES[ent["dtype"]]
        shape = list(ent["shape"])
        big = end - start >= _NATIVE_READ_THRESHOLD
        if index is not None:
            rows = shape[0]
            if not -rows <= index < rows:
                raise IndexError(f"{name}: index {index} of {rows} rows")
            step = (end - start) // rows
            start += (index % rows) * step
            end, shape = start + step, shape[1:]
        if end == start:
            return torch.empty(shape, dtype=dtype)
        raw = None
        if big:
            if self.use_native:
                raw = native_io.parallel_read(self.path, self._data_start + start, end - start)
            reader = "mmap" if raw is None else "native"
            READS[reader] += 1
            if self.use_native:
                _log_reader(reader)
        if raw is None:
            raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start,
                                   offset=self._data_start + start)
        return raw.view(dtype).reshape(shape)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for k in self.keys():
            yield k, self.get(k)


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, as views over its map."""
    return dict(SafetensorsFile(path).items())


def save_safetensors(path, tensors: Dict[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a safetensors file, one tensor at a time: a tensor on the card is copied
    to the host alone, so peak host memory is the largest tensor, not the file."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * ((8 - len(hjson) % 8) % 8)  # 8-byte alignment of the data
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
