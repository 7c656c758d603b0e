"""safetensors reader and writer on torch tensors
(JAX counterpart: ``flux_fp8_api_tpu.utils.safetensors_io``).

The format: an 8-byte little-endian header length, a JSON header of
``{name: {dtype, shape, data_offsets}}`` (plus ``__metadata__``), then one flat byte
buffer. A :class:`SafetensorsFile` parses the header once and maps the file; ``get``
returns one tensor as a view over the map, so a 24 GB checkpoint is read tensor by
tensor as the loader moves each to its device, never whole. bf16 and fp8 tensors are
moved as raw bytes (a ``uint8`` view), so a file either package writes reads back
byte for byte in the other.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

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


class SafetensorsFile:
    """mmap-backed reader: ``keys()``, ``in``, ``metadata``, ``get(name)``. Tensors
    are views over the map and live on the CPU; the map stays open as long as any
    view or the file object does."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            # copy-on-write: views are writable without touching the file
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header_len = int.from_bytes(self._mm[:8], "little")
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self._entries = header
        self._data_start = 8 + header_len

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        ent = self._entries[name]
        start, end = ent["data_offsets"]
        dtype = DTYPES[ent["dtype"]]
        if end == start:
            return torch.empty(ent["shape"], dtype=dtype)
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start,
                               offset=self._data_start + start)
        return raw.view(dtype).reshape(ent["shape"])

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
