"""JAX parameters (as numpy arrays) → the port's modules.

The input is a nested dict mirroring a JAX parameter tree, in which each JAX
``ops.quant.Linear`` appears as a plain dict of numpy arrays plus ``"kind"``, so this
module never imports the JAX package. The conversion:

- transposes Linear kernels and quantized data from JAX's (in, out) to torch's
  (out, in): a plain transpose carries every kind byte for byte, the packed int4
  half-split pairing and the wo_int4/wo_int2 consecutive packing included (their
  layouts are in ``ops/quant.py``), as do the blockwise scales' (nblocks, out);
- moves fp8 and bf16 bytes exactly (a ``uint8``/``int16`` view on the numpy side, a
  dtype view on the torch side);
- splits the depth-stacked leaves under ``double_blocks``, ``single_blocks`` and
  ``blocks`` into per-block modules, carrying per-block scales with their block;
- turns 4-D conv kernels (HWIO) into torch's OIHW ``weight``.

:func:`convert_adapters` carries the JAX package's trainable LoRA adapters across:
stacked ``{"a": (D, in, r), "b": (D, r, out)}`` per leaf become per-block (r, in) /
(out, r) tensors, the layout of ``lora.init_lora_adapters``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..ops.quant import Linear
from .tree import ParamTree

STACKED_KEYS = ("double_blocks", "single_blocks", "blocks")

_VIEWS = {
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
    "bfloat16": (np.int16, torch.bfloat16),
}


def to_tensor(arr, device=None) -> torch.Tensor:
    """numpy array (including ml_dtypes bf16/fp8) → torch tensor with identical bytes."""
    arr = np.array(arr, order="C")  # an owned, writable, C-contiguous copy
    view = _VIEWS.get(arr.dtype.name)
    if view is not None:
        np_view, torch_dtype = view
        t = torch.from_numpy(arr.view(np_view)).view(torch_dtype)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def _linear(d: Mapping[str, Any], device) -> Linear:
    def get(name, transpose=False):
        a = d.get(name)
        if a is None:
            return None
        a = np.asarray(a)
        return to_tensor(a.swapaxes(-1, -2) if transpose else a, device)

    kind = d["kind"]
    if kind == "float":
        return Linear("float", weight=get("kernel", True), bias=get("bias"))
    # blockwise weight-only scales are (nblocks, out) in JAX, (out, nblocks) here
    blockwise = kind in ("wo_int4", "wo_int2")
    return Linear(
        kind,
        q=get("q", True),
        w_scale=get("w_scale"),
        w_scale_inv=get("w_scale_inv", blockwise),
        in_scale=get("in_scale"),
        in_scale_inv=get("in_scale_inv"),
        bias=get("bias"),
    )


def _index(tree: Any, i: int) -> Any:
    """Block i of a depth-stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: (v if k == "kind" else _index(v, i)) for k, v in tree.items()}
    if tree is None:
        return None
    return np.asarray(tree)[i]


def _depth(tree: Any) -> int:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            if k != "kind" and v is not None:
                return _depth(v)
        raise ValueError("empty stacked subtree")
    return np.asarray(tree).shape[0]


def convert(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays → ParamTree / nn.ModuleList / Linear / tensor."""
    if isinstance(tree, Mapping):
        if "kind" in tree:
            return _linear(tree, device)
        out = {}
        for key, value in tree.items():
            if key in STACKED_KEYS and isinstance(value, Mapping):
                n = _depth(value)
                out[key] = torch.nn.ModuleList(convert(_index(value, i), device) for i in range(n))
            elif key == "kernel" and np.asarray(value).ndim == 4:
                out["weight"] = to_tensor(np.asarray(value).transpose(3, 2, 0, 1), device)
            else:
                out[key] = convert(value, device)
        return ParamTree(out)
    if isinstance(tree, (list, tuple)):
        return torch.nn.ModuleList(convert(v, device) for v in tree)
    if tree is None:
        return None
    return to_tensor(tree, device)


def convert_adapters(tree: Mapping[str, Any], device=None):
    """JAX adapters ``{stack: {leaf: {"a": (D, in, r), "b": (D, r, out)}}}`` (numpy) →
    ``{stack: [{leaf: {"a": (r, in), "b": (out, r)}} per block]}`` with the same bytes,
    each tensor a leaf that requires grad."""
    out = {}
    for stack, leaves in tree.items():
        depth = _depth(leaves)
        out[stack] = [
            {
                name: {
                    k: to_tensor(np.asarray(ab[k])[i].T, device).requires_grad_()
                    for k in ("a", "b")
                }
                for name, ab in leaves.items()
            }
            for i in range(depth)
        ]
    return out
