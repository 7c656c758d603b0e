"""fp8 input-scale calibration (JAX counterpart: ``flux_fp8_api_tpu.calibration``).

The protocol is the JAX package's: run the model with ``collect_amax=True``, fold the
amaxes into a running elementwise max across trials, and write the tuned input scales
into the quantized linears. Here the write is in place on the model's buffers.

Under a mesh each rank sees part of every activation: a row-parallel linear its slice
of the features, a dp rank its batch rows. :func:`reduce_amaxes` takes the MAX over
the whole mesh before the scales are frozen, as GSPMD's reduction does for the JAX
package, so every rank freezes one rank's ``in_scale`` (without it each rank would
freeze its own, and the image would silently differ).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .ops.quant import Linear, with_input_scale
from .utils.tree import ParamTree


def merge_amax(running: Optional[Dict[str, Any]], new: Dict[str, Any]) -> Dict[str, Any]:
    """Elementwise running max across calibration trials (float8_quantize.py:225-237)."""
    if running is None:
        return new
    return {
        k: merge_amax(running[k], v) if isinstance(v, dict) else torch.maximum(running[k], v)
        for k, v in new.items()
    }


def reduce_amaxes(amaxes: Dict[str, Any], mesh) -> Dict[str, Any]:
    """The amax tree with every entry the MAX over the whole mesh: one all-reduce of
    all entries flattened together."""
    if mesh is None or mesh.world == 1:
        return amaxes
    flat: list = []

    def collect(tree):
        for v in tree.values():
            collect(v) if isinstance(v, dict) else flat.append(v.float().reshape(-1))

    collect(amaxes)
    merged = mesh.all_reduce_max(torch.cat(flat), None)
    offset = 0

    def rebuild(tree):
        nonlocal offset
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = rebuild(v)
            else:
                out[k] = merged[offset:offset + v.numel()].reshape(v.shape)
                offset += v.numel()
        return out

    return rebuild(amaxes)


def apply_input_scales(model: ParamTree, amaxes: Dict[str, Any]) -> ParamTree:
    """Write tuned input scales into every quantized Linear of the flux model, in place.

    ``amaxes`` follows ``flux_apply(collect_amax=True)``'s naming: dotted top-level
    keys (``"img_in"``, ``"time_in.in_layer"``, ``"final_layer.linear"``) plus
    ``"double_blocks"``/``"single_blocks"`` dicts of (depth,) tensors, entry i for
    block i.
    """

    def walk(subtree, prefix: str):
        for key, value in subtree.items():
            if isinstance(value, Linear):
                amax = amaxes.get(f"{prefix}{key}")
                if amax is not None and value.kind != "float":
                    with_input_scale(value, amax)
            elif isinstance(value, ParamTree):
                walk(value, f"{prefix}{key}.")

    for name in ("img_in", "txt_in", "time_in", "vector_in", "guidance_in", "final_layer"):
        sub = model.get(name)
        if isinstance(sub, Linear):
            amax = amaxes.get(name)
            if amax is not None and sub.kind != "float":
                with_input_scale(sub, amax)
        elif sub is not None:
            walk(sub, f"{name}.")

    for stack in ("double_blocks", "single_blocks"):
        stack_amax = amaxes.get(stack) or {}
        for i, blk in enumerate(model[stack]):
            for key, value in blk.items():
                if isinstance(value, Linear) and value.kind != "float" and key in stack_amax:
                    with_input_scale(value, stack_amax[key][i])
    return model
