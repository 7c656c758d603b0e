"""``ParamTree``: an ``nn.Module`` built from a nested mapping of parameters.

The JAX package keeps each model's parameters as a nested dict (its pytree). The port
keeps the same names in modules: a mapping becomes a :class:`ParamTree` whose
submodules and buffers carry the dict's keys, a list becomes an ``nn.ModuleList``, and
a tensor becomes a buffer. Model code indexes it like the dict (``blk["img_mod_lin"]``),
so each apply function reads like its JAX counterpart.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import torch
import torch.nn as nn


class ParamTree(nn.Module):
    def __init__(self, entries: Mapping[str, Any]):
        super().__init__()
        self._keys = []
        for key, value in entries.items():
            self._keys.append(key)
            if isinstance(value, nn.Module) or value is None:
                self.add_module(key, value)
            elif isinstance(value, torch.Tensor):
                self.register_buffer(key, value)
            elif isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(key, nn.ModuleList(
                    ParamTree(v) if isinstance(v, Mapping) else v for v in value
                ))
            else:
                raise TypeError(f"{key}: cannot hold {type(value).__name__} in a ParamTree")

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._keys

    def get(self, key: str, default=None):
        return getattr(self, key) if key in self._keys else default

    def items(self):
        return ((k, getattr(self, k)) for k in self._keys)


# ------------------------------------------------------------------ host ↔ device copies
#
# ``nn.Module.to`` moves a module's tensors in place. Offload needs copies beside the
# host tree instead: a block's device copy dies after its compute while the host tree
# stays as it was, so nothing ever comes back. These helpers work on any module whose
# tensors are buffers, as every tree of the port holds them.


def _moved(t: torch.Tensor, device: torch.device, non_blocking: bool, pin: bool) -> torch.Tensor:
    if device.type != "cpu":
        return t.to(device, non_blocking=non_blocking)
    if t.device.type == "cpu":
        return t.pin_memory() if pin and not t.is_pinned() else t
    if pin:  # straight into page-locked memory, one copy
        return torch.empty_like(t, device="cpu", pin_memory=True).copy_(t)
    return t.to("cpu")


def tree_to(module: nn.Module, device, non_blocking: bool = False, pin: bool = False) -> nn.Module:
    """A copy of ``module`` with every buffer on ``device``; the source is untouched.
    The copy shares the source's attributes (a Linear's ``kind``) and has its own
    submodules and buffer dicts. Tensors already where they are asked to be are
    shared, not copied. ``pin`` (host targets only) puts the host tensors in
    page-locked memory, without which a ``non_blocking`` copy to the card is
    synchronous."""
    device = torch.device(device)
    clone = copy.copy(module)
    clone._buffers = {
        k: None if v is None else _moved(v, device, non_blocking, pin) for k, v in module._buffers.items()
    }
    clone._modules = {
        k: None if m is None else tree_to(m, device, non_blocking, pin) for k, m in module._modules.items()
    }
    return clone


def copy_tree_(host: nn.Module, src: nn.Module) -> nn.Module:
    """Write ``src``'s buffers back into the host tree ``host`` of the same structure,
    in place, where both have the same shape and dtype; a buffer that ``src`` replaced
    by another (a calibrated input scale) comes to the host, pinned if the one it
    replaces was. Returns ``host``."""
    cpu = torch.device("cpu")
    for k, s in src._buffers.items():
        d = host._buffers.get(k)
        if s is None or d is None or d.shape != s.shape or d.dtype != s.dtype:
            host._buffers[k] = None if s is None else _moved(s, cpu, False, d is not None and d.is_pinned())
        else:
            d.copy_(s)
    for k, m in src._modules.items():
        if m is not None:
            copy_tree_(host._modules[k], m)
    return host


def tree_nbytes(module: nn.Module) -> int:
    return sum(b.numel() * b.element_size() for b in module.buffers())


def pin_tree_(module: nn.Module) -> None:
    """Put every host buffer of the tree that is not in page-locked memory there, in
    place (a LoRA fuse replaces the Linears it touches by unpinned ones)."""
    for m in module.modules():
        for k, b in m._buffers.items():
            if b is not None and b.device.type == "cpu" and not b.is_pinned():
                m._buffers[k] = b.pin_memory()
