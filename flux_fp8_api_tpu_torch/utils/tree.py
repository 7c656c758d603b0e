"""``ParamTree``: an ``nn.Module`` built from a nested mapping of parameters.

The JAX package keeps each model's parameters as a nested dict (its pytree). The port
keeps the same names in modules: a mapping becomes a :class:`ParamTree` whose
submodules and buffers carry the dict's keys, a list becomes an ``nn.ModuleList``, and
a tensor becomes a buffer. Model code indexes it like the dict (``blk["img_mod_lin"]``),
so each apply function reads like its JAX counterpart.
"""

from __future__ import annotations

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
