"""Quantization grids of the reference, emulated in float32.

- ``fp8``: the configuration's flow tier (BFL flux-fp8-api ``float8_quantize.py``):
  an e4m3 weight with one scale ``min(448 / amax, 448)`` per tensor, and an e5m2
  activation with one static scale ``min(57344 / amax, 57344)`` from the calibrated
  input amax; product in float32, then ``/ (in_scale · w_scale)`` and the bias.
- ``int4``: the same recipe on the symmetric int4 grid (``7 / amax``, round half to
  even), weights and activations: the control of ``fp8``.
- ``wo_fp8`` / ``wo_int4``: weight-only, one scale per output channel (e4m3 with the
  fp8 law; int4 with ``7 / amax``): the text encoders' tier and its control.
- ``none``: the float weight.
"""

from __future__ import annotations

from typing import Optional

import torch

E4M3_MAX, E5M2_MAX, INT4_MAX = 448.0, 57344.0, 7.0


def fp8_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    amax = torch.clamp(amax.float(), min=1e-12)
    return torch.clamp(amax.new_tensor(qmax) / amax, max=qmax)


def int_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    amax = torch.clamp(amax.float(), min=1e-12)
    return amax.new_tensor(qmax) / amax


def round_fp8(x: torch.Tensor, scale: torch.Tensor, qmax: float, dtype) -> torch.Tensor:
    """x on the grid of ``dtype`` after ``scale``, as float32 (not yet unscaled)."""
    return torch.clamp(x.float() * scale, -qmax, qmax).to(dtype).float()


def round_int(x: torch.Tensor, scale: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.round(torch.clamp(x.float() * scale, -qmax, qmax))


class QLinear:
    """One linear layer of the reference. ``grid`` as in the module docstring. Weights
    are kept rounded (fp8 or int8 storage) and widened to float32 at each call; the
    activation grids need ``set_input_amax`` (calibration) before they round."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor], grid: str):
        self.grid = grid
        self.bias = None if bias is None else bias.float()
        w = weight.float()
        if grid == "none":
            self.w, self.w_inv = weight, None
        elif grid == "fp8":
            s = fp8_scale(w.abs().max(), E4M3_MAX)
            self.w, self.w_inv = round_fp8(w, s, E4M3_MAX, torch.float8_e4m3fn).to(torch.float8_e4m3fn), 1.0 / s
        elif grid == "int4":
            s = int_scale(w.abs().max(), INT4_MAX)
            self.w, self.w_inv = round_int(w, s, INT4_MAX).to(torch.int8), 1.0 / s
        elif grid == "wo_fp8":
            s = fp8_scale(w.abs().amax(dim=1), E4M3_MAX)
            q = torch.clamp(w * s[:, None], -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)
            self.w, self.w_inv = q, (1.0 / s)[:, None]
        elif grid == "wo_int4":
            s = int_scale(w.abs().amax(dim=1), INT4_MAX)
            self.w, self.w_inv = round_int(w, s[:, None], INT4_MAX).to(torch.int8), (1.0 / s)[:, None]
        else:
            raise ValueError(f"unknown grid {grid!r}")
        self.in_scale = torch.ones((), device=weight.device)
        self.amax: Optional[torch.Tensor] = None
        self.collect = False

    def weight(self) -> torch.Tensor:
        """The float32 weight the product uses."""
        if self.grid == "none":
            return self.w.float()
        if self.grid in ("wo_fp8", "wo_int4"):
            return self.w.float() * self.w_inv
        return self.w.float()

    def set_input_amax(self, amax: torch.Tensor) -> None:
        self.in_scale = fp8_scale(amax, E5M2_MAX) if self.grid == "fp8" else int_scale(amax, INT4_MAX)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.collect:
            a = x.abs().max()
            self.amax = a if self.amax is None else torch.maximum(self.amax, a)
        if self.grid == "fp8":
            xq = round_fp8(x, self.in_scale, E5M2_MAX, torch.float8_e5m2)
            out = (xq @ self.weight().t()) * ((1.0 / self.in_scale) * self.w_inv)
        elif self.grid == "int4":
            xq = round_int(x, self.in_scale, INT4_MAX)
            out = (xq @ self.weight().t()) * ((1.0 / self.in_scale) * self.w_inv)
        else:
            out = x @ self.weight().t()
        return out if self.bias is None else out + self.bias
