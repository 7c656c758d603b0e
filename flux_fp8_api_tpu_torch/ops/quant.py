"""Quantized linear layers and per-tensor scale math
(JAX counterpart: ``flux_fp8_api_tpu.ops.quant``).

A :class:`Linear` is an ``nn.Module`` whose buffers hold either a float weight or fp8
data plus scales. Weights are torch's (out_features, in_features); the JAX package
stores (in, out), and ``utils/convert.py`` transposes.

Kinds this port runs:

- ``float``: ``weight`` (+ ``bias``).
- ``fp8``: ``q`` e4m3 with scalar ``w_scale``/``in_scale`` and their reciprocals. The
  activation is saturated to e5m2 with the input scale and multiplied on the card by
  ``torch._scaled_mm`` — the reference's own op (float8_quantize.py:284-292), with
  ``ModelSpec.fp8_fast_accum`` as its ``use_fast_accum``. On the CPU the same product
  is computed in fp32 from the dequantized operands.
- ``wo_fp8``: weight-only e4m3 with per-out-channel scales (the text encoders'
  ``qfloat8`` tier); activations stay in the compute dtype.

Scale semantics match the reference (float8_quantize.py:214-218): ``amax_to_scale``
clamps, ``to_fp8_saturated`` clips before the cast.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

WEIGHT_F8_DTYPE = torch.float8_e4m3fn
INPUT_F8_DTYPE = torch.float8_e5m2
F8_WEIGHT_MAX = float(torch.finfo(WEIGHT_F8_DTYPE).max)  # 448.0
F8_INPUT_MAX = float(torch.finfo(INPUT_F8_DTYPE).max)  # 57344.0


def amax_to_scale(amax: torch.Tensor, max_val: float) -> torch.Tensor:
    """``min(max_val / max(amax, 1e-12), max_val)`` in fp32 (float8_quantize.py:214-215).
    A tensor numerator: ``float / tensor`` is a reciprocal and a product in torch, which
    can land one ulp from the correctly rounded quotient."""
    amax = torch.clamp(amax.float(), min=1e-12)
    return torch.clamp(amax.new_tensor(max_val) / amax, max=max_val)


def to_fp8_saturated(x: torch.Tensor, scale: torch.Tensor, max_val: float) -> torch.Tensor:
    """Scale into the fp8 range and saturate (float8_quantize.py:217-218); the caller
    casts to the fp8 storage dtype."""
    return torch.clamp(x * scale, -max_val, max_val)


class Linear(nn.Module):
    """One linear layer's parameters, held as buffers (nothing here trains)."""

    def __init__(
        self,
        kind: str = "float",
        weight: Optional[torch.Tensor] = None,
        q: Optional[torch.Tensor] = None,
        w_scale: Optional[torch.Tensor] = None,
        w_scale_inv: Optional[torch.Tensor] = None,
        in_scale: Optional[torch.Tensor] = None,
        in_scale_inv: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        if kind not in ("float", "fp8", "wo_fp8"):
            raise ValueError(f"unsupported Linear kind {kind!r}")
        self.kind = kind
        self.register_buffer("weight", weight)
        self.register_buffer("q", q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("w_scale_inv", w_scale_inv)
        self.register_buffer("in_scale", in_scale)
        self.register_buffer("in_scale_inv", in_scale_inv)
        self.register_buffer("bias", bias)

    def extra_repr(self) -> str:
        w = self.weight if self.weight is not None else self.q
        return f"kind={self.kind}, (out, in)={tuple(w.shape)}"


def quantize_linear_fp8(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    """Float (out, in) weight → fp8 Linear with a per-tensor scale (reference
    ``quantize_weight``, float8_quantize.py:195-207). ``in_scale`` starts at 1.0;
    calibration replaces it."""
    w32 = weight.float()
    scale = amax_to_scale(w32.abs().max(), F8_WEIGHT_MAX)
    q = to_fp8_saturated(w32, scale, F8_WEIGHT_MAX).to(WEIGHT_F8_DTYPE)
    one = torch.ones((), dtype=torch.float32, device=weight.device)
    return Linear("fp8", q=q, w_scale=scale, w_scale_inv=1.0 / scale,
                  in_scale=one, in_scale_inv=one.clone(), bias=bias)


def quantize_linear_wo_fp8(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    """Per-out-channel e4m3 weight-only quantization."""
    w32 = weight.float()
    scale = amax_to_scale(w32.abs().amax(dim=1), F8_WEIGHT_MAX)  # (out,)
    q = torch.clamp(w32 * scale[:, None], -F8_WEIGHT_MAX, F8_WEIGHT_MAX).to(WEIGHT_F8_DTYPE)
    return Linear("wo_fp8", q=q, w_scale=scale, w_scale_inv=1.0 / scale, bias=bias)


WO_QUANTIZERS = {"qfloat8": quantize_linear_wo_fp8}


def with_input_scale(lin: Linear, amax: torch.Tensor) -> Linear:
    """Set the tuned input scale from a calibrated running amax, in place (reference
    ``quantize_input`` freeze path, float8_quantize.py:238-246). Only ``fp8`` leaves
    quantize activations; other kinds are returned unchanged."""
    if lin.kind == "fp8":
        scale = amax_to_scale(amax.to(lin.in_scale.device), F8_INPUT_MAX)
        lin.in_scale = scale
        lin.in_scale_inv = 1.0 / scale
    return lin


def linear_apply(
    lin: Linear,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    collect_amax: bool = False,
    fast_accum: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply a linear layer; with ``collect_amax`` also return max|x| (fp32 scalar)
    for scale calibration. ``fast_accum`` is ``_scaled_mm``'s ``use_fast_accum`` for
    the ``fp8`` kind on the card."""
    amax = x.abs().max().float() if collect_amax else None
    return _linear_base(lin, x, compute_dtype, fast_accum), amax


def fp8_linear_ref(lin: Linear, x8: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Plain version of the ``fp8`` product on an e5m2 activation: fp8 values are exact
    in fp32, so this is one fp32 product with the scale and bias epilogue."""
    out = torch.matmul(x8.float(), lin.q.float().t()) * (lin.in_scale_inv * lin.w_scale_inv)
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(compute_dtype)


def _linear_base(lin: Linear, x: torch.Tensor, compute_dtype, fast_accum: bool) -> torch.Tensor:
    if lin.kind == "float":
        bias = None if lin.bias is None else lin.bias.to(compute_dtype)
        return F.linear(x.to(compute_dtype), lin.weight.to(compute_dtype), bias)

    if lin.kind == "fp8":
        x8 = to_fp8_saturated(x.float(), lin.in_scale, F8_INPUT_MAX).to(INPUT_F8_DTYPE)
        if x.is_cuda:
            lead = x8.shape[:-1]
            out = torch._scaled_mm(
                x8.reshape(-1, x8.shape[-1]),
                lin.q.t(),
                scale_a=lin.in_scale_inv,
                scale_b=lin.w_scale_inv,
                bias=None if lin.bias is None else lin.bias.to(compute_dtype),
                out_dtype=compute_dtype,
                use_fast_accum=fast_accum,
            )
            return out.reshape(*lead, out.shape[-1])
        return fp8_linear_ref(lin, x8, compute_dtype)

    # wo_fp8: dequantize the weight into the compute dtype, full-precision activations
    w = lin.q.to(compute_dtype) * lin.w_scale_inv.to(compute_dtype)[:, None]
    bias = None if lin.bias is None else lin.bias.to(compute_dtype)
    return F.linear(x.to(compute_dtype), w, bias)
