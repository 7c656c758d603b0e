"""Quantized linear layers and per-tensor scale math
(JAX counterpart: ``flux_fp8_api_tpu.ops.quant``).

A :class:`Linear` is an ``nn.Module`` whose buffers hold either a float weight or
quantized data plus scales. Weights are torch's (out_features, in_features); the JAX
package stores (in, out), and ``utils/convert.py`` transposes.

Kinds and their layouts here:

- ``float``: ``weight`` (out, in) (+ ``bias``).
- ``fp8``: ``q`` (out, in) e4m3 with scalar ``w_scale``/``in_scale`` and their
  reciprocals. The activation is saturated to e5m2 with the input scale and multiplied
  on the card by ``torch._scaled_mm`` — the reference's own op
  (float8_quantize.py:284-292), with ``ModelSpec.fp8_fast_accum`` as its
  ``use_fast_accum``. On the CPU the same product is computed in fp32 from the
  dequantized operands.
- ``int8``: ``q`` (out, in) int8, per-out-channel ``w_scale``/``w_scale_inv`` (out,),
  scalar ``in_scale``. The activation is quantized in bf16 to int8 and multiplied by
  ``torch._int_mm`` on the card; the epilogue dequantizes by the reciprocal of the
  bf16-rounded input scale actually applied.
- ``int4``: ``q`` (out, in/2) uint8, offset-binary nibbles (q + 7) with the JAX
  package's HALF-SPLIT pairing along the in axis: byte [o, i] holds element i in its
  low nibble and element i + in/2 in its high one. The JAX (in/2, out) array
  transposes into this layout byte for byte. It runs as ``int8`` after unpacking.
- ``wo_fp8`` / ``wo_int8``: weight-only, ``q`` (out, in) e4m3 / int8 with
  per-out-channel scales; activations stay in the compute dtype (text-encoder tiers).
- ``wo_int4`` / ``wo_int2``: weight-only blockwise, ``q`` (out, in·bits/8) uint8 with
  CONSECUTIVE in-elements packed low bits first (offset-binary, q + qmax), and
  ``w_scale_inv`` (out, nblocks): blocks of 64 along in, or one block spanning the
  row when 64 does not divide in. Both are the JAX arrays transposed.

Any kind may carry a trainable low-rank adapter, ``lora_a`` (r, in) and ``lora_b``
(out, r) in torch's ``lora_down``/``lora_up`` convention, applied as a side branch
``(x·Aᵀ)·Bᵀ`` (QLoRA training, JAX quant.py:509-519); both are None on a served tree.
``linear_apply(..., dequant=True)`` runs the quantized-activation kinds as a
differentiable dequantize and bf16 product instead (JAX quant.py:522-534): the
serving kinds round the activation, which has no gradient.

A Linear sharded over a tensor-parallel mesh (``parallel/mesh.py``) carries its
``shard``: a column-parallel one computes its out-slice (the modulation linears then
all-gather it), a row-parallel one all-reduces its partial product over tp before
the epilogue and adds the bias once, after the reduction: the int32 partials on the
int tiers (the exact sum, so the result is one rank's bit for bit), fp32 partials on
fp8, float and the weight-only kinds, cast once.

Scale semantics match the reference (float8_quantize.py:214-218) for fp8 and the JAX
package's 127/amax law for the int kinds; every quantizer gives the bytes and scales
the JAX package serves (its flow quantize and calibration run jitted, see
``_int_scales``; its text-encoder tiers run eagerly).
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
INT8_MAX = 127.0
INT4_MAX = 7.0
WO_BLOCK = 64  # block size along in_features of the wo_int4 / wo_int2 scales

KINDS = ("float", "fp8", "int8", "int4", "wo_fp8", "wo_int8", "wo_int4", "wo_int2")
# kinds whose activations are quantized, and so carry a calibrated input scale
ACTIVATION_KINDS = ("fp8", "int8", "int4")
# ``torch._int_mm`` on the card refuses M <= 16 rows; smaller products are padded
INT_MM_MIN_ROWS = 17


def amax_to_scale(amax: torch.Tensor, max_val: float) -> torch.Tensor:
    """``min(max_val / max(amax, 1e-12), max_val)`` in fp32 (float8_quantize.py:214-215).
    A tensor numerator: ``float / tensor`` is a reciprocal and a product in torch, which
    can land one ulp from the correctly rounded quotient."""
    amax = torch.clamp(amax.float(), min=1e-12)
    return torch.clamp(amax.new_tensor(max_val) / amax, max=max_val)


def int8_amax_to_scale(amax: torch.Tensor) -> torch.Tensor:
    """Unclamped symmetric int8 scale ``127 / max(amax, 1e-12)`` (JAX quant.py:53)."""
    amax = torch.clamp(amax.float(), min=1e-12)
    return amax.new_tensor(INT8_MAX) / amax


def _int_scales(amax: torch.Tensor, qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, scale_inv) of a flow int kind: ``qmax / a`` and ``a · fl(1/qmax)`` with
    a = max(amax, 1e-12). The reciprocal is formed as XLA forms it inside the JAX
    package's jitted quantize and calibration (it rewrites 1/(c/a) into a·(1/c)), so
    the port's scales are the ones the JAX package serves and saves; an exact
    reciprocal can differ by one ulp."""
    amax = torch.clamp(amax.float(), min=1e-12)
    return amax.new_tensor(qmax) / amax, amax * (amax.new_tensor(1.0) / amax.new_tensor(qmax))


def to_fp8_saturated(x: torch.Tensor, scale: torch.Tensor, max_val: float) -> torch.Tensor:
    """Scale into the fp8 range and saturate (float8_quantize.py:217-218); the caller
    casts to the fp8 storage dtype."""
    return torch.clamp(x * scale, -max_val, max_val)


class Linear(nn.Module):
    """One linear layer's parameters, held as buffers. Nothing of the base trains; the
    adapters ``lora_a``/``lora_b`` are None except on the trainer's merged copy
    (``lora.merge_lora_adapters``)."""

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
        lora_a: Optional[torch.Tensor] = None,
        lora_b: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unsupported Linear kind {kind!r}")
        self.kind = kind
        self.register_buffer("weight", weight)
        self.register_buffer("q", q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("w_scale_inv", w_scale_inv)
        self.register_buffer("in_scale", in_scale)
        self.register_buffer("in_scale_inv", in_scale_inv)
        self.register_buffer("bias", bias)
        self.register_buffer("lora_a", lora_a)
        self.register_buffer("lora_b", lora_b)
        # parallel.mesh.LinearShard of a tensor-parallel slice; None: the whole layer
        self.shard = None

    @property
    def in_features(self) -> int:
        w = self.weight if self.weight is not None else self.q
        return w.shape[-1] * {"int4": 2, "wo_int4": 2, "wo_int2": 4}.get(self.kind, 1)

    def extra_repr(self) -> str:
        w = self.weight if self.weight is not None else self.q
        return f"kind={self.kind}, (out, in)=({w.shape[0]}, {self.in_features})"


def _one(device) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=device)


def quantize_linear_fp8(weight: torch.Tensor, bias: Optional[torch.Tensor],
                        amax: Optional[torch.Tensor] = None) -> Linear:
    """Float (out, in) weight → fp8 Linear with a per-tensor scale (reference
    ``quantize_weight``, float8_quantize.py:195-207). ``in_scale`` starts at 1.0;
    calibration replaces it. ``amax``: the weight's max|w| when ``weight`` is only a
    tensor-parallel slice of it."""
    w32 = weight.float()
    scale = amax_to_scale(w32.abs().max() if amax is None else amax, F8_WEIGHT_MAX)
    q = to_fp8_saturated(w32, scale, F8_WEIGHT_MAX).to(WEIGHT_F8_DTYPE)
    one = _one(weight.device)
    return Linear("fp8", q=q, w_scale=scale, w_scale_inv=1.0 / scale,
                  in_scale=one, in_scale_inv=one.clone(), bias=bias)


def quantize_linear_int8(weight: torch.Tensor, bias: Optional[torch.Tensor],
                         amax: Optional[torch.Tensor] = None) -> Linear:
    """Float (out, in) weight → int8 Linear, per-out-channel scales mapping each
    channel's amax to 127, round half to even (JAX quant.py:144). ``amax``: the rows'
    max|w| when ``weight`` holds only some of the in-features."""
    w32 = weight.float()
    scale, scale_inv = _int_scales(w32.abs().amax(dim=1) if amax is None else amax, INT8_MAX)  # (out,)
    q = torch.round(torch.clamp(w32 * scale[:, None], -INT8_MAX, INT8_MAX)).to(torch.int8)
    one = _one(weight.device)
    return Linear("int8", q=q, w_scale=scale, w_scale_inv=scale_inv,
                  in_scale=one, in_scale_inv=one.clone(), bias=bias)


def quantize_linear_int4(weight: torch.Tensor, bias: Optional[torch.Tensor],
                         amax: Optional[torch.Tensor] = None) -> Linear:
    """Float (out, in) weight → packed int4 Linear, per-out-channel scales (the
    gigaquant flow tier, JAX quant.py:170), half-split packed along in. ``amax`` as
    for :func:`quantize_linear_int8`."""
    if weight.dim() != 2 or weight.shape[1] % 2:
        raise ValueError(f"int4 packing needs an (out, even in) weight, got {tuple(weight.shape)}")
    w32 = weight.float()
    scale, scale_inv = _int_scales(w32.abs().amax(dim=1) if amax is None else amax, INT4_MAX)
    q = (torch.round(torch.clamp(w32 * scale[:, None], -INT4_MAX, INT4_MAX)) + INT4_MAX).to(torch.uint8)
    half = weight.shape[1] // 2
    one = _one(weight.device)
    return Linear("int4", q=q[:, :half] | (q[:, half:] << 4), w_scale=scale,
                  w_scale_inv=scale_inv, in_scale=one, in_scale_inv=one.clone(), bias=bias)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(out, in/2) half-split packed nibbles → (out, in) int8 in [-7, 7]."""
    low = (packed & 0xF).to(torch.int8) - 7
    high = (packed >> 4).to(torch.int8) - 7
    return torch.cat([low, high], dim=-1)


def quantize_linear_wo_fp8(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    """Per-out-channel e4m3 weight-only quantization."""
    w32 = weight.float()
    scale = amax_to_scale(w32.abs().amax(dim=1), F8_WEIGHT_MAX)  # (out,)
    q = torch.clamp(w32 * scale[:, None], -F8_WEIGHT_MAX, F8_WEIGHT_MAX).to(WEIGHT_F8_DTYPE)
    return Linear("wo_fp8", q=q, w_scale=scale, w_scale_inv=1.0 / scale, bias=bias)


def quantize_linear_wo_int8(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    """Per-out-channel symmetric int8 weight-only quantization."""
    w32 = weight.float()
    scale = int8_amax_to_scale(w32.abs().amax(dim=1))
    q = torch.round(torch.clamp(w32 * scale[:, None], -INT8_MAX, INT8_MAX)).to(torch.int8)
    return Linear("wo_int8", q=q, w_scale=scale, w_scale_inv=1.0 / scale, bias=bias)


def _blockwise_quantize(weight: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) → packed uint8 (out, in·bits/8) + fp32 reciprocal scales
    (out, nblocks) (JAX quant.py:400)."""
    out_f, in_f = weight.shape
    per_byte = 8 // bits
    if in_f % per_byte:
        raise ValueError(f"in_features {in_f} not packable at {bits} bits")
    block = WO_BLOCK if in_f % WO_BLOCK == 0 else in_f
    qmax = float(2 ** (bits - 1) - 1)  # 7 for int4, 1 for int2
    w32 = weight.float().reshape(out_f, in_f // block, block)
    amax = torch.clamp(w32.abs().amax(dim=2), min=1e-12)  # (out, nblocks)
    scale = amax.new_tensor(qmax) / amax
    q = (torch.round(torch.clamp(w32 * scale[:, :, None], -qmax, qmax)) + qmax).to(torch.uint8)
    q = q.reshape(out_f, in_f // per_byte, per_byte)
    packed = torch.zeros((out_f, in_f // per_byte), dtype=torch.uint8, device=weight.device)
    for j in range(per_byte):
        packed |= q[:, :, j] << (j * bits)
    return packed, 1.0 / scale


def _blockwise_dequantize(packed: torch.Tensor, scale_inv: torch.Tensor, bits: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """Unpack and scale into ``dtype`` through int8 and ``dtype`` intermediates only
    (a T5-XXL kernel in fp32 would cost twice the memory of the bf16 result)."""
    per_byte = 8 // bits
    qmax = 2 ** (bits - 1) - 1
    out_f, in_packed = packed.shape
    parts = [((packed >> (j * bits)) & (2**bits - 1)).to(torch.int8) - qmax for j in range(per_byte)]
    q = torch.stack(parts, dim=-1).reshape(out_f, scale_inv.shape[-1], -1)
    return (q.to(dtype) * scale_inv.to(dtype)[:, :, None]).reshape(out_f, in_packed * per_byte)


def quantize_linear_wo_int4(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    packed, scale_inv = _blockwise_quantize(weight, 4)
    return Linear("wo_int4", q=packed, w_scale_inv=scale_inv, bias=bias)


def quantize_linear_wo_int2(weight: torch.Tensor, bias: Optional[torch.Tensor]) -> Linear:
    packed, scale_inv = _blockwise_quantize(weight, 2)
    return Linear("wo_int2", q=packed, w_scale_inv=scale_inv, bias=bias)


WO_QUANTIZERS = {
    "qfloat8": quantize_linear_wo_fp8,
    "qint8": quantize_linear_wo_int8,
    "qint4": quantize_linear_wo_int4,
    "qint2": quantize_linear_wo_int2,
}


def quantize_blocks_weight_only(blocks, tier: str) -> None:
    """Apply a weight-only tier to every float Linear of an encoder's blocks, in place
    (shared by T5 and CLIP; JAX ``quantize_stacked_weight_only``)."""
    qfn = WO_QUANTIZERS[tier]
    for blk in blocks:
        for key, value in list(blk.items()):
            if isinstance(value, Linear) and value.kind == "float":
                setattr(blk, key, qfn(value.weight, value.bias))


FLOW_QUANTIZERS = {"fp8": quantize_linear_fp8, "int8": quantize_linear_int8, "int4": quantize_linear_int4}


def dequantize_kernel(lin: Linear) -> torch.Tensor:
    """The float (out, in) weight a Linear stands for, in fp32 (reference ``extract_weight_from_linear``,
    lora_loading.py:615-631)."""
    if lin.kind == "float":
        return lin.weight.float()
    if lin.kind == "fp8":
        return lin.q.float() * lin.w_scale_inv
    if lin.kind in ("int8", "wo_fp8", "wo_int8"):
        return lin.q.float() * lin.w_scale_inv[:, None]
    if lin.kind == "int4":
        return _unpack_int4(lin.q).float() * lin.w_scale_inv[:, None]
    return _blockwise_dequantize(lin.q, lin.w_scale_inv, 4 if lin.kind == "wo_int4" else 2, torch.float32)


def with_kernel(lin: Linear, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> Linear:
    """A new Linear of the same kind from a float (out, in) weight, keeping the tuned
    input scale (reference ``set_weight_tensor``,
    float8_quantize.py:209-212). For a tensor-parallel slice (``lin.shard``) the new
    weight is the slice, and the scales come from the whole weight's amax, a MAX over
    tp: fp8's per-tensor one always, the int kinds' per-row ones on a row-parallel
    slice, whose rows span the ranks. So each rank holds the one-rank result's slice."""
    bias = lin.bias if bias is None else bias
    if lin.kind == "float":
        fresh = Linear("float", weight=weight.to(lin.weight.dtype), bias=bias)
    elif lin.kind not in FLOW_QUANTIZERS:
        raise ValueError(f"re-quantizing a weight-only ({lin.kind}) leaf is not supported — "
                         "weight-only tiers are load-time only (text encoders)")
    else:
        amax, shard = None, lin.shard
        if shard is not None and (lin.kind == "fp8" or shard.mode == "row"):
            w32 = weight.float()
            amax = w32.abs().max() if lin.kind == "fp8" else w32.abs().amax(dim=1)
            amax = shard.mesh.all_reduce_max(amax.contiguous(), shard.axis)
        fresh = FLOW_QUANTIZERS[lin.kind](weight, bias, amax)
        fresh.in_scale, fresh.in_scale_inv = lin.in_scale, lin.in_scale_inv
    fresh.shard = lin.shard
    return fresh


def with_input_scale(lin: Linear, amax: torch.Tensor) -> Linear:
    """Set the tuned input scale from a calibrated running amax, in place (reference
    ``quantize_input`` freeze path, float8_quantize.py:238-246): the e5m2 law for
    ``fp8``, 127/amax for ``int8``/``int4``; other kinds are returned unchanged."""
    if lin.kind == "fp8":
        scale = amax_to_scale(amax.to(lin.in_scale.device), F8_INPUT_MAX)
        scale_inv = 1.0 / scale
    elif lin.kind in ("int8", "int4"):
        scale, scale_inv = _int_scales(amax.to(lin.in_scale.device), INT8_MAX)
    else:
        return lin
    lin.in_scale = scale
    lin.in_scale_inv = scale_inv
    return lin


# ------------------------------------------------------------ tp under autograd
#
# A sharded Linear's collectives as Megatron's conjugate pair, so that a gradient
# crosses them: ``tp_copy`` (f) is the identity forward and sums ∂ over tp backward,
# at a column-parallel input; ``tp_reduce`` (g) sums over tp forward and passes ∂
# through backward, at a row-parallel output (the ∂ of a replicated output is the same
# on every rank already: summing it again would give tp times the gradient);
# ``tp_gather`` concatenates the ranks' columns forward and keeps the rank's slice of
# ∂ backward. Without a gradient each is the mesh's plain collective (or nothing).


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g.float().clone(), ctx.axis).to(g.dtype), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce_sum(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        return g.chunk(mesh.size(axis), ctx.dim)[mesh.rank(axis)].contiguous(), None, None, None


def _grad_on(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def tp_copy(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """f: x forward; ∂ summed over ``axis`` backward."""
    return _Copy.apply(x, mesh, axis) if _grad_on(x) else x


def tp_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """g: Σ over ``axis`` forward (in place without a gradient); ∂ unchanged backward."""
    return _Reduce.apply(x, mesh, axis) if _grad_on(x) else mesh.all_reduce_sum(x, axis)


def tp_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; backward the rank's slice of ∂."""
    return _Gather.apply(x, mesh, axis, dim) if _grad_on(x) else mesh.all_gather(x, axis, dim)


def _lora_branch(lin: Linear, x: torch.Tensor, out: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``out + (x·Aᵀ)·Bᵀ``: ``h = x·Aᵀ`` rounded to the compute dtype, the product
    accumulated in fp32 and added in the output's dtype (JAX quant.py:509-519). The
    adapters are whole on every rank; on a column-parallel shard the branch keeps the
    rank's rows of B, on a row-parallel one ``x_local·A_localᵀ`` is summed over tp
    first and the branch is added once, to the reduced output. A replicated adapter
    used on the rank's part of the work gets its ∂ summed over tp (``tp_copy``)."""
    a, b, shard = lin.lora_a.to(compute_dtype), lin.lora_b.to(compute_dtype), lin.shard
    if shard is None:
        h = F.linear(x.to(compute_dtype), a)
    else:
        mesh, axis = shard.mesh, shard.axis
        size, rank = mesh.size(axis), mesh.rank(axis)
        a = tp_copy(a, mesh, axis)
        if shard.mode == "col":
            b = tp_copy(b, mesh, axis).chunk(size, 0)[rank]
            h = F.linear(x.to(compute_dtype), a)
        else:
            a = a.chunk(size, 1)[rank]
            h = tp_reduce(_f32_product(x.to(compute_dtype), a), mesh, axis).to(compute_dtype)
    return out + F.linear(h, b).to(out.dtype)


def linear_apply(
    lin: Linear,
    x: torch.Tensor,
    compute_dtype: torch.dtype = torch.bfloat16,
    collect_amax: bool = False,
    fast_accum: bool = True,
    dequant: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply a linear layer; with ``collect_amax`` also return max|x| (fp32 scalar)
    for scale calibration. ``fast_accum`` is ``_scaled_mm``'s ``use_fast_accum`` for
    the ``fp8`` kind on the card. ``dequant`` runs ``fp8``/``int8``/``int4`` as the
    differentiable dequantize path of QLoRA training. With adapters set, adds
    ``h·Bᵀ`` where ``h = x·Aᵀ`` is rounded to the compute dtype and the product
    accumulates in fp32, added in the output's dtype (JAX quant.py:509-519)."""
    amax = x.abs().max().float() if collect_amax else None
    shard = lin.shard
    if shard is not None and shard.mode == "row":
        out = _linear_base(lin, x, compute_dtype, fast_accum, dequant,
                           reduce=lambda p: tp_reduce(p, shard.mesh, shard.axis))
        if lin.lora_a is not None:
            out = _lora_branch(lin, x, out, compute_dtype)
        return out, amax
    if shard is not None:
        x = tp_copy(x, shard.mesh, shard.axis)
    out = _linear_base(lin, x, compute_dtype, fast_accum, dequant)
    if lin.lora_a is not None:
        out = _lora_branch(lin, x, out, compute_dtype)
    if shard is not None and shard.gather:
        out = tp_gather(out, shard.mesh, shard.axis, -1)
    return out, amax


def _saveable(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A weight that autograd may save for x's backward: a tensor made under
    ``torch.inference_mode`` (a LoRA fuse, a calibrated pipeline) cannot be saved, so
    it is copied when x needs a gradient."""
    return w.clone() if x.requires_grad and w.is_inference() else w


def fp8_linear_ref(lin: Linear, x8: torch.Tensor, compute_dtype, with_bias: bool = True) -> torch.Tensor:
    """Plain version of the ``fp8`` product on an e5m2 activation: fp8 values are exact
    in fp32, so this is one fp32 product with the scale and bias epilogue."""
    out = torch.matmul(x8.float(), lin.q.float().t()) * (lin.in_scale_inv * lin.w_scale_inv)
    if with_bias and lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(compute_dtype)


def quantize_activation_int8(x: torch.Tensor, in_scale: torch.Tensor) -> torch.Tensor:
    """``round(clip(bf16(x)·bf16(in_scale), ±127))`` as int8: the product is taken in
    bf16, as in the JAX package (quant.py:566-569)."""
    sc = in_scale.to(torch.bfloat16)
    return torch.round(torch.clamp(x.to(torch.bfloat16) * sc, -INT8_MAX, INT8_MAX)).to(torch.int8)


def int_mm(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product ``x8 @ q.T`` of (M, K) and (N, K) int8 matrices.

    On the card: ``torch._int_mm``, which refuses M <= 16 rows (K and N must be
    multiples of 8), so fewer rows are padded with zeros to INT_MM_MIN_ROWS and the
    result sliced: zero rows add nothing to an integer product. On the CPU: the plain
    version, an fp64 product, exact while |sum| < 2^53 (flux's largest is
    127²·15360 < 2^28)."""
    if x8.is_cuda:
        m = x8.shape[0]
        if m < INT_MM_MIN_ROWS:
            x8 = F.pad(x8, (0, 0, 0, INT_MM_MIN_ROWS - m))
        return torch._int_mm(x8.contiguous(), q.t())[:m]
    return int_mm_ref(x8, q)


def int_mm_ref(x8: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int_mm`, exact in fp64."""
    return torch.matmul(x8.double(), q.double().t()).to(torch.int32)


def _block_scales(lin: Linear) -> torch.Tensor:
    """The blockwise scales of this rank's in-features. A row-parallel slice keeps its
    blocks' scales when tp divides the block count; otherwise (the JAX guard) the
    scales stay whole and the slice, which then lies inside one block, takes that
    block's column here."""
    s, shard = lin.w_scale_inv, lin.shard
    if shard is None or shard.mode != "row":
        return s
    size, in_local = shard.mesh.size(shard.axis), lin.in_features
    in_full = in_local * size
    nblocks = in_full // (WO_BLOCK if in_full % WO_BLOCK == 0 else in_full)
    if nblocks % size == 0:
        return s
    block = in_full // nblocks
    if block % in_local:
        raise NotImplementedError(f"a {in_local}-wide row slice of {block}-wide scale blocks")
    first = shard.mesh.rank(shard.axis) * in_local // block
    return s[:, first:first + 1]


class _F32Product(torch.autograd.Function):
    """``torch.mm(x, wᵀ, out_dtype=fp32)`` (which has no derivative) under autograd: the
    backward runs in the operands' dtype, as a compute-dtype ``F.linear``'s would (the
    incoming ∂ of a rounded output holds compute-dtype values)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = g @ w if ctx.needs_input_grad[0] else None
        dw = g.t() @ x2 if ctx.needs_input_grad[1] else None
        return dx, dw


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ of compute-dtype operands with the fp32 accumulator returned unrounded
    (a row-parallel partial: rounding it to the compute dtype before the reduction
    would round each rank's part where one rank rounds the whole sum once). On the
    card cuBLAS's bf16 GEMM with an fp32 output; on the CPU the fp32 product."""
    x2 = x.reshape(-1, x.shape[-1])
    if not x.is_cuda:
        out = torch.mm(x2.float(), w.float().t())
    elif _grad_on(x2, w):
        out = _F32Product.apply(x2, w)
    else:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[0])


def _reduced(partial: torch.Tensor, lin: Linear, reduce, compute_dtype) -> torch.Tensor:
    """A row-parallel epilogue: the partial product reduced in fp32 (as (rows, out)),
    the bias added once, one cast."""
    out = reduce(partial.float().reshape(-1, partial.shape[-1])).reshape(partial.shape)
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(compute_dtype)


def _linear_base(lin: Linear, x: torch.Tensor, compute_dtype, fast_accum: bool,
                 dequant: bool = False, reduce=None) -> torch.Tensor:
    """The layer's product; ``reduce`` (a row-parallel shard's all-reduce) sums the
    partial product over the ranks before the epilogue and the bias."""
    bias = None if lin.bias is None else lin.bias.to(compute_dtype)
    if lin.kind == "float":
        w = _saveable(lin.weight.to(compute_dtype), x)
        if reduce is not None:
            return _reduced(_f32_product(x.to(compute_dtype), w), lin, reduce, compute_dtype)
        return F.linear(x.to(compute_dtype), w, bias)

    if dequant and lin.kind in ACTIVATION_KINDS:
        # the differentiable QLoRA forward (JAX quant.py:522-534): the weight
        # dequantized in the compute dtype (fp8's scale is a scalar, int8/int4's per out
        # channel), full-precision activations; F.linear adds the bias to the fp32
        # accumulator (cuBLAS's epilogue on the card) and rounds once, as JAX adds it in
        # fp32 and casts once
        q = _unpack_int4(lin.q) if lin.kind == "int4" else lin.q
        scale = lin.w_scale_inv.to(compute_dtype)
        w = q.to(compute_dtype) * (scale if lin.kind == "fp8" else scale[:, None])
        if reduce is not None:
            return _reduced(_f32_product(x.to(compute_dtype), w), lin, reduce, compute_dtype)
        return F.linear(x.to(compute_dtype), w, bias)

    if lin.kind == "fp8":
        x8 = to_fp8_saturated(x.float(), lin.in_scale, F8_INPUT_MAX).to(INPUT_F8_DTYPE)
        if not x.is_cuda:
            if reduce is None:
                return fp8_linear_ref(lin, x8, compute_dtype)
            return _reduced(fp8_linear_ref(lin, x8, torch.float32, with_bias=False), lin, reduce, compute_dtype)
        lead = x8.shape[:-1]
        out = torch._scaled_mm(
            x8.reshape(-1, x8.shape[-1]),
            lin.q.t(),
            scale_a=lin.in_scale_inv,
            scale_b=lin.w_scale_inv,
            bias=None if reduce is not None else bias,
            out_dtype=torch.float32 if reduce is not None else compute_dtype,
            use_fast_accum=fast_accum,
        )
        if reduce is not None:
            out = _reduced(out, lin, reduce, compute_dtype)
        return out.reshape(*lead, out.shape[-1])

    if lin.kind in ("int8", "int4"):
        x8 = quantize_activation_int8(x, lin.in_scale)
        q = _unpack_int4(lin.q) if lin.kind == "int4" else lin.q
        acc = int_mm(x8.reshape(-1, x8.shape[-1]), q)
        if reduce is not None:  # the exact int32 sum over the ranks, then one epilogue
            acc = reduce(acc)
        # dequantize by the reciprocal of the scale actually applied (bf16-rounded),
        # not the stored fp32 in_scale_inv (JAX quant.py:576-579); int32 × fp32
        # promotes to fp32 inside the one multiply, as acc.float() would in a pass of its own
        out = acc * ((1.0 / lin.in_scale.to(torch.bfloat16).float()) * lin.w_scale_inv)
        if lin.bias is not None:
            out = out + lin.bias.float()
        return out.to(compute_dtype).reshape(*x.shape[:-1], out.shape[-1])

    # weight-only: dequantize the weight into the compute dtype, full-precision activations
    if lin.kind in ("wo_fp8", "wo_int8"):
        w = lin.q.to(compute_dtype) * lin.w_scale_inv.to(compute_dtype)[:, None]
    else:
        w = _blockwise_dequantize(lin.q, _block_scales(lin), 4 if lin.kind == "wo_int4" else 2, compute_dtype)
    if reduce is not None:
        return _reduced(_f32_product(x.to(compute_dtype), w), lin, reduce, compute_dtype)
    return F.linear(x.to(compute_dtype), w, bias)
