"""Checkpoint loading and saving: BFL safetensors → the port's modules, and the
prequantized export (JAX counterpart: ``flux_fp8_api_tpu.utils.checkpoint``).

- BFL files store torch (out, in) weights, which is the port's own layout, and OIHW
  conv weights, the port's VAE layout: no transpose on load.
- Each tensor is moved to its device as it is read, and each float Linear goes
  through the caller's ``leaf_fn`` (a quantization tier) at once, so a flow file is
  never held whole as a float model (24 GB in bf16 at flux-dev size).
- Reference-prequantized files (``float8_data`` + ``scale`` [+ ``input_scale``] per
  F8Linear, float8_quantize.py:91-193) load straight into fp8 leaves.
- Files store the reference's interleaved rope layout; the runtime is half-split, so
  the q/k output rows of every qkv and linear1 and the qk-norm scales are permuted
  after reading (:func:`deinterleave_flux_tree`).
- The prequantized export writes the JAX package's file layout
  (``flux-fp8-api-tpu/prequant-v1``): depth-stacked leaves, (in, out) kernels and
  the ``linears`` kind map, so a file saved by either package loads in the other.
"""

from __future__ import annotations

import json
import logging
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.flux import FluxStatic, LeafFn, _map_linears
from ..ops.quant import Linear, dequantize_kernel, with_kernel
from ..ops.rope import deinterleave_permutation
from .config import AutoEncoderParams, into_device
from .safetensors_io import SafetensorsFile, save_safetensors
from .tree import ParamTree

logger = logging.getLogger(__name__)


class LoadReport:
    """Missing/unexpected-key accounting for tolerant (strict=False) loading, as the
    reference loads with ``strict=False`` and prints warnings (util.py:225-237).
    Loaders record every key they consume and every expected key they found absent;
    :meth:`finish` warns, or raises one KeyError naming them with ``strict=True``."""

    def __init__(self, name: str):
        self.name = name
        self.missing: list = []
        self.unexpected: list = []
        self._consumed: set = set()

    def consume(self, key: str) -> None:
        self._consumed.add(key)

    def has(self, sd, key: str) -> bool:
        """Membership probe that records a hit as consumed."""
        present = key in sd
        if present:
            self._consumed.add(key)
        return present

    def miss(self, key: str) -> None:
        self.missing.append(key)

    @staticmethod
    def fetch(sd_get, name: str, shape, fill: float = 0.0, report=None) -> torch.Tensor:
        """``sd_get(name)`` with its consumption recorded; with a report, a KeyError
        becomes a recorded miss and a ``fill`` tensor of ``shape``, without one it
        propagates (shared by the T5 and CLIP loaders)."""
        try:
            t = sd_get(name)
        except KeyError:
            if report is None:
                raise
            report.miss(name)
            return torch.full(shape, fill, dtype=torch.float32)
        if report is not None:
            report.consume(name)
        return t

    @staticmethod
    def _fmt(keys, cap: int = 12) -> str:
        keys = sorted(keys)
        tail = f" … +{len(keys) - cap} more" if len(keys) > cap else ""
        return f"{keys[:cap]}{tail}"

    def finish(self, all_keys, strict: bool = False) -> "LoadReport":
        self.unexpected = sorted(set(all_keys) - self._consumed)
        if self.missing:
            msg = f"{self.name}: missing keys (zero/identity-initialized): {self._fmt(self.missing)}"
            if strict:
                raise KeyError(msg)
            logger.warning(msg)
        if self.unexpected:
            msg = f"{self.name}: unexpected keys (ignored): {self._fmt(self.unexpected)}"
            if strict:
                raise KeyError(msg)
            logger.warning(msg)
        return self


# ------------------------------------------------------------------ flux (BFL format)

_DOUBLE_KEYMAP = {
    "img_mod_lin": "img_mod.lin",
    "txt_mod_lin": "txt_mod.lin",
    "img_attn_qkv": "img_attn.qkv",
    "img_attn_proj": "img_attn.proj",
    "txt_attn_qkv": "txt_attn.qkv",
    "txt_attn_proj": "txt_attn.proj",
    "img_mlp_0": "img_mlp.0",
    "img_mlp_2": "img_mlp.2",
    "txt_mlp_0": "txt_mlp.0",
    "txt_mlp_2": "txt_mlp.2",
}
_DOUBLE_NORMMAP = {
    "img_attn_qnorm": "img_attn.norm.query_norm.scale",
    "img_attn_knorm": "img_attn.norm.key_norm.scale",
    "txt_attn_qnorm": "txt_attn.norm.query_norm.scale",
    "txt_attn_knorm": "txt_attn.norm.key_norm.scale",
}
_SINGLE_KEYMAP = {
    "linear1": "linear1",
    "linear2": "linear2",
    "mod_lin": "modulation.lin",
}
_SINGLE_NORMMAP = {
    "qnorm": "norm.query_norm.scale",
    "knorm": "norm.key_norm.scale",
}
_TOP_LINEARS = {
    "img_in": "img_in",
    "txt_in": "txt_in",
}
_MLP_EMBEDDERS = ("time_in", "vector_in", "guidance_in")
_FINAL_KEYMAP = {"linear": "final_layer.linear", "adaln": "final_layer.adaLN_modulation.1"}


def linear_shape(cfg: FluxStatic, path: Tuple[str, ...]) -> Tuple[int, int, bool]:
    """(out, in, has_bias) of the flux Linear at ``path`` (as the random init draws it)."""
    hs, mh = cfg.hidden_size, cfg.mlp_hidden
    name = path[-1]
    if path[0] in _MLP_EMBEDDERS:
        ins = {"time_in": 256, "vector_in": cfg.vec_in_dim, "guidance_in": 256}[path[0]]
        return hs, (ins if name == "in_layer" else hs), True
    table = {
        "img_in": (hs, cfg.in_channels), "txt_in": (hs, cfg.context_in_dim),
        "img_mod_lin": (6 * hs, hs), "txt_mod_lin": (6 * hs, hs),
        "img_attn_qkv": (3 * hs, hs), "txt_attn_qkv": (3 * hs, hs),
        "img_attn_proj": (hs, hs), "txt_attn_proj": (hs, hs),
        "img_mlp_0": (mh, hs), "txt_mlp_0": (mh, hs), "img_mlp_2": (hs, mh), "txt_mlp_2": (hs, mh),
        "linear1": (3 * hs + mh, hs), "linear2": (hs, hs + mh), "mod_lin": (3 * hs, hs),
        "linear": (cfg.in_channels, hs), "adaln": (2 * hs, hs),
    }
    out_f, in_f = table[name]
    return out_f, in_f, (cfg.qkv_bias if name.endswith("_qkv") else True)


def assemble_flux(cfg: FluxStatic, linear: Callable, norm: Callable, keep=None) -> ParamTree:
    """The flux tree in the random init's order, its leaves from ``linear(path,
    block)`` and ``norm(path, block)`` (block None outside the depth stacks).
    ``keep``: {stack: global block indices} to build (a pp stage's slice,
    ``parallel/mesh.py:stage_blocks``); the others are never read."""
    keep = keep or {}

    def block(stack, keys, norms, i):
        entries = {k: linear((stack, k), i) for k in keys}
        entries.update({k: norm((stack, k), i) for k in norms})
        return ParamTree(entries)

    tree: Dict[str, Any] = {n: linear((n,), None) for n in _TOP_LINEARS}
    for e in _MLP_EMBEDDERS:
        skip = e == "guidance_in" and not cfg.guidance_embed
        tree[e] = None if skip else {k: linear((e, k), None) for k in ("in_layer", "out_layer")}
    tree["double_blocks"] = torch.nn.ModuleList(
        block("double_blocks", _DOUBLE_KEYMAP, _DOUBLE_NORMMAP, i)
        for i in keep.get("double_blocks", range(cfg.depth)))
    tree["single_blocks"] = torch.nn.ModuleList(
        block("single_blocks", _SINGLE_KEYMAP, _SINGLE_NORMMAP, i)
        for i in keep.get("single_blocks", range(cfg.depth_single_blocks)))
    tree["final_layer"] = {k: linear(("final_layer", k), None) for k in _FINAL_KEYMAP}
    return ParamTree(tree)


def bfl_key(path: Tuple[str, ...], block: Optional[int]) -> str:
    """The BFL name of the flux leaf at ``path`` (block ``block`` of a depth stack)."""
    stack, name = path[0], path[-1]
    if stack == "double_blocks":
        return f"double_blocks.{block}." + {**_DOUBLE_KEYMAP, **_DOUBLE_NORMMAP}[name]
    if stack == "single_blocks":
        return f"single_blocks.{block}." + {**_SINGLE_KEYMAP, **_SINGLE_NORMMAP}[name]
    if stack == "final_layer":
        return _FINAL_KEYMAP[name]
    if stack in _MLP_EMBEDDERS:
        return f"{stack}.{name}"
    return _TOP_LINEARS[stack]


def _get_linear(sd: SafetensorsFile, prefix: str, shape: Tuple[int, int, bool], dtype,
                device, report: LoadReport) -> Linear:
    """One linear, float or reference-prequantized; a missing weight, bias or scale
    fills (zeros, or 1.0 for a scale) and is recorded (reference strict=False load,
    util.py:240-256)."""

    def read(key):
        return sd.get(key).to(device)

    out_f, in_f, has_bias = shape
    bias_key = f"{prefix}.bias"
    if report.has(sd, f"{prefix}.float8_data"):
        q = read(f"{prefix}.float8_data")
        scale_key = f"{prefix}.scale"
        if report.has(sd, scale_key):
            w_scale = read(scale_key).float().reshape(())
        else:
            report.miss(scale_key)
            w_scale = torch.ones((), device=device)
        # the serialization's derived keys and its 1-element freed-weight stub
        for aux in (".scale_reciprocal", ".input_scale_reciprocal", ".weight"):
            report.has(sd, f"{prefix}{aux}")
        bias = read(bias_key).to(dtype) if report.has(sd, bias_key) else None
        if bias is None and has_bias:
            report.miss(bias_key)
            bias = torch.zeros(out_f, dtype=dtype, device=device)
        in_key = f"{prefix}.input_scale"
        in_scale = (read(in_key).float().reshape(()) if report.has(sd, in_key)
                    else torch.ones((), device=device))
        return Linear("fp8", q=q, w_scale=w_scale, w_scale_inv=1.0 / w_scale,
                      in_scale=in_scale, in_scale_inv=1.0 / in_scale, bias=bias)
    w_key = f"{prefix}.weight"
    if report.has(sd, w_key):
        weight = read(w_key).to(dtype)
    else:
        report.miss(w_key)
        weight = torch.zeros((out_f, in_f), dtype=dtype, device=device)
    if report.has(sd, bias_key):
        bias = read(bias_key).to(dtype)
    elif has_bias:
        report.miss(bias_key)
        bias = torch.zeros(out_f, dtype=dtype, device=device)
    else:
        bias = None
    return Linear("float", weight=weight, bias=bias)


def load_flux_checkpoint(
    path_or_file,
    cfg: FluxStatic,
    dtype: Optional[torch.dtype] = None,
    strict: bool = False,
    leaf_fn: Optional[LeafFn] = None,
    device=None,
    keep=None,
) -> ParamTree:
    """BFL flux safetensors → the port's flux model on ``device`` (reference
    load_flow_model, util.py:240-256), reference-prequantized files included. Each
    float Linear goes through ``leaf_fn`` as soon as it is read; ``keep`` as in
    :func:`assemble_flux` (the other blocks' keys count as read).

    Tolerant like the reference (``strict=False`` + ``print_load_warning``): missing
    linears and biases zero-fill, missing qk-norm scales are identity, extra keys are
    ignored, each with a warning naming the keys; ``strict=True`` raises instead.
    ``device`` defaults to cuda:0 (``into_device``); pass ``"cpu"`` for the host."""
    device = into_device(device)
    dtype = dtype or cfg.dtype
    sd = _as_stf(path_or_file)
    report = LoadReport(f"flux checkpoint {sd.path}")

    def linear(path, block):
        lin = _get_linear(sd, bfl_key(path, block), linear_shape(cfg, path), dtype, device, report)
        return leaf_fn(path, lin) if leaf_fn is not None and lin.kind == "float" else lin

    def norm(path, block):
        key = bfl_key(path, block)
        if report.has(sd, key):
            return sd.get(key).to(device, dtype)
        report.miss(key)
        return torch.ones(cfg.head_dim, dtype=dtype, device=device)  # identity qk-norm

    model = assemble_flux(cfg, linear, norm, keep)
    for stack, blocks in (keep or {}).items():
        for k in sd.keys():
            m = re.match(rf"{stack}\.(\d+)\.", k)
            if m and int(m.group(1)) not in blocks:
                report.consume(k)
    report.finish(sd.keys(), strict=strict)
    # files store the interleaved rope layout; the runtime is half-split
    return deinterleave_flux_tree(model, cfg)


def qkv_out_permutation(hidden_size: int, head_dim: int, extra: int = 0) -> np.ndarray:
    """Output-axis permutation of a fused qkv(+mlp) weight from the checkpoint's
    interleaved rope layout to the runtime's half-split one: the q and k sections
    permute per head; v and an ``extra``-wide mlp tail (single-block linear1) stay."""
    head_perm = deinterleave_permutation(head_dim)
    sec = np.concatenate([h * head_dim + head_perm for h in range(hidden_size // head_dim)])
    return np.concatenate([
        sec,
        hidden_size + sec,
        np.arange(2 * hidden_size, 3 * hidden_size + extra),
    ])


def _permute_linear_out(lin: Linear, perm) -> Linear:
    """A Linear with its output channels permuted: weight/q rows, bias and
    per-channel scales (a per-tensor fp8 scale is left alone). Row permutations
    commute with every quantizer here (their scales are per tensor or per row), so
    any kind permutes in place."""
    perm = torch.as_tensor(perm, device=(lin.weight if lin.weight is not None else lin.q).device)

    def rows(t):
        return t if t is None or t.dim() == 0 or t.shape[0] != len(perm) else t[perm]

    return Linear(lin.kind, weight=rows(lin.weight), q=rows(lin.q), w_scale=rows(lin.w_scale),
                  w_scale_inv=rows(lin.w_scale_inv), in_scale=lin.in_scale,
                  in_scale_inv=lin.in_scale_inv, bias=rows(lin.bias))


def _permute_linear_in(lin: Linear, perm) -> Linear:
    """A Linear with its input channels permuted (weight/q columns); scales, bias and
    input scales stay. int4's half-split in axis packs two columns per byte, so it
    round-trips dequantize → permute → requantize (``with_kernel``; exact, since its
    scales are per output row, and the tuned input scale is kept). The blockwise
    weight-only kinds are refused: flow trees never hold them."""
    if lin.kind.startswith("wo_"):
        raise ValueError(f"in-axis permutation of a weight-only ({lin.kind}) leaf is not "
                         "supported — weight-only tiers are text-encoder-only")
    perm = torch.as_tensor(perm, device=(lin.weight if lin.weight is not None else lin.q).device)
    if lin.kind == "int4":
        return with_kernel(lin, dequantize_kernel(lin)[:, perm], lin.bias)
    cols = lambda t: None if t is None else t[:, perm]  # noqa: E731
    return Linear(lin.kind, weight=cols(lin.weight), q=cols(lin.q), w_scale=lin.w_scale,
                  w_scale_inv=lin.w_scale_inv, in_scale=lin.in_scale,
                  in_scale_inv=lin.in_scale_inv, bias=lin.bias)


def deinterleave_flux_tree(model: ParamTree, cfg: FluxStatic) -> ParamTree:
    """Apply the rope deinterleave permutation to every q/k-producing Linear and the
    qk-norm scales, in place, giving the runtime's half-split layout. The model's
    outputs are mathematically unchanged."""
    hd = cfg.head_dim
    head_perm = torch.as_tensor(deinterleave_permutation(hd))
    qkv_perm = qkv_out_permutation(cfg.hidden_size, hd)
    lin1_perm = qkv_out_permutation(cfg.hidden_size, hd, extra=cfg.mlp_hidden)
    for blk in model["double_blocks"]:
        for name in ("img_attn_qkv", "txt_attn_qkv"):
            setattr(blk, name, _permute_linear_out(blk[name], qkv_perm))
        for name in _DOUBLE_NORMMAP:
            setattr(blk, name, blk[name][head_perm.to(blk[name].device)])
    for blk in model["single_blocks"]:
        blk.linear1 = _permute_linear_out(blk["linear1"], lin1_perm)
        for name in _SINGLE_NORMMAP:
            setattr(blk, name, blk[name][head_perm.to(blk[name].device)])
    return model


def grouped_qkv_permutation(hidden_size: int, head_dim: int, extra: int = 0) -> np.ndarray:
    """Flat → grouped out-axis permutation of a fused qkv(+mlp) weight (JAX
    utils/checkpoint.py:326-348): the flat order (3, heads, head_dim) regroups
    head-major into [q_n | k_n | v_n (| mlp_n)], and with ``extra`` (single-block
    linear1's mlp tail) the mlp channels are sliced per head too. A contiguous tp slice
    of the grouped axis then holds whole heads and their mlp slices."""
    n_heads = hidden_size // head_dim
    g = 0
    if extra:
        if extra % n_heads:
            raise ValueError(f"mlp width {extra} must divide across {n_heads} heads")
        g = extra // n_heads
    idx = np.arange(head_dim)
    groups = []
    for n in range(n_heads):
        base = n * head_dim
        parts = [base + idx, hidden_size + base + idx, 2 * hidden_size + base + idx]
        if extra:
            parts.append(3 * hidden_size + n * g + np.arange(g))
        groups.append(np.concatenate(parts))
    return np.concatenate(groups)


def linear2_in_permutation(hidden_size: int, head_dim: int, mlp_hidden: int) -> np.ndarray:
    """Flat → grouped in-axis permutation of single-block linear2 (JAX
    utils/checkpoint.py:351-368): [attn | mlp] becomes per-head groups
    [attn_n | mlp_n], matching linear1's grouped out-axis, so a row-parallel slice
    consumes exactly what its own heads produced."""
    n_heads = hidden_size // head_dim
    if mlp_hidden % n_heads:
        raise ValueError(f"mlp width {mlp_hidden} must divide across {n_heads} heads")
    g = mlp_hidden // n_heads
    return np.concatenate([
        np.concatenate([n * head_dim + np.arange(head_dim), hidden_size + n * g + np.arange(g)])
        for n in range(n_heads)
    ])


def grouped_permutations(cfg: FluxStatic, inverse: bool = False) -> Dict[str, Tuple[str, np.ndarray]]:
    """Leaf name → ("out" | "in", permutation) of the flat → grouped relayout, or of
    grouped → flat with ``inverse``."""
    hd = cfg.head_dim
    perms = {
        "img_attn_qkv": ("out", grouped_qkv_permutation(cfg.hidden_size, hd)),
        "txt_attn_qkv": ("out", grouped_qkv_permutation(cfg.hidden_size, hd)),
        "linear1": ("out", grouped_qkv_permutation(cfg.hidden_size, hd, extra=cfg.mlp_hidden)),
        "linear2": ("in", linear2_in_permutation(cfg.hidden_size, hd, cfg.mlp_hidden)),
    }
    if inverse:
        perms = {k: (axis, np.argsort(p)) for k, (axis, p) in perms.items()}
    return perms


def relayout_flux_leaf(path: Tuple[str, ...], lin: Linear, perms) -> Linear:
    """One Linear of the relayout (``path`` as ``models/flux.py:_map_linears`` gives it;
    ``perms`` from :func:`grouped_permutations`); leaves outside it pass."""
    if path[0] not in ("double_blocks", "single_blocks") or path[-1] not in perms:
        return lin
    axis, perm = perms[path[-1]]
    return _permute_linear_out(lin, perm) if axis == "out" else _permute_linear_in(lin, perm)


def relayout_flux_tree(model: ParamTree, cfg: FluxStatic, inverse: bool = False) -> ParamTree:
    """Relayout the fused qkv/linear1/linear2 channel axes between the "flat" layout
    (one rank) and the "grouped" head-major one (tensor parallelism), in place (JAX
    utils/checkpoint.py:371-396). A pure permutation: the model's outputs are
    unchanged. ``inverse`` goes grouped → flat (files always hold the flat layout).
    Works on float and quantized leaves; the int4 in-permutation round-trips
    dequantize → permute → requantize, as in JAX."""
    perms = grouped_permutations(cfg, inverse)
    _map_linears(model, lambda path, lin: relayout_flux_leaf(path, lin, perms))
    return model


def _as_stf(path_or_file) -> SafetensorsFile:
    """A path or an open SafetensorsFile (the multi-GB header is parsed once and
    shared by the format detectors and the loader)."""
    return path_or_file if isinstance(path_or_file, SafetensorsFile) else SafetensorsFile(path_or_file)


def is_prequantized_reference_file(path_or_file) -> bool:
    return any(k.endswith(".float8_data") for k in _as_stf(path_or_file).keys())


def reference_prequant_has_input_scales(path_or_file) -> bool:
    """True when every F8Linear of a reference-prequantized file ships its tuned
    ``input_scale``. Without them the reference re-runs the amax trials
    (float8_quantize.py:154-185), so the loader reports the flow as not prequantized
    and the pipeline calibrates."""
    keys = set(_as_stf(path_or_file).keys())
    prefixes = [k[: -len(".float8_data")] for k in keys if k.endswith(".float8_data")]
    return all(f"{p}.input_scale" in keys for p in prefixes)


# ----------------------------------------------------------------------- autoencoder


def load_ae_checkpoint(path: str, cfg: AutoEncoderParams, dtype=torch.bfloat16,
                       strict: bool = False, device=None) -> ParamTree:
    """BFL ae.sft → the VAE tree on ``device`` (reference load_autoencoder,
    util.py:278-295), encoder and decoder, conv weights OIHW as stored. Structure
    follows key presence. Missing biases and norm affines degrade to identity with a
    warning and extra keys are ignored; missing conv weights (shape unknown) raise one
    KeyError naming every absent tensor. ``device`` defaults to cuda:0
    (``into_device``)."""
    device = into_device(device)
    sd = SafetensorsFile(path)
    report = LoadReport(f"ae checkpoint {path}")
    fatal: list = []

    def read(key):
        return sd.get(key).to(device, dtype)

    def conv(prefix):
        wk, bk = f"{prefix}.weight", f"{prefix}.bias"
        if not report.has(sd, wk):
            fatal.append(wk)
            return {"weight": None}
        out = {"weight": read(wk)}
        if report.has(sd, bk):
            out["bias"] = read(bk)
        else:
            report.miss(bk)  # an absent bias is a zero bias
        return out

    def gn(prefix):
        wk, bk = f"{prefix}.weight", f"{prefix}.bias"
        hw, hb = report.has(sd, wk), report.has(sd, bk)
        if not hw and not hb:
            fatal.extend([wk, bk])  # no tensor to infer the channel count from
            return {"weight": None, "bias": None}
        w = read(wk) if hw else None
        b = read(bk) if hb else None
        if w is None:
            report.miss(wk)
            w = torch.ones_like(b)
        if b is None:
            report.miss(bk)
            b = torch.zeros_like(w)
        return {"weight": w, "bias": b}

    def resnet(prefix):
        p = {"norm1": gn(f"{prefix}.norm1"), "conv1": conv(f"{prefix}.conv1"),
             "norm2": gn(f"{prefix}.norm2"), "conv2": conv(f"{prefix}.conv2")}
        if f"{prefix}.nin_shortcut.weight" in sd:
            p["nin_shortcut"] = conv(f"{prefix}.nin_shortcut")
        return p

    def mid(side):
        attn = f"{side}.mid.attn_1"
        return {
            "block_1": resnet(f"{side}.mid.block_1"),
            "attn_1": {"norm": gn(f"{attn}.norm"), **{n: conv(f"{attn}.{n}") for n in ("q", "k", "v", "proj_out")}},
            "block_2": resnet(f"{side}.mid.block_2"),
        }

    n_res = len(cfg.ch_mult)
    enc: Dict[str, Any] = {"conv_in": conv("encoder.conv_in"), "down": []}
    for i in range(n_res):
        level: Dict[str, Any] = {"block": [resnet(f"encoder.down.{i}.block.{j}") for j in range(cfg.num_res_blocks)]}
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            level["downsample"] = {"conv": conv(f"encoder.down.{i}.downsample.conv")}
        enc["down"].append(level)
    enc.update(mid=mid("encoder"), norm_out=gn("encoder.norm_out"), conv_out=conv("encoder.conv_out"))

    dec: Dict[str, Any] = {"conv_in": conv("decoder.conv_in"), "mid": mid("decoder"), "up": []}
    for i in range(n_res):
        level = {"block": [resnet(f"decoder.up.{i}.block.{j}") for j in range(cfg.num_res_blocks + 1)]}
        if f"decoder.up.{i}.upsample.conv.weight" in sd:
            level["upsample"] = {"conv": conv(f"decoder.up.{i}.upsample.conv")}
        dec["up"].append(level)
    dec.update(norm_out=gn("decoder.norm_out"), conv_out=conv("decoder.conv_out"))

    if fatal:
        raise KeyError(f"ae checkpoint {path}: missing tensors whose shapes cannot be inferred: "
                       f"{sorted(set(fatal))}")
    report.finish(sd.keys(), strict=strict)
    return ParamTree({"encoder": enc, "decoder": dec})


# ------------------------------------------------ prequantized export (JAX file layout)

PREQUANT_FORMAT = "flux-fp8-api-tpu/prequant-v1"
_LINEAR_FIELDS = ("kernel", "q", "w_scale", "w_scale_inv", "in_scale", "in_scale_inv", "bias")
# JAX (in, out) fields that are the port's (out, in) transposed
_TRANSPOSED = ("kernel", "q")


def _field(lin: Linear, name: str) -> Optional[torch.Tensor]:
    t = getattr(lin, "weight" if name == "kernel" else name)
    return None if t is None else (t.t() if name in _TRANSPOSED else t)


def _flux_leaves(model: ParamTree):
    """(dotted path, [Linear or tensor per block]) over the flux tree in order; a
    leaf outside the depth stacks is a list of one."""
    for key, value in model.items():
        if isinstance(value, torch.nn.ModuleList):
            for name, _ in value[0].items():
                yield f"{key}.{name}", [blk[name] for blk in value]
        elif isinstance(value, ParamTree):
            for name, sub in value.items():
                if isinstance(sub, Linear):
                    yield f"{key}.{name}", [sub]
        elif isinstance(value, Linear):
            yield key, [value]


def save_prequantized(path, model: ParamTree, extra_meta: Optional[Dict[str, str]] = None) -> None:
    """Write a quantized, calibrated flux model — quantized data and every scale — in
    the JAX package's prequant layout, so a reload skips quantization and calibration
    (the reference's prequantized workflow: float8_quantize.py:91-193,
    README.md:186-192). The depth stacks are stacked on the model's device (one more
    copy of the flow there), then written one tensor at a time."""
    tensors: Dict[str, torch.Tensor] = {}
    linears: Dict[str, str] = {}
    for key, leaves in _flux_leaves(model):
        stacked = key.split(".")[0] in ("double_blocks", "single_blocks")
        first = leaves[0]
        if isinstance(first, Linear):
            linears[key] = first.kind
            for fld in _LINEAR_FIELDS:
                if _field(first, fld) is not None:
                    parts = [_field(lin, fld) for lin in leaves]
                    tensors[f"{key}.{fld}"] = torch.stack(parts) if stacked else parts[0]
        else:
            tensors[key] = torch.stack(leaves) if stacked else first
    meta = {"format": PREQUANT_FORMAT, "linears": json.dumps(linears)}
    meta.update(extra_meta or {})
    save_safetensors(path, tensors, metadata=meta)


def load_prequantized(path_or_file, cfg: FluxStatic, device=None,
                      leaf_fn: Optional[LeafFn] = None, keep=None) -> ParamTree:
    """Reload a ``flux-fp8-api-tpu/prequant-v1`` file, written by either package,
    into the port's model on ``device`` (default cuda:0, ``into_device``), one block
    slice at a time. ``leaf_fn(path, lin)`` transforms each Linear as it is read (a
    mesh rank relayouts it and keeps its slice, so the whole tree is never held);
    ``keep`` as in :func:`assemble_flux` (a pp stage reads its blocks only)."""
    device = into_device(device)
    f = _as_stf(path_or_file)
    if f.metadata.get("format") != PREQUANT_FORMAT:
        raise ValueError(f"{f.path} is not a {PREQUANT_FORMAT} checkpoint")
    linears = json.loads(f.metadata["linears"])

    def read(name, block, transpose=False):
        t = f.get(name)
        t = (t if block is None else t[block]).to(device)
        # moved, then transposed: a host transpose of every kernel is the slow part
        # of a full-size load
        return t.t().contiguous() if transpose else t

    def linear(path, block):
        key = ".".join(path)
        fields = {fld: read(f"{key}.{fld}", block, fld in _TRANSPOSED)
                  for fld in _LINEAR_FIELDS if f"{key}.{fld}" in f}
        fields["weight"] = fields.pop("kernel", None)
        lin = Linear(linears[key], **fields)
        return lin if leaf_fn is None else leaf_fn(path, lin)

    def norm(path, block):
        return read(".".join(path), block)

    return assemble_flux(cfg, linear, norm, keep)

