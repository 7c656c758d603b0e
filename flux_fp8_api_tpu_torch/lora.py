"""LoRA hot-load and unload for the flow transformer (JAX counterpart:
``flux_fp8_api_tpu.lora``, its serving half; reference ``lora_loading.py``).

- **two input formats** (lora_loading.py:580-605): diffusers checkpoints
  (``transformer.*`` keys, :func:`convert_diffusers_to_bfl`, which concatenates the
  q/k/v(/mlp) factors into the fused qkv and linear1 layers, zero-filling a missing
  member) and kohya (``lora_unet_*``, :func:`convert_kohya_to_bfl`);
- **delta math** (lora_loading.py:509-544): fp32 ``scale · B @ A`` with alpha/rank
  scaling and the uneven-rank chunked sum, on the weight's device;
- **fuse** (lora_loading.py:615-689): a quantized Linear is dequantized, the delta
  added, and the sum quantized again to the same kind with a fresh weight scale and
  the calibrated input scale kept (float8_quantize.py:209-212); a float Linear gets
  ``W + delta`` in its own dtype;
- **registry** (flux_model.py:621-670): dedupe by path or name; the same scale is a
  no-op; a new scale unfuses the old and fuses the new; unfuse is a fuse at ``-scale``.

The port's blocks are per-block modules, so ``double_blocks.3.img_attn.qkv`` names
``model["double_blocks"][3]["img_attn_qkv"]``, which is replaced by a new Linear.
Deltas arrive in the checkpoint's interleaved rope layout; the rows of a qkv or
linear1 delta are permuted into the runtime's half-split layout first. Only the flat
fused layout exists here (the grouped one is multi-GPU work).

The second half makes LoRAs (JAX lora.py:517-647): trainable rank-r adapters on a
frozen, typically quantized base (:func:`init_lora_adapters`), attached to a skeleton
copy of the tree for the train step (:func:`merge_lora_adapters`), and exported as a
kohya ``lora_unet_*`` file that :func:`pipeline_load_lora` (and the reference) loads
(:func:`save_lora_adapters`).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .models.flux import FluxStatic
from .ops.quant import Linear, dequantize_kernel, with_kernel
from .utils.checkpoint import grouped_permutations, qkv_out_permutation
from .utils.safetensors_io import load_safetensors, save_safetensors
from .utils.tree import ParamTree

logger = logging.getLogger(__name__)

StateDict = Dict[str, torch.Tensor]

_PATH_SPLIT = re.compile(r"/|\\")


@dataclasses.dataclass
class LoraWeights:
    """reference LoraWeights (lora_loading.py:21-32): BFL-space factors on the host."""

    weights: StateDict
    path: str
    name: Optional[str] = None
    scale: float = 1.0

    def __post_init__(self):
        if not self.name:
            self.name = _PATH_SPLIT.split(str(self.path))[-1]


# ---------------------------------------------------------------- format conversion


def _move(out: StateDict, sd: StateDict, src_stub: str, dst_stub: str) -> None:
    """Move every key sharing src_stub's module prefix (lora_A/B/alpha variants) into
    the BFL namespace (reference convert_if_lora_exists, lora_loading.py:42-60)."""
    stub = src_stub.replace(".weight", "")
    for k in [k for k in sd if stub in k]:
        out[k.replace(stub, dst_stub.replace(".weight", ""))] = sd.pop(k)


def _pop_pair(sd: StateDict, prefix: str):
    return sd.pop(f"{prefix}.lora_A.weight", None), sd.pop(f"{prefix}.lora_B.weight", None)


def _concat_members(pairs, out_dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concatenate members' A and B factors along dim 0; a missing member is zeros with
    the present members' rank and its own ``out_dims`` rows of B."""
    a0, b0 = next(p for p in pairs if p[0] is not None)
    a_parts, b_parts = [], []
    for (a, b), out_dim in zip(pairs, out_dims):
        if a is None:
            a = torch.zeros(a0.shape, dtype=a0.dtype)
            b = torch.zeros((out_dim,) + tuple(b0.shape[1:]), dtype=b0.dtype)
        a_parts.append(a)
        b_parts.append(b)
    return torch.cat(a_parts, 0), torch.cat(b_parts, 0)


def convert_diffusers_to_bfl(
    sd: StateDict,
    num_layers: int = 19,
    num_single_layers: int = 38,
    has_guidance: bool = True,
    prefix: str = "transformer.",
) -> StateDict:
    """diffusers ``transformer.*`` LoRA → BFL key space (reference lora_loading.py:62-432)."""
    sd = dict(sd)
    out: StateDict = {}

    _move(out, sd, f"{prefix}time_text_embed.timestep_embedder.linear_1.weight", "time_in.in_layer.weight")
    _move(out, sd, f"{prefix}time_text_embed.timestep_embedder.linear_2.weight", "time_in.out_layer.weight")
    _move(out, sd, f"{prefix}time_text_embed.text_embedder.linear_1.weight", "vector_in.in_layer.weight")
    _move(out, sd, f"{prefix}time_text_embed.text_embedder.linear_2.weight", "vector_in.out_layer.weight")
    if has_guidance:
        _move(out, sd, f"{prefix}time_text_embed.guidance_embedder.linear_1.weight", "guidance_in.in_layer.weight")
        _move(out, sd, f"{prefix}time_text_embed.guidance_embedder.linear_2.weight", "guidance_in.out_layer.weight")
    _move(out, sd, f"{prefix}context_embedder.weight", "txt_in.weight")
    _move(out, sd, f"{prefix}x_embedder.weight", "img_in.weight")

    for i in range(num_layers):
        bp = f"{prefix}transformer_blocks.{i}."
        _move(out, sd, f"{bp}norm1.linear.weight", f"double_blocks.{i}.img_mod.lin.weight")
        _move(out, sd, f"{bp}norm1_context.linear.weight", f"double_blocks.{i}.txt_mod.lin.weight")
        # fused qkv (lora_loading.py:142-260): q, k and v members all have out = hidden
        for members, target in (
            (("to_q", "to_k", "to_v"), f"double_blocks.{i}.img_attn.qkv"),
            (("add_q_proj", "add_k_proj", "add_v_proj"), f"double_blocks.{i}.txt_attn.qkv"),
        ):
            pairs = [_pop_pair(sd, f"{bp}attn.{m}") for m in members]
            present = [p for p in pairs if p[0] is not None]
            if present:
                hidden = present[0][1].shape[0]
                a, b = _concat_members(pairs, (hidden,) * 3)
                out[f"{target}.lora_A.weight"], out[f"{target}.lora_B.weight"] = a, b
        _move(out, sd, f"{bp}attn.norm_q.weight", f"double_blocks.{i}.img_attn.norm.query_norm.scale")
        _move(out, sd, f"{bp}attn.norm_k.weight", f"double_blocks.{i}.img_attn.norm.key_norm.scale")
        _move(out, sd, f"{bp}attn.norm_added_q.weight", f"double_blocks.{i}.txt_attn.norm.query_norm.scale")
        _move(out, sd, f"{bp}attn.norm_added_k.weight", f"double_blocks.{i}.txt_attn.norm.key_norm.scale")
        _move(out, sd, f"{bp}ff.net.0.proj.weight", f"double_blocks.{i}.img_mlp.0.weight")
        _move(out, sd, f"{bp}ff.net.2.weight", f"double_blocks.{i}.img_mlp.2.weight")
        _move(out, sd, f"{bp}ff_context.net.0.proj.weight", f"double_blocks.{i}.txt_mlp.0.weight")
        _move(out, sd, f"{bp}ff_context.net.2.weight", f"double_blocks.{i}.txt_mlp.2.weight")
        _move(out, sd, f"{bp}attn.to_out.0.weight", f"double_blocks.{i}.img_attn.proj.weight")
        _move(out, sd, f"{bp}attn.to_add_out.weight", f"double_blocks.{i}.txt_attn.proj.weight")

    for i in range(num_single_layers):
        bp = f"{prefix}single_transformer_blocks.{i}."
        _move(out, sd, f"{bp}norm.linear.weight", f"single_blocks.{i}.modulation.lin.weight")
        # fused linear1 = q|k|v|mlp_in (lora_loading.py:330-401). Its members differ in
        # out dim (hidden for q/k/v, 4·hidden for proj_mlp), so a missing member is
        # zero-filled at its own out dim, with hidden inferred from whichever member is
        # present; the reference reuses the last present member's shape, which breaks
        # an attention-only or mlp-only LoRA.
        pairs = [_pop_pair(sd, f"{bp}{m}") for m in ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")]
        present = [p for p in pairs[:3] if p[0] is not None]
        if present or pairs[3][0] is not None:
            hidden = present[0][1].shape[0] if present else pairs[3][1].shape[0] // 4
            a, b = _concat_members(pairs, (hidden,) * 3 + (4 * hidden,))
            out[f"single_blocks.{i}.linear1.lora_A.weight"] = a
            out[f"single_blocks.{i}.linear1.lora_B.weight"] = b
        _move(out, sd, f"{bp}proj_out.weight", f"single_blocks.{i}.linear2.weight")

    _move(out, sd, f"{prefix}proj_out.weight", "final_layer.linear.weight")
    _move(out, sd, f"{prefix}norm_out.linear.weight", "final_layer.adaLN_modulation.1.weight")
    return out


def convert_kohya_to_bfl(sd: StateDict) -> StateDict:
    """kohya ``lora_unet_*`` LoRA → BFL key space (reference lora_loading.py:435-463)."""
    return {
        k.replace("lora_unet_", "")
        .replace("double_blocks_", "double_blocks.")
        .replace("single_blocks_", "single_blocks.")
        .replace("_img_attn_", ".img_attn.")
        .replace("_txt_attn_", ".txt_attn.")
        .replace("_img_mod_", ".img_mod.")
        .replace("_txt_mod_", ".txt_mod.")
        .replace("_img_mlp_", ".img_mlp.")
        .replace("_txt_mlp_", ".txt_mlp.")
        .replace("_linear1", ".linear1")
        .replace("_linear2", ".linear2")
        .replace("_modulation_", ".modulation.")
        .replace("lora_up", "lora_B")
        .replace("lora_down", "lora_A"): v
        for k, v in sd.items()
        if "lora" in k
    }


def _module_keys(sd: StateDict) -> List[str]:
    return sorted({
        k.replace(".lora_A.weight", "").replace(".lora_B.weight", "")
        .replace(".lora_A", "").replace(".lora_B", "").replace(".alpha", "")
        for k in sd
    })


def resolve_lora_state_dict(sd: StateDict, has_guidance: bool = True) -> Tuple[List[str], StateDict]:
    """Normalize either format into BFL key space and list the touched modules
    (reference lora_loading.py:580-605)."""
    if any(k.startswith("transformer.") for k in sd):
        sd = convert_diffusers_to_bfl(sd, 19, 38, has_guidance=has_guidance)
    else:
        sd = convert_kohya_to_bfl(sd)
    return _module_keys(sd), sd


# ------------------------------------------------------------------------ delta math


def calculate_lora_delta(lora_A: torch.Tensor, lora_B: torch.Tensor, alpha, lora_scale: float = 1.0,
                         device=None) -> torch.Tensor:
    """fp32 ``scale · B @ A`` (out, in) on ``device`` (reference calculate_lora_weight,
    lora_loading.py:509-544). A is scaled by alpha/rank first; an A with more rows
    than B has columns (a fused-qkv concat) is split into rank-row chunks whose
    products are summed."""
    A = lora_A.to(device, torch.float32)
    B = lora_B.to(device, torch.float32)
    rank = B.shape[1]
    # alpha ships as a 0-d scalar in most files but (1,) in some exporters
    alpha = rank if alpha is None else float(torch.as_tensor(alpha).reshape(-1)[0])
    if alpha != rank:
        A = A * (alpha / rank)
    if A.shape[0] != rank:
        delta = torch.zeros((B.shape[0], A.shape[1]), dtype=torch.float32, device=A.device)
        for chunk in torch.split(A, rank, dim=0):
            delta = delta + lora_scale * (B @ chunk)
        return delta
    return lora_scale * (B @ A)


# -------------------------------------------------------------------- tree addressing

# BFL leaf name in a block → the port's (and the JAX tree's) leaf name
_BLOCK_LEAF_BY_BFL = {
    "img_mod.lin": "img_mod_lin",
    "txt_mod.lin": "txt_mod_lin",
    "img_attn.qkv": "img_attn_qkv",
    "img_attn.proj": "img_attn_proj",
    "txt_attn.qkv": "txt_attn_qkv",
    "txt_attn.proj": "txt_attn_proj",
    "img_mlp.0": "img_mlp_0",
    "img_mlp.2": "img_mlp_2",
    "txt_mlp.0": "txt_mlp_0",
    "txt_mlp.2": "txt_mlp_2",
    "linear1": "linear1",
    "linear2": "linear2",
    "modulation.lin": "mod_lin",
}
_TOP_PATHS = {
    "img_in": ("img_in",),
    "txt_in": ("txt_in",),
    "time_in.in_layer": ("time_in", "in_layer"),
    "time_in.out_layer": ("time_in", "out_layer"),
    "vector_in.in_layer": ("vector_in", "in_layer"),
    "vector_in.out_layer": ("vector_in", "out_layer"),
    "guidance_in.in_layer": ("guidance_in", "in_layer"),
    "guidance_in.out_layer": ("guidance_in", "out_layer"),
    "final_layer.linear": ("final_layer", "linear"),
    "final_layer.adaLN_modulation.1": ("final_layer", "adaln"),
}


def _locate(model: ParamTree, key: str, cfg: Optional[FluxStatic] = None) -> Optional[Tuple[ParamTree, str]]:
    """(parent module, leaf name) of the Linear a BFL module key names, or None where
    the model has no such Linear (a block index past its depth, guidance_in on
    schnell, a key the tree does not hold, a block of another pp stage). Block indices
    are global: a pp stage's stack holds its slice (``parallel/mesh.py:stage_blocks``)."""
    m = re.match(r"(double_blocks|single_blocks)\.(\d+)\.(.+)", key)
    if m:
        stack, idx, name = model[m.group(1)], int(m.group(2)), _BLOCK_LEAF_BY_BFL.get(m.group(3))
        if cfg is not None and cfg.mesh is not None:
            from .parallel.mesh import stage_blocks

            keep = stage_blocks(cfg.depth if m.group(1) == "double_blocks" else cfg.depth_single_blocks, cfg.mesh)
            idx = idx - keep.start if idx in keep else len(stack)
        if name is None or idx >= len(stack):
            return None
        return stack[idx], name
    path = _TOP_PATHS.get(key)
    if path is None:
        return None
    node = model
    for p in path[:-1]:
        node = node.get(p)
        if node is None:
            return None
    return (node, path[-1]) if isinstance(node.get(path[-1]), Linear) else None


# ------------------------------------------------------------------------- fuse/unfuse


@torch.no_grad()
def fuse_lora(model: ParamTree, cfg: FluxStatic, lora_sd: StateDict, keys: List[str],
              lora_scale: float) -> ParamTree:
    """Fuse every LoRA-touched Linear in place: W ← W + scale·B@A (reference
    apply_lora_to_model, lora_loading.py:634-693); a negative scale unfuses. Each
    touched Linear is replaced by a new one, so tensors frozen under inference mode
    (the calibrated input scales) are never written in place. The new tensors are made
    outside inference mode, as the loaded weights they replace were: a compiled block
    guards on that, and a fused block then runs the same graph. Each fuse runs on its
    weight's device: the host for an offloaded flow, whose new tensors are not
    page-locked until the pipeline's stream state is rebuilt. Returns the model.

    In the grouped layout (tensor parallelism) the delta's qkv/linear1 rows take the
    head-major regroup after the rope deinterleave, and linear2's columns the grouped
    in-permutation (JAX lora.py:350-390); each rank then fuses the slice of the delta
    that its shard of the weight holds (``with_kernel`` takes the fresh scales from
    the whole weight)."""
    grouped = cfg.fused_layout == "grouped"
    perms = grouped_permutations(cfg) if grouped else {}
    qkv_perm = lin1_perm = None
    for key in keys:
        a, b = lora_sd.get(f"{key}.lora_A.weight"), lora_sd.get(f"{key}.lora_B.weight")
        if a is None or b is None:
            continue  # plain-weight keys (e.g. qk-norm scales) are skipped, as the
            # reference's get_lora_for_key → None path does (lora_loading.py:686)
        where = _locate(model, key, cfg)
        if where is None:
            continue
        parent, name = where
        lin = parent[name]
        device = (lin.weight if lin.weight is not None else lin.q).device
        delta = calculate_lora_delta(a, b, lora_sd.get(f"{key}.alpha"), lora_scale, device)
        if key.endswith((".img_attn.qkv", ".txt_attn.qkv")) and delta.shape[0] == 3 * cfg.hidden_size:
            if qkv_perm is None:
                qkv_perm = qkv_out_permutation(cfg.hidden_size, cfg.head_dim)
                if grouped:  # perm_total = flat[grouped], as in JAX
                    qkv_perm = qkv_perm[perms["img_attn_qkv"][1]]
                qkv_perm = torch.as_tensor(qkv_perm)
            delta = delta[qkv_perm.to(device)]
        elif key.endswith(".linear1") and delta.shape[0] == 3 * cfg.hidden_size + cfg.mlp_hidden:
            if lin1_perm is None:
                lin1_perm = qkv_out_permutation(cfg.hidden_size, cfg.head_dim, extra=cfg.mlp_hidden)
                if grouped:
                    lin1_perm = lin1_perm[perms["linear1"][1]]
                lin1_perm = torch.as_tensor(lin1_perm)
            delta = delta[lin1_perm.to(device)]
        elif grouped and key.endswith(".linear2") and delta.shape[1] == cfg.hidden_size + cfg.mlp_hidden:
            delta = delta[:, torch.as_tensor(perms["linear2"][1]).to(device)]
        if lin.shard is not None:  # this rank's slice of the delta, as of the weight
            mesh, axis = lin.shard.mesh, lin.shard.axis
            dim, size = (0 if lin.shard.mode == "col" else 1), mesh.size(axis)
            n = delta.shape[dim] // size
            delta = delta.narrow(dim, mesh.rank(axis) * n, n)
        setattr(parent, name, with_kernel(lin, dequantize_kernel(lin) + delta))
    return model


# ----------------------------------------------------------------- pipeline registry


def _resolve(lora_input, has_guidance: bool) -> Tuple[List[str], StateDict]:
    """A path (read with the port's safetensors reader), a state dict or a LoraWeights
    (reference lora_loading.py:608-612) → (module keys, BFL-space state dict). A dict
    still in diffusers/kohya key space is converted, as a file is (the reference would
    fuse nothing)."""
    if isinstance(lora_input, LoraWeights):
        weights = lora_input.weights
    elif isinstance(lora_input, dict):
        weights = lora_input
    else:
        weights = load_safetensors(str(lora_input))
    if any(k.startswith(("transformer.", "lora_unet_")) for k in weights):
        return resolve_lora_state_dict(weights, has_guidance)
    return _module_keys(weights), weights


def pipeline_load_lora(model: ParamTree, cfg: FluxStatic, registry: List[LoraWeights], lora_path,
                       scale: float, name: Optional[str] = None) -> Tuple[ParamTree, List[LoraWeights]]:
    """Flux.load_lora semantics (flux_model.py:631-653): dedupe by path or name; the
    same scale is a no-op; a new scale unfuses the old and fuses the new."""
    ident = lora_path if isinstance(lora_path, str) else (name or "<dict>")
    existing = next((entry for entry in registry if entry.path == ident or entry.name == ident), None)
    if existing is not None:
        if existing.scale == scale:
            logger.warning("LoRA %s already loaded with the same scale - ignoring", existing.name)
            return model, registry
        keys = _module_keys(existing.weights)
        fuse_lora(model, cfg, existing.weights, keys, -existing.scale)
        fuse_lora(model, cfg, existing.weights, keys, scale)
        existing.scale = scale
        return model, registry
    keys, sd = _resolve(lora_path, cfg.guidance_embed)
    logger.info("loading LoRA %s (scale=%s, %d modules)", ident, scale, len(keys))
    fuse_lora(model, cfg, sd, keys, scale)
    return model, registry + [LoraWeights(sd, ident, name, scale)]


def pipeline_unload_lora(model: ParamTree, cfg: FluxStatic, registry: List[LoraWeights],
                         path_or_identifier: str) -> Tuple[ParamTree, List[LoraWeights]]:
    """Flux.unload_lora semantics (flux_model.py:655-670): unknown names are a no-op
    with a warning."""
    for i, entry in enumerate(registry):
        if entry.path == path_or_identifier or entry.name == path_or_identifier:
            fuse_lora(model, cfg, entry.weights, _module_keys(entry.weights), -entry.scale)
            logger.info("LoRA %s unfused", entry.name)
            return model, registry[:i] + registry[i + 1:]
    logger.warning("could not remove LoRA %s: it is not fused into the model", path_or_identifier)
    return model, registry


# ------------------------------------------------------ trainable adapters (QLoRA)
#
# Adapters are ``{stack: [{leaf: {"a": (r, in), "b": (out, r)}} per block]}``: the JAX
# package's stacked (D, in, r) / (D, r, out) split per block and transposed into
# torch's lora_down / lora_up convention (utils/convert.py:convert_adapters carries JAX
# adapters across). The alpha/rank scale is folded into the parametrization: the side
# branch applies (x·Aᵀ)·Bᵀ unscaled and the export writes alpha = rank.

DEFAULT_ADAPTER_TARGETS: Dict[str, Tuple[str, ...]] = {
    "double_blocks": (
        "img_attn_qkv", "txt_attn_qkv", "img_attn_proj", "txt_attn_proj",
        "img_mlp_0", "img_mlp_2", "txt_mlp_0", "txt_mlp_2",
    ),
    "single_blocks": ("linear1", "linear2"),
}

Adapters = Dict[str, List[Dict[str, Dict[str, torch.Tensor]]]]


def _out_features(lin: Linear) -> int:
    return (lin.weight if lin.weight is not None else lin.q).shape[0]


def init_lora_adapters(
    model: ParamTree,
    rank: int,
    generator: torch.Generator,
    targets: Optional[Dict[str, Tuple[str, ...]]] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Adapters:
    """Fresh adapters on ``generator``'s device, each a leaf that requires grad: A drawn
    N(0, 1/in) in fp32 and cast, B zeros, so the merged model is the base model at step
    0 (JAX lora.py:550-578). ``in`` is the true in width of packed kinds (int4 holds
    in/2 bytes per row)."""
    targets = DEFAULT_ADAPTER_TARGETS if targets is None else targets
    device = generator.device
    adapters: Adapters = {}
    for stack, names in targets.items():
        blocks = []
        for blk in model[stack]:
            entry = {}
            for name in names:
                lin = blk[name]
                in_f, out_f = lin.in_features, _out_features(lin)
                a = torch.randn((rank, in_f), generator=generator, device=device) * (in_f**-0.5)
                entry[name] = {
                    "a": a.to(dtype).requires_grad_(),
                    "b": torch.zeros((out_f, rank), dtype=dtype, device=device).requires_grad_(),
                }
            blocks.append(entry)
        adapters[stack] = blocks
    return adapters


def adapter_tensors(adapters: Adapters) -> List[torch.Tensor]:
    """Every adapter tensor, in a fixed order: stack, block, leaf, then a before b."""
    return [ab[k] for stack in adapters.values() for entry in stack for ab in entry.values() for k in ("a", "b")]


def merge_lora_adapters(model: ParamTree, adapters: Adapters) -> ParamTree:
    """A skeleton copy of ``model`` whose targeted Linears carry the adapters as
    ``lora_a``/``lora_b`` (JAX lora.py:581-592). Every base tensor is shared, not
    copied; only the modules on the way to a touched Linear are new, so ``model``
    itself is left without adapters."""

    def shallow(module):
        clone = copy.copy(module)
        clone._modules = dict(module._modules)
        clone._buffers = dict(module._buffers)
        return clone

    out = shallow(model)
    for stack, blocks in adapters.items():
        new_stack = shallow(model[stack])
        for i, entry in enumerate(blocks):
            blk = shallow(new_stack[i])
            for name, ab in entry.items():
                lin = shallow(blk[name])
                lin._buffers["lora_a"], lin._buffers["lora_b"] = ab["a"], ab["b"]
                blk._modules[name] = lin
            new_stack._modules[str(i)] = blk
        out._modules[stack] = new_stack
    return out


def export_lora_adapters(adapters: Adapters, cfg: FluxStatic) -> StateDict:
    """Trained adapters → a kohya ``lora_unet_*`` state dict in fp32 (JAX
    lora.py:595-640): ``lora_down.weight`` (r, in), ``lora_up.weight`` (out, r),
    ``alpha`` = rank, so every consumer applies scale 1. The rows of a qkv or linear1
    B go back into the checkpoint's interleaved rope layout: the inverse of the
    permutation that :func:`fuse_lora` applies at load: in the grouped layout the
    head-major regroup as well, and linear2's A columns its grouped in-permutation
    (JAX lora.py:592-620)."""
    qkv_perm = qkv_out_permutation(cfg.hidden_size, cfg.head_dim)
    lin1_perm = qkv_out_permutation(cfg.hidden_size, cfg.head_dim, extra=cfg.mlp_hidden)
    inv_lin2_in = None
    if cfg.fused_layout == "grouped":
        perms = grouped_permutations(cfg)
        qkv_perm, lin1_perm = qkv_perm[perms["img_attn_qkv"][1]], lin1_perm[perms["linear1"][1]]
        inv_lin2_in = np.argsort(perms["linear2"][1])
    inv_qkv, inv_lin1 = np.argsort(qkv_perm), np.argsort(lin1_perm)
    bfl_by_leaf = {v: k for k, v in _BLOCK_LEAF_BY_BFL.items()}
    sd: StateDict = {}
    for stack, blocks in adapters.items():
        for i, entry in enumerate(blocks):
            for name, ab in entry.items():
                a = ab["a"].detach().float().cpu()
                b = ab["b"].detach().float().cpu()
                if name in ("img_attn_qkv", "txt_attn_qkv"):
                    b = b[torch.as_tensor(inv_qkv)]
                elif name == "linear1":
                    b = b[torch.as_tensor(inv_lin1)]
                elif name == "linear2" and inv_lin2_in is not None:
                    a = a[:, torch.as_tensor(inv_lin2_in)]
                stem = f"lora_unet_{stack}_{i}_{bfl_by_leaf[name].replace('.', '_')}"
                sd[f"{stem}.lora_down.weight"] = a.contiguous()
                sd[f"{stem}.lora_up.weight"] = b.contiguous()
                sd[f"{stem}.alpha"] = torch.tensor(float(a.shape[0]), dtype=torch.float32)
    return sd


def save_lora_adapters(path: str, adapters: Adapters, cfg: FluxStatic) -> None:
    """Export and write a safetensors file that any FLUX LoRA consumer loads."""
    save_safetensors(str(path), export_lora_adapters(adapters, cfg))
