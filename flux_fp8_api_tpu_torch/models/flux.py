"""FLUX.1 flow transformer (JAX counterpart: ``flux_fp8_api_tpu.models.flux``).

The model is a :class:`~..utils.tree.ParamTree` with the JAX tree's names:
``img_in``, ``txt_in``, ``time_in``/``vector_in``/``guidance_in`` (``in_layer``,
``out_layer``), ``double_blocks`` and ``single_blocks`` as ``nn.ModuleList``s of
per-block trees, and ``final_layer`` (``linear``, ``adaln``). The depth stacks run
as Python loops where the JAX package scans stacked leaves. Both fused layouts run:
``flat`` on one rank, ``grouped`` (head-major) under tensor parallelism, where each
rank's qkv, linear1 and linear2 hold only its heads and every head count below is
read from the tensors (``parallel/mesh.py``).

Quantization tiers (``fp8``, ``int8``, ``int4``) follow the reference's partition
(float8_quantize.py:320-369,395-496): ``final_layer`` never, modulation linears gated
by ``quantize_modulation``, embedders gated by ``quantize_flow_embedder_layers``,
every other block linear always.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.math import (
    clamp_policy,
    gelu_tanh,
    layer_norm,
    modulate,
    rms_norm,
    silu,
    timestep_embedding,
)
from ..ops.quant import FLOW_QUANTIZERS, Linear, linear_apply, tp_copy
from ..ops.rope import embed_nd_cos_sin
from ..utils.config import FluxParams, into_dtype
from ..utils.tree import ParamTree

@dataclasses.dataclass(frozen=True)
class FluxStatic:
    """Static model configuration (derived from FluxParams + ModelSpec)."""

    in_channels: int
    vec_in_dim: int
    context_in_dim: int
    hidden_size: int
    mlp_hidden: int
    num_heads: int
    depth: int
    depth_single_blocks: int
    axes_dim: Tuple[int, ...]
    theta: int
    qkv_bias: bool
    guidance_embed: bool
    compute_dtype: str = "bfloat16"  # "float16" turns on the ±32000 clamps
    # torch._scaled_mm use_fast_accum for fp8 linears (ModelSpec.fp8_fast_accum)
    fp8_fast_accum: bool = True
    # the attention path (ModelSpec.use_pallas): the max-free kernel, or
    # F.scaled_dot_product_attention (ops/attention.py:attention_core)
    use_pallas: bool = True
    # rematerialize block activations under autograd: with grad enabled each double and
    # single block runs under torch.utils.checkpoint, so backward recomputes the block
    # instead of holding its activations and dequantized weights (JAX flux.py:82-86,
    # jax.checkpoint on the scan bodies). Forward values are unchanged.
    remat: bool = False
    # run the fp8/int8/int4 linears through the differentiable dequantize path
    # (ops/quant.py linear_apply ``dequant``): the QLoRA training forward. Serving
    # configs keep it off (JAX flux.py:87-93).
    dequant_linears: bool = False
    # fused qkv/linear1/linear2 channel layout (JAX flux.py:73-79): "flat" (the
    # reference's order, one rank) or "grouped" (head-major, tensor parallelism;
    # utils/checkpoint.py:relayout_flux_tree). The tree and this field must agree.
    fused_layout: str = "flat"
    # the mesh axes the attention's folded batch·head axis is split over (JAX
    # flux.py:71-80): informational here, where each rank's heads are local already
    attn_shard_axes: Optional[Tuple[str, ...]] = None
    # the mesh axis of sequence parallelism: each rank runs its L/sp rows of q against
    # the full k and v and the rows are all-gathered (ops/attention.py)
    attn_seq_axis: Optional[str] = None
    # the parallel.mesh.Mesh that attn_seq_axis names (not part of the configuration's
    # identity)
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def from_params(
        cls, p: FluxParams, compute_dtype: str = "bfloat16", fp8_fast_accum: bool = True,
        use_pallas: bool = True,
    ) -> "FluxStatic":
        head_dim = p.hidden_size // p.num_heads
        if p.hidden_size % p.num_heads != 0:
            raise ValueError(
                f"Hidden size {p.hidden_size} must be divisible by num_heads {p.num_heads}"
            )
        if sum(p.axes_dim) != head_dim:
            raise ValueError(f"Got {p.axes_dim} but expected positional dim {head_dim}")
        return cls(
            in_channels=p.in_channels,
            vec_in_dim=p.vec_in_dim,
            context_in_dim=p.context_in_dim,
            hidden_size=p.hidden_size,
            mlp_hidden=int(p.hidden_size * p.mlp_ratio),
            num_heads=p.num_heads,
            depth=p.depth,
            depth_single_blocks=p.depth_single_blocks,
            axes_dim=tuple(p.axes_dim),
            theta=p.theta,
            qkv_bias=p.qkv_bias,
            guidance_embed=p.guidance_embed,
            compute_dtype=compute_dtype,
            fp8_fast_accum=fp8_fast_accum,
            use_pallas=use_pallas,
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def dtype(self) -> torch.dtype:
        return into_dtype(self.compute_dtype)

    @property
    def do_clamp(self) -> bool:
        return self.compute_dtype == "float16"


# ------------------------------------------------------------------- tier quantization

EMBEDDER_PATHS = ("img_in", "txt_in", "time_in", "vector_in", "guidance_in")
MODULATION_LEAF_NAMES = ("img_mod_lin", "txt_mod_lin", "mod_lin")

# A leaf transform sees each Linear with its path in the tree, e.g. ("img_in",),
# ("time_in", "in_layer"), ("double_blocks", "img_mod_lin"), ("final_layer", "linear").
LeafFn = Callable[[Tuple[str, ...], Linear], Linear]


def quant_tier(
    kind: str = "fp8", quantize_modulation: bool = True, quantize_flow_embedder_layers: bool = False
) -> LeafFn:
    """A flow tier (``fp8``, ``int8`` or ``int4``) as a per-leaf transform, with the
    reference's partition rules (JAX flux.py:237-310)."""
    qfn = FLOW_QUANTIZERS[kind]

    def leaf(path: Tuple[str, ...], lin: Linear) -> Linear:
        if lin.kind != "float" or path[0] == "final_layer":
            return lin
        if path[0] in EMBEDDER_PATHS and not quantize_flow_embedder_layers:
            return lin
        if path[-1] in MODULATION_LEAF_NAMES and not quantize_modulation:
            return lin
        return qfn(lin.weight, lin.bias)

    return leaf


def _map_linears(tree: ParamTree, fn: LeafFn, prefix: Tuple[str, ...] = ()) -> None:
    """Replace every Linear of the tree by ``fn(path, lin)``, in place. Block lists
    contribute their stack name, not the block index, to the path."""
    for key, value in list(tree.items()):
        if isinstance(value, Linear):
            setattr(tree, key, fn(prefix + (key,), value))
        elif isinstance(value, ParamTree):
            _map_linears(value, fn, prefix + (key,))
        elif isinstance(value, torch.nn.ModuleList):
            for blk in value:
                _map_linears(blk, fn, prefix + (key,))


def quantize_flux_tree(
    model: ParamTree,
    quantize_modulation: bool = True,
    quantize_flow_embedder_layers: bool = False,
    kind: str = "fp8",
) -> ParamTree:
    """Quantize the tier's Linear leaves to ``kind``, in place (each block keeps its
    own scales, as each of the reference's F8Linears does). Returns the model."""
    _map_linears(model, quant_tier(kind, quantize_modulation, quantize_flow_embedder_layers))
    return model


# ------------------------------------------------------------------------- param init


def init_flux_params(
    cfg: FluxStatic,
    generator: torch.Generator,
    dtype: torch.dtype = torch.bfloat16,
    leaf_fn: Optional[LeafFn] = None,
    keep: Optional[Dict[str, range]] = None,
) -> ParamTree:
    """Random-init model on ``generator``'s device, built leaf by leaf: each Linear is
    drawn, passed through ``leaf_fn`` (e.g. :func:`quant_tier`) and only then is the next
    drawn, so a quantized model never holds the whole float tree at once. ``keep``:
    {stack: global block indices} kept (a pp stage's slice); the other blocks are
    drawn, so every stage draws the same weights, and dropped.

    Kernels follow the JAX init: U(±√(3/in)), biases U(±1/√in), norm scales ones.
    """
    keep = keep or {}
    device = generator.device

    def linear(path, in_f, out_f, bias=True):
        bound = (1.0 / in_f) ** 0.5
        w = torch.rand((out_f, in_f), generator=generator, device=device)
        w = ((w * 2 - 1) * (bound * 3**0.5)).to(dtype)
        b = None
        if bias:
            b = ((torch.rand((out_f,), generator=generator, device=device) * 2 - 1) * bound).to(dtype)
        lin = Linear("float", weight=w, bias=b)
        return leaf_fn(path, lin) if leaf_fn is not None else lin

    def ones():
        return torch.ones((cfg.head_dim,), dtype=dtype, device=device)

    def embedder(name, in_dim):
        return {
            "in_layer": linear((name, "in_layer"), in_dim, hs),
            "out_layer": linear((name, "out_layer"), hs, hs),
        }

    hs, mh = cfg.hidden_size, cfg.mlp_hidden

    def double_block():
        p = ("double_blocks",)
        return ParamTree({
            "img_mod_lin": linear(p + ("img_mod_lin",), hs, 6 * hs),
            "txt_mod_lin": linear(p + ("txt_mod_lin",), hs, 6 * hs),
            "img_attn_qkv": linear(p + ("img_attn_qkv",), hs, 3 * hs, bias=cfg.qkv_bias),
            "img_attn_proj": linear(p + ("img_attn_proj",), hs, hs),
            "txt_attn_qkv": linear(p + ("txt_attn_qkv",), hs, 3 * hs, bias=cfg.qkv_bias),
            "txt_attn_proj": linear(p + ("txt_attn_proj",), hs, hs),
            "img_mlp_0": linear(p + ("img_mlp_0",), hs, mh),
            "img_mlp_2": linear(p + ("img_mlp_2",), mh, hs),
            "txt_mlp_0": linear(p + ("txt_mlp_0",), hs, mh),
            "txt_mlp_2": linear(p + ("txt_mlp_2",), mh, hs),
            "img_attn_qnorm": ones(),
            "img_attn_knorm": ones(),
            "txt_attn_qnorm": ones(),
            "txt_attn_knorm": ones(),
        })

    def single_block():
        p = ("single_blocks",)
        return ParamTree({
            "linear1": linear(p + ("linear1",), hs, 3 * hs + mh),
            "linear2": linear(p + ("linear2",), hs + mh, hs),
            "mod_lin": linear(p + ("mod_lin",), hs, 3 * hs),
            "qnorm": ones(),
            "knorm": ones(),
        })

    return ParamTree({
        "img_in": linear(("img_in",), cfg.in_channels, hs),
        "txt_in": linear(("txt_in",), cfg.context_in_dim, hs),
        "time_in": embedder("time_in", 256),
        "vector_in": embedder("vector_in", cfg.vec_in_dim),
        "guidance_in": embedder("guidance_in", 256) if cfg.guidance_embed else None,
        "double_blocks": torch.nn.ModuleList(
            [b for i, b in ((i, double_block()) for i in range(cfg.depth))
             if i in keep.get("double_blocks", range(cfg.depth))]),
        "single_blocks": torch.nn.ModuleList(
            [b for i, b in ((i, single_block()) for i in range(cfg.depth_single_blocks))
             if i in keep.get("single_blocks", range(cfg.depth_single_blocks))]),
        "final_layer": {
            "linear": linear(("final_layer", "linear"), hs, cfg.in_channels),
            "adaln": linear(("final_layer", "adaln"), hs, 2 * hs),
        },
    })


# ------------------------------------------------------------------------------ apply


class _Tape:
    """Applies linears and, during calibration passes, records their input amaxes."""

    def __init__(self, collect: bool, fast_accum: bool = True, dequant: bool = False):
        self.collect = collect
        self.fast_accum = fast_accum
        self.dequant = dequant
        self.amaxes: Dict[str, torch.Tensor] = {}

    @classmethod
    def of(cls, cfg: "FluxStatic", collect: bool = False) -> "_Tape":
        return cls(collect, cfg.fp8_fast_accum, cfg.dequant_linears)

    def lin(self, name: str, lin: Linear, x: torch.Tensor, dtype) -> torch.Tensor:
        out, amax = linear_apply(lin, x, dtype, collect_amax=self.collect, fast_accum=self.fast_accum,
                                 dequant=self.dequant)
        if self.collect:
            self.amaxes[name] = amax
        return out


def _mlp_embedder(tape: _Tape, name: str, p, x, dtype):
    """out_layer(silu(in_layer(x))) (reference MLPEmbedder, flux_model.py:119-155)."""
    h = tape.lin(f"{name}.in_layer", p["in_layer"], x, dtype)
    return tape.lin(f"{name}.out_layer", p["out_layer"], silu(h), dtype)


def _split_qkv(qkv: torch.Tensor, head_dim: int, layout: str = "flat"):
    """(B, L, 3·N·H) → three (B, L, N, H) views (JAX flux.py:339-355), N read from the
    width (a tensor-parallel rank holds only its heads). ``flat``: the reference's
    K-major order (3, heads, hd); ``grouped``: head-major (heads, 3, hd)."""
    b, l, d3 = qkv.shape
    n = d3 // (3 * head_dim)
    if layout == "flat":
        qkv = qkv.reshape(b, l, 3, n, head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    qkv = qkv.reshape(b, l, n, 3, head_dim)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def _norm_scale(blk, name: str, lin: Linear) -> torch.Tensor:
    """A q/k-norm scale, shared by every head: under tp a rank applies it to its heads
    only, so its ∂ is summed over tp (``tp_copy``; the identity without a gradient)."""
    scale = blk[name]
    return scale if lin.shard is None else tp_copy(scale, lin.shard.mesh, lin.shard.axis)


def _attention(cfg: FluxStatic, q, k, v, cos, sin):
    return attention(q, k, v, cos, sin, use_pallas=cfg.use_pallas,
                     seq_mesh=cfg.mesh if cfg.attn_seq_axis else None, seq_axis=cfg.attn_seq_axis)


def _double_block(cfg: FluxStatic, blk, img, txt, vec_silu, cos, sin, tape: _Tape):
    """One DoubleStreamBlock (reference flux_model.py:356-400)."""
    dtype = cfg.dtype
    hd, layout = cfg.head_dim, cfg.fused_layout
    txt_len = txt.shape[1]

    img_mod = tape.lin("img_mod_lin", blk["img_mod_lin"], vec_silu, dtype)[:, None, :]
    txt_mod = tape.lin("txt_mod_lin", blk["txt_mod_lin"], vec_silu, dtype)[:, None, :]
    i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = img_mod.chunk(6, dim=-1)
    t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = txt_mod.chunk(6, dim=-1)

    img_modulated = modulate(layer_norm(img), i_shift1, i_scale1)
    img_q, img_k, img_v = _split_qkv(
        tape.lin("img_attn_qkv", blk["img_attn_qkv"], img_modulated, dtype), hd, layout
    )
    img_q = rms_norm(img_q, _norm_scale(blk, "img_attn_qnorm", blk["img_attn_qkv"]))
    img_k = rms_norm(img_k, _norm_scale(blk, "img_attn_knorm", blk["img_attn_qkv"]))

    txt_modulated = modulate(layer_norm(txt), t_shift1, t_scale1)
    txt_q, txt_k, txt_v = _split_qkv(
        tape.lin("txt_attn_qkv", blk["txt_attn_qkv"], txt_modulated, dtype), hd, layout
    )
    txt_q = rms_norm(txt_q, _norm_scale(blk, "txt_attn_qnorm", blk["txt_attn_qkv"]))
    txt_k = rms_norm(txt_k, _norm_scale(blk, "txt_attn_knorm", blk["txt_attn_qkv"]))

    # joint attention over concat(txt, img) (flux_model.py:380-385)
    q = torch.cat([txt_q, img_q], dim=1)
    k = torch.cat([txt_k, img_k], dim=1)
    v = torch.cat([txt_v, img_v], dim=1)
    attn = _attention(cfg, q, k, v, cos, sin)
    txt_attn, img_attn = attn[:, :txt_len], attn[:, txt_len:]

    img = img + i_gate1 * tape.lin("img_attn_proj", blk["img_attn_proj"], img_attn, dtype)
    img_mlp_in = modulate(layer_norm(img), i_shift2, i_scale2)
    img_mlp = tape.lin(
        "img_mlp_2", blk["img_mlp_2"],
        gelu_tanh(tape.lin("img_mlp_0", blk["img_mlp_0"], img_mlp_in, dtype)), dtype,
    )
    img = img + i_gate2 * img_mlp

    txt = txt + t_gate1 * tape.lin("txt_attn_proj", blk["txt_attn_proj"], txt_attn, dtype)
    txt_mlp_in = modulate(layer_norm(txt), t_shift2, t_scale2)
    txt_mlp = tape.lin(
        "txt_mlp_2", blk["txt_mlp_2"],
        gelu_tanh(tape.lin("txt_mlp_0", blk["txt_mlp_0"], txt_mlp_in, dtype)), dtype,
    )
    txt = txt + t_gate2 * txt_mlp
    return clamp_policy(img, cfg.do_clamp), clamp_policy(txt, cfg.do_clamp)


def _single_block(cfg: FluxStatic, blk, x, vec_silu, cos, sin, tape: _Tape):
    """One SingleStreamBlock (reference flux_model.py:467-485). In the grouped layout
    linear1's out-axis is [q_n | k_n | v_n | mlp_n] per head and linear2's in-axis
    [attn_n | mlp_n], so a tensor-parallel rank's slices hold whole heads with their
    mlp channels (JAX flux.py:428-460)."""
    dtype = cfg.dtype
    hd = cfg.head_dim
    g = cfg.mlp_hidden // cfg.num_heads  # mlp channels per head group

    mod = tape.lin("mod_lin", blk["mod_lin"], vec_silu, dtype)[:, None, :]
    shift, scale, gate = mod.chunk(3, dim=-1)
    x_mod = modulate(layer_norm(x), shift, scale)

    lin1 = tape.lin("linear1", blk["linear1"], x_mod, dtype)
    b, l, width = lin1.shape
    if cfg.fused_layout == "flat":
        q, k, v = _split_qkv(lin1[..., : 3 * cfg.hidden_size], hd)
        mlp = lin1[..., 3 * cfg.hidden_size:]
    else:
        lin1 = lin1.reshape(b, l, width // (3 * hd + g), 3 * hd + g)
        q, k, v = _split_qkv(lin1[..., : 3 * hd].reshape(b, l, -1), hd, "grouped")
        mlp = lin1[..., 3 * hd:]  # (B, L, N, g)
    q = rms_norm(q, _norm_scale(blk, "qnorm", blk["linear1"]))
    k = rms_norm(k, _norm_scale(blk, "knorm", blk["linear1"]))
    attn = _attention(cfg, q, k, v, cos, sin)

    if cfg.fused_layout == "flat":
        x2 = torch.cat([attn, gelu_tanh(mlp)], dim=-1)
    else:
        x2 = torch.cat([attn.reshape(b, l, -1, hd), gelu_tanh(mlp)], dim=-1).reshape(b, l, -1)
    out = tape.lin("linear2", blk["linear2"], x2, dtype)
    return clamp_policy(x + gate * out, cfg.do_clamp)


def max_logit_bound(model: ParamTree, cfg: FluxStatic) -> float:
    """Static bound on any attention |logit| the model can produce:
    √d · max|q-norm scale| · max|k-norm scale| over all stream pairs (see the JAX
    counterpart for the argument)."""

    def mx(name, blocks):
        return max(float(b[name].float().abs().max()) for b in blocks) if len(blocks) else 0.0

    db, sb = model["double_blocks"], model["single_blocks"]
    iq, ik = mx("img_attn_qnorm", db), mx("img_attn_knorm", db)
    tq, tk = mx("txt_attn_qnorm", db), mx("txt_attn_knorm", db)
    pairs = [iq * ik, tq * tk, iq * tk, tq * ik, mx("qnorm", sb) * mx("knorm", sb)]
    return max(pairs) * (cfg.head_dim**0.5)


def flux_cond_vec(model, cfg: FluxStatic, timesteps, y, guidance=None, tape: Optional[_Tape] = None):
    """The per-step conditioning vector (reference flux_model.py:683-691):
    time_in(t_emb) [+ guidance_in(g_emb)] + vector_in(y)."""
    dtype = cfg.dtype
    tape = tape or _Tape.of(cfg)
    vec = _mlp_embedder(tape, "time_in", model["time_in"], timestep_embedding(timesteps, 256).to(dtype), dtype)
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("Didn't get guidance strength for guidance distilled model.")
        vec = vec + _mlp_embedder(
            tape, "guidance_in", model["guidance_in"], timestep_embedding(guidance, 256).to(dtype), dtype
        )
    return vec + _mlp_embedder(tape, "vector_in", model["vector_in"], y.to(dtype), dtype)


def flux_cache_indicator(model, cfg: FluxStatic, img, timesteps, y, guidance=None) -> torch.Tensor:
    """The first double block's image-stream modulated input,
    ``modulate(layer_norm(img_in(img)), shift1, scale1)``: the change indicator of the
    step cache's dynamic mode (``sampling.CacheConfig``; JAX flux.py:525-552). Its
    relative L1 drift between steps follows the drift of the model's output; it costs
    img_in, the conditioning MLPs and one modulation linear, none of the 57 blocks."""
    dtype = cfg.dtype
    tape = _Tape.of(cfg)
    h = tape.lin("img_in", model["img_in"], img.to(dtype), dtype)
    vec = flux_cond_vec(model, cfg, timesteps, y, guidance, tape=tape)
    img_mod = tape.lin("img_mod_lin", model["double_blocks"][0]["img_mod_lin"], silu(vec), dtype)[:, None, :]
    shift1, scale1 = img_mod.chunk(6, dim=-1)[:2]
    return modulate(layer_norm(h), shift1, scale1)


def flux_pre(model, cfg: FluxStatic, img, img_ids, txt, txt_ids, timesteps, y, guidance, tape: _Tape):
    """Everything before the block stacks (reference flux_model.py:683-697): img_in and
    txt_in, the conditioning vector, the rope tables. → (img, txt, SiLU(vec), cos, sin).
    ``model`` needs only the top-level entries, so the streamed step (offload.py) runs
    it on the device copy of those alone."""
    dtype = cfg.dtype
    img = tape.lin("img_in", model["img_in"], img.to(dtype), dtype)
    vec = flux_cond_vec(model, cfg, timesteps, y, guidance, tape=tape)
    txt = tape.lin("txt_in", model["txt_in"], txt.to(dtype), dtype)
    ids = torch.cat([txt_ids, img_ids], dim=1)
    cos, sin = embed_nd_cos_sin(ids, cfg.axes_dim, cfg.theta)
    # every Modulation starts with SiLU(vec) (flux_model.py:252)
    return img, txt, silu(vec), cos[:, :, None, :], sin[:, :, None, :]


def flux_final(model, cfg: FluxStatic, img, vec_silu, tape: _Tape):
    """The final adaLN projection of the image tokens (reference LastLayer,
    flux_model.py:488-503); its chunk order is (shift, scale), not the Modulation
    ordering."""
    dtype = cfg.dtype
    fl = model["final_layer"]
    mod = tape.lin("final_layer.adaln", fl["adaln"], vec_silu, dtype)
    f_shift, f_scale = mod[:, None, :].chunk(2, dim=-1)
    img = modulate(layer_norm(img), f_shift, f_scale)
    return tape.lin("final_layer.linear", fl["linear"], img, dtype)


def flux_apply(
    model: ParamTree,
    cfg: FluxStatic,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    timesteps: torch.Tensor,
    y: torch.Tensor,
    guidance: Optional[torch.Tensor] = None,
    collect_amax: bool = False,
    stack_runner=None,
):
    """Full forward (reference ``Flux.forward``, flux_model.py:672-716).

    Args:
      img: (B, L_img, in_channels) packed latents; img_ids/txt_ids: (B, L, 3).
      txt: (B, L_txt, context_in_dim); timesteps: (B,); y: (B, vec_in_dim);
      guidance: (B,) or None.
      collect_amax: also return the per-linear input amaxes (calibration): top-level
        names like ``"img_in"`` / ``"time_in.in_layer"`` / ``"final_layer.linear"``,
        and ``"double_blocks"``/``"single_blocks"`` dicts of (depth,) tensors.
      stack_runner: how the two block stacks run (JAX flux.py:555-633):
        ``runner(body, carry, blocks, extras, depth) -> carry`` with
        ``body(carry, blk, extras) -> carry``; the double stack's carry is
        ``(img, txt)``, the single stack's the joined ``x``, the extras ``(vec_silu,
        cos, sin)``. None runs them as loops here;
        :func:`~..parallel.pp.make_pp_runner` pipelines them over a pp axis.

    Returns:
      (B, L_img, in_channels) prediction, or (pred, amaxes) with ``collect_amax``.
    """
    if img.dim() != 3 or txt.dim() != 3:
        raise ValueError("Input img and txt tensors must have 3 dimensions.")
    if collect_amax and stack_runner is not None:
        # calibration is a one-rank protocol; a pipelined stage sees only its blocks
        raise ValueError("collect_amax requires the default scan runner")
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and collect_amax:
        raise ValueError("collect_amax (calibration) does not combine with remat under grad")
    tape = _Tape.of(cfg, collect_amax)
    txt_len = txt.shape[1]
    img, txt, vec_silu, cos, sin = flux_pre(model, cfg, img, img_ids, txt, txt_ids, timesteps, y, guidance, tape)

    def run(block_fn, *args):
        # per-block rematerialization: only the block's inputs are kept for backward
        if remat:
            return checkpoint(block_fn, *args, use_reentrant=False)
        return block_fn(*args)

    if stack_runner is not None:
        extras = (vec_silu, cos, sin)

        def double_body(carry, blk, ex):
            return _double_block(cfg, blk, *carry, *ex, _Tape.of(cfg))

        def single_body(x, blk, ex):
            return _single_block(cfg, blk, x, *ex, _Tape.of(cfg))

        img, txt = stack_runner(double_body, (img, txt), model["double_blocks"], extras, cfg.depth)
        x = stack_runner(single_body, torch.cat([txt, img], dim=1), model["single_blocks"], extras,
                         cfg.depth_single_blocks)
        return flux_final(model, cfg, x[:, txt_len:], vec_silu, tape)

    double_amaxes, single_amaxes = [], []
    for blk in model["double_blocks"]:
        block_tape = _Tape.of(cfg, collect_amax)
        img, txt = run(_double_block, cfg, blk, img, txt, vec_silu, cos, sin, block_tape)
        double_amaxes.append(block_tape.amaxes)

    x = torch.cat([txt, img], dim=1)
    for blk in model["single_blocks"]:
        block_tape = _Tape.of(cfg, collect_amax)
        x = run(_single_block, cfg, blk, x, vec_silu, cos, sin, block_tape)
        single_amaxes.append(block_tape.amaxes)
    img = flux_final(model, cfg, x[:, txt_len:], vec_silu, tape)

    if collect_amax:
        amaxes: Dict[str, Any] = dict(tape.amaxes)
        amaxes["double_blocks"] = _stack_amaxes(double_amaxes)
        amaxes["single_blocks"] = _stack_amaxes(single_amaxes)
        return img, amaxes
    return img


def _stack_amaxes(per_block):
    """[{name: scalar}] per block → {name: (depth,)} (the JAX scan's stacked output)."""
    if not per_block:
        return {}
    return {k: torch.stack([blk[k] for blk in per_block]) for k in per_block[0]}
