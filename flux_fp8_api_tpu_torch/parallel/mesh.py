"""The serving mesh over ranks, its collectives and the shard rules of the flow and the
text encoders (JAX counterpart: ``flux_fp8_api_tpu.parallel.mesh``).

JAX runs one controller: one process drives every chip and GSPMD inserts the
collectives. PyTorch's idiom is SPMD over processes: one rank per process, each holding
its slice of the weights, with explicit ``torch.distributed`` collectives. A
:class:`Mesh` names the axes of that world, in the order given (``{"dp": 1, "tp": 4}``),
with one process group per axis; every collective goes through its wrappers, which
count each call by kind, dtype and shape in :data:`COLLECTIVES` (the tests pin the
budget from that count, as the JAX tests pin the HLO's).

The rules are the JAX package's:

- **tp** is Megatron over :data:`_BLOCK_LINEAR_KIND`. Column-parallel leaves keep their
  slice of the out-features (bias and per-out-channel scales follow it); row-parallel
  leaves keep their slice of the in-features and all-reduce their partial products
  (``ops/quant.py``); per-tensor scales are replicated; the modulation outputs are
  all-gathered, as JAX gathers its (B, 6·hs) chunks; embedders, norms and the final
  layer are replicated. The flow runs the head-major ("grouped") fused layout under tp
  (``utils/checkpoint.py:relayout_flux_tree``), so a contiguous slice carries whole
  heads.
- **dp** splits the batch rows (:meth:`Mesh.batch_rows`).
- **sp** splits only attention's q rows (``ops/attention.py``); the linears stay
  replicated over sp.
- **pp** gives each stage a contiguous depth slice of every block stack that its size
  divides (:func:`stage_blocks`, JAX ``flux_param_shardings(pp_axis=...)``); a stack
  it does not divide stays whole on every stage. Stages hand activations on with
  :meth:`Mesh.send` / :meth:`Mesh.recv` (``parallel/pp.py``).

Port layout reminder: a Linear's weight is (out, in), so column-parallel slices dim 0
and row-parallel dim 1 (JAX's (in, out) kernel slices the other way round). The flow's
packed int4 kind is half-split along in: a row slice unpacks, slices and repacks.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import math
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.quant import INT4_MAX, Linear, _unpack_int4

logger = logging.getLogger(__name__)

SERVING_AXES = ("dp", "tp", "sp", "pp")
# the axes a VAE band split may run over together (JAX pipeline.py:357-369): make_mesh
# builds one process group over them where both have more than one rank
BAND_AXES = ("dp", "tp")
# process-group timeout of the compute collectives: a rank that fails mid-request
# makes the others raise after this long instead of hanging forever
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
# the control group carries requests to idle followers, which may wait for hours
CONTROL_TIMEOUT = datetime.timedelta(days=365)

# collective calls by (kind, dtype, shape of the local input): each wrapper adds one
# where it runs a collective over a group of more than one rank, and nowhere else
COLLECTIVES: "collections.Counter[Tuple[str, str, Tuple[int, ...]]]" = collections.Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


Axis = Union[str, Tuple[str, ...]]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class Mesh:
    """A (dp, tp, sp …) mesh of ranks: ``shape`` (axis → size, in the order given),
    this rank's ``coords`` along each axis, its ``device``, and one process group per
    axis of more than one rank (``group(axis)``). Ranks are laid out row-major over the
    axes, as ``np.reshape`` lays out JAX's device array.

    A mesh built without groups (``groups=None``) answers shapes and coordinates only:
    the shard functions need nothing more, and its collectives raise where a group of
    more than one rank would be needed."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, device: Union[str, torch.device] = "cpu",
                 groups: Optional[Dict[str, Any]] = None, control=None, backend: Optional[str] = None):
        self.shape = dict(shape)
        self.world = math.prod(self.shape.values())
        self.global_rank = rank
        coords = np.unravel_index(rank, tuple(self.shape.values())) if self.shape else ()
        self.coords = {axis: int(c) for axis, c in zip(self.shape, coords)}
        self.device = torch.device(device)
        self.groups = groups
        self.control = control
        self.backend = backend

    def _axes(self, axis: Axis) -> Tuple[str, ...]:
        """``axis`` as a tuple of the mesh's axes in the mesh's order."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return tuple(a for a in self.shape if a in names)

    def size(self, axis: Optional[Axis]) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh lacks; a tuple: the product);
        None: the whole mesh."""
        if axis is None:
            return self.world
        return math.prod(self.shape[a] for a in self._axes(axis))

    def rank(self, axis: Axis) -> int:
        """This rank's coordinate along ``axis`` (0 for an axis the mesh lacks; a tuple:
        row-major over its axes in the mesh's order, the rank's place in the group)."""
        axes = self._axes(axis)
        return int(np.ravel_multi_index([self.coords[a] for a in axes], [self.shape[a] for a in axes])) if axes else 0

    def group(self, axis: Optional[Axis]):
        """The process group of ``axis`` (None: the whole world; a tuple of axes: the
        group over them, which :func:`make_mesh` builds for :data:`BAND_AXES`)."""
        if axis is None:
            return None
        if self.groups is None:
            raise RuntimeError(f"this mesh of {self.shape} has no process groups")
        axes = self._axes(axis)
        return self.groups[axes[0] if len(axes) == 1 else axes]

    def peer(self, axis: str, coord: int) -> int:
        """The global rank of the rank at ``coord`` along ``axis`` and at this rank's
        coordinates on every other axis."""
        coords = dict(self.coords, **{axis: coord})
        return int(np.ravel_multi_index([coords[a] for a in self.shape], tuple(self.shape.values())))

    @property
    def is_root(self) -> bool:
        return self.global_rank == 0

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.global_rank}, coords={self.coords}, device={self.device})"

    # ------------------------------------------------------------------ collectives

    def _live(self, axis: Optional[str]) -> bool:
        return self.size(axis) > 1

    def _count(self, kind: str, t: torch.Tensor) -> None:
        COLLECTIVES[(kind, _dtype_name(t.dtype), tuple(t.shape))] += 1

    def all_reduce_sum(self, t: torch.Tensor, axis: Optional[Axis], count_as: str = "all_reduce_sum") -> torch.Tensor:
        """Σ over ``axis`` (None: the whole mesh), in place on ``t``; returns it.
        ``count_as``: the kind it is counted under in :data:`COLLECTIVES`."""
        if self._live(axis):
            import torch.distributed as dist

            self._count(count_as, t)
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group(axis))
        return t

    def all_reduce_max(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """max over ``axis`` (None: the whole mesh), in place on ``t``; returns it."""
        if self._live(axis):
            import torch.distributed as dist

            self._count("all_reduce_max", t)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: Axis, dim: int, count_as: str = "all_gather") -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in rank order.
        It travels as bytes (a gather copies them, and gloo takes neither bf16 nor
        int16). ``count_as``: the kind it is counted under in :data:`COLLECTIVES`."""
        if not self._live(axis):
            return t
        import torch.distributed as dist

        self._count(count_as, t)
        wire = t.contiguous().view(torch.uint8)
        parts = [torch.empty_like(wire) for _ in range(self.size(axis))]
        dist.all_gather(parts, wire, group=self.group(axis))
        return torch.cat([p.view(t.dtype) for p in parts], dim=dim)

    def _host_staged(self, t: torch.Tensor) -> bool:
        """gloo sends and receives host tensors only: a CUDA tensor stages through the
        host (ranks sharing a card, or a host-only process group)."""
        return t.is_cuda and self.backend != "nccl"

    def send(self, t: torch.Tensor, axis: str, dst: int) -> None:
        """Send ``t`` to the rank at coordinate ``dst`` along ``axis`` (a pipeline
        stage's handoff); its bytes travel, staged through the host under gloo."""
        import torch.distributed as dist

        self._count("send", t)
        wire = t.contiguous().view(torch.uint8)
        if self._host_staged(wire):
            wire = wire.cpu()
        dist.send(wire, self.peer(axis, dst))

    def recv(self, like: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """A tensor of ``like``'s shape, dtype and device from the rank at coordinate
        ``src`` along ``axis`` (the other end of :meth:`send`)."""
        import torch.distributed as dist

        self._count("recv", like)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        wire = out.view(torch.uint8)
        buf = torch.empty_like(wire, device="cpu") if self._host_staged(wire) else wire
        dist.recv(buf, self.peer(axis, src))
        if buf is not wire:
            wire.copy_(buf)
        return out

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """The contiguous ``t`` of the rank at coordinate ``src`` along ``axis`` on every
        rank of the axis, in place (as bytes: gloo takes no bf16); returns it."""
        if not self._live(axis):
            return t
        import torch.distributed as dist

        self._count("broadcast", t)
        dist.broadcast(t.view(torch.uint8), self.peer(axis, src), group=self.group(axis))
        return t

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s picklable ``obj`` on every rank, over the control group (gloo,
        host memory, a long timeout: followers wait here between requests)."""
        if self.world == 1:
            return obj
        import torch.distributed as dist

        COLLECTIVES[("broadcast_object", "object", ())] += 1
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.control)
        return box[0]

    def any_failed(self, failed: bool) -> bool:
        """Whether any rank reports a failure (a MAX over the control group)."""
        if self.world == 1:
            return failed
        import torch.distributed as dist

        flag = torch.tensor([int(failed)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.control)
        return bool(flag.item())

    # ------------------------------------------------------------------------ rows

    def batch_rows(self, b: int) -> Optional[slice]:
        """This rank's dp rows of a batch of ``b`` (JAX ``batch_sharding``): a slice
        when dp divides ``b``, else None (every rank keeps the whole batch, as JAX
        replicates an odd batch)."""
        dp = self.size("dp")
        if dp == 1 or b % dp:
            return None
        n = b // dp
        return slice(self.rank("dp") * n, (self.rank("dp") + 1) * n)


def local_device(device: Optional[str] = None) -> torch.device:
    """``cuda:{LOCAL_RANK % device_count}``, or the CPU when ``device == "cpu"``."""
    if device is not None and str(device).startswith("cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh rank runs on a CUDA device and torch.cuda.is_available() is False "
                           "(pass device='cpu' to run on the host)")
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_backend(backend: str, world: int, device: torch.device) -> None:
    """NCCL takes one rank per card: refuse it, naming gloo, where ranks would share."""
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; on the host use --dist-backend gloo")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count()
    if local_world > cards:
        raise ValueError(f"{local_world} ranks on {cards} card(s): NCCL refuses two ranks on one card — "
                         "use --dist-backend gloo to let ranks share a card")


def make_mesh(shape: Dict[str, int], backend: str = "nccl", device: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Build the mesh of ``shape`` (e.g. ``{"dp": 1, "tp": 4}``) over this process's
    world, with the axes in the order given (JAX ``make_mesh``).

    The process group is initialised here when it is not yet: from ``init_method``,
    ``rank`` and ``world_size`` when given, else from torchrun's environment
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``). Without either, the
    world is this one process. Raises ValueError when the world is smaller than the
    mesh (as JAX does for too few devices) or larger (a rank outside the mesh would
    idle), and when ``backend`` is nccl with more ranks than cards."""
    import torch.distributed as dist

    shape = {str(k): int(v) for k, v in shape.items()}
    bad = [a for a, s in shape.items() if s < 1]
    if bad:
        raise ValueError(f"mesh {shape}: axis sizes must be >= 1")
    n = math.prod(shape.values())
    dev = local_device(device)
    if not dist.is_initialized():
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            init_method = init_method or "env://"
        if world_size is not None:
            check_backend(backend, world_size, dev)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend, init_method=init_method, rank=rank,
                                    world_size=world_size, timeout=DEFAULT_TIMEOUT)
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, have {world}")
    if n < world:
        raise ValueError(f"mesh {shape} has {n} ranks and the world {world}: every rank must be in the mesh")
    if not dist.is_initialized():
        return Mesh(shape, 0, dev, groups={a: None for a in shape}, backend=None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    groups: Dict[str, Any] = {}
    ranks = np.arange(n).reshape(tuple(shape.values()))
    combos = [(a,) for a in shape]
    if all(shape.get(a, 1) > 1 for a in BAND_AXES):
        combos.append(tuple(a for a in shape if a in BAND_AXES))
    for axes in combos:
        # one group per line of the mesh along these axes; every rank creates every
        # group, in the same order (new_group is collective)
        idx = [list(shape).index(a) for a in axes]
        n_line = math.prod(shape[a] for a in axes)
        lines = np.moveaxis(ranks, idx, list(range(-len(idx), 0))).reshape(-1, n_line)
        for line in lines:
            g = dist.new_group([int(r) for r in line]) if n_line > 1 else None
            if me in line:
                groups[axes[0] if len(axes) == 1 else axes] = g
    control = dist.new_group(list(range(n)), backend="gloo", timeout=CONTROL_TIMEOUT)
    return Mesh(shape, me, dev, groups=groups, control=control, backend=dist.get_backend())


# ----------------------------------------------------------------------- shard rules

# depth-stacked flux Linear leaves → "col" | "row" (anything else is replicated)
_BLOCK_LINEAR_KIND = {
    "img_mod_lin": "col",
    "txt_mod_lin": "col",
    "img_attn_qkv": "col",
    "txt_attn_qkv": "col",
    "img_attn_proj": "row",
    "txt_attn_proj": "row",
    "img_mlp_0": "col",
    "img_mlp_2": "row",
    "txt_mlp_0": "col",
    "txt_mlp_2": "row",
    "linear1": "col",
    "linear2": "row",
    "mod_lin": "col",
}
# column-parallel leaves whose output is all-gathered over tp (the modulation vectors)
GATHERED_LEAVES = ("img_mod_lin", "txt_mod_lin", "mod_lin")

LINEAR_FIELDS = ("weight", "q", "bias", "w_scale", "w_scale_inv", "in_scale", "in_scale_inv")


def _linear_spec(kind: str) -> Dict[str, Optional[int]]:
    """Which dimension of each Linear field a tp shard slices (None: replicated) in
    the port's (out, in) layout. Scalars (per-tensor scales) are never sliced; a
    column shard's 1-D (out,) scales follow the out-features."""
    if kind == "col":
        return {"weight": 0, "q": 0, "bias": 0, "w_scale": 0, "w_scale_inv": 0,
                "in_scale": None, "in_scale_inv": None}
    if kind == "row":
        return {"weight": 1, "q": 1, "bias": None, "w_scale": None, "w_scale_inv": None,
                "in_scale": None, "in_scale_inv": None}
    return dict.fromkeys(LINEAR_FIELDS)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearShard:
    """How a sharded Linear runs (``ops/quant.py:linear_apply``): ``"col"`` keeps its
    out-slice (``gather``: all-gather the output over ``axis``), ``"row"`` all-reduces
    its partial product over ``axis`` before the epilogue and the bias."""

    mode: str
    mesh: Mesh
    axis: str = "tp"
    gather: bool = False


def _chunk(t: torch.Tensor, dim: int, size: int, rank: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).clone()


def _pack_int4(values: torch.Tensor) -> torch.Tensor:
    """(out, in) int8 in [-7, 7] → (out, in/2) half-split packed nibbles."""
    q = (values + int(INT4_MAX)).to(torch.uint8)
    half = q.shape[-1] // 2
    return q[:, :half] | (q[:, half:] << 4)


def slice_linear(lin: Linear, kind: str, size: int, rank: int) -> Linear:
    """This rank's slice of one Linear under ``kind`` (``_linear_spec``). The half-split
    int4 kind's row slice unpacks, slices the in-features and repacks: a contiguous
    slice of packed columns is not a contiguous slice of the in-features."""
    spec = _linear_spec(kind)
    fields = {}
    for name in LINEAR_FIELDS:
        t = getattr(lin, name)
        dim = spec[name]
        if t is None or dim is None or t.dim() <= dim:
            fields[name] = t
        elif name == "q" and kind == "row" and lin.kind == "int4":
            fields[name] = _pack_int4(_chunk(_unpack_int4(t), 1, size, rank))
        else:
            fields[name] = _chunk(t, dim, size, rank)
    return Linear(lin.kind, **fields)


def shard_flux_leaf(path: Tuple[str, ...], lin: Linear, mesh: Mesh, tp_axis: str = "tp") -> Linear:
    """One flux Linear (``path`` as ``models/flux.py:_map_linears`` gives it) → this
    rank's slice, marked with its :class:`LinearShard`: the block leaves of
    :data:`_BLOCK_LINEAR_KIND` sliced as :func:`_linear_spec` says; the embedders, the
    final layer and every leaf without a tp axis of more than one rank pass whole."""
    size = mesh.size(tp_axis)
    kind = _BLOCK_LINEAR_KIND.get(path[-1], "rep") if path[0] in ("double_blocks", "single_blocks") else "rep"
    if size == 1 or kind == "rep" or lin.shard is not None:
        return lin
    out = slice_linear(lin, kind, size, mesh.rank(tp_axis))
    out.shard = LinearShard(kind, mesh, tp_axis, gather=path[-1] in GATHERED_LEAVES)
    return out


def stage_blocks(depth: int, mesh: Optional[Mesh]) -> range:
    """The global indices of a depth-``depth`` block stack that this rank's pp stage
    holds (JAX ``flux_param_shardings(pp_axis=...)``, :82-196): a contiguous slice of
    depth/S blocks when the S stages divide the depth, else the whole stack (it stays
    replicated and every stage runs it). The one rule of the loader, the shard, the
    LoRA fuse and the runner."""
    s = 1 if mesh is None else mesh.size("pp")
    if s == 1 or depth % s:
        return range(depth)
    n = depth // s
    first = mesh.rank("pp") * n
    return range(first, first + n)


def check_flux_divisible(cfg, tp: int) -> None:
    """Heads, the hidden size and the mlp width must split over tp into whole heads."""
    if tp > 1 and (cfg.num_heads % tp or cfg.mlp_hidden % cfg.num_heads):
        raise ValueError(f"tp={tp} must divide the {cfg.num_heads} heads (and the mlp width "
                         f"{cfg.mlp_hidden} the heads) to shard the flow in whole heads")


def setup_flux(model, cfg, mesh: Mesh):
    """The flow's mesh set-up on this rank (JAX pipeline.py:142-246) → (model, cfg):
    under pp this stage's depth slices (:func:`slice_flux_stages`); the attention's
    shard axes (dp and tp), or ``use_pallas=False`` for the whole model where the heads
    do not divide their product, as in JAX; the sequence axis; under tp the grouped
    layout and this rank's shard. A model the loader already relayouted and sliced
    passes through. Under pp the max-free kernel stays on: a port rank holds whole
    heads, so JAX's reason to serve pp with XLA attention does not arise here."""
    from ..utils.checkpoint import relayout_flux_tree

    axes = tuple(a for a in ("dp", "tp") if mesh.size(a) > 1)
    if model is not None and mesh.size("pp") > 1:
        model = slice_flux_stages(model, cfg, mesh)
    if cfg.use_pallas and axes and cfg.num_heads % int(np.prod([mesh.size(a) for a in axes])):
        logger.info("mesh: %d heads do not divide the %s axes — serving with use_pallas=False",
                    cfg.num_heads, axes)
        cfg = dataclasses.replace(cfg, use_pallas=False)
    cfg = dataclasses.replace(cfg, attn_shard_axes=axes or None,
                              attn_seq_axis="sp" if mesh.size("sp") > 1 else None, mesh=mesh)
    if mesh.size("tp") > 1:
        check_flux_divisible(cfg, mesh.size("tp"))
        if model is not None and cfg.fused_layout != "grouped":
            model = relayout_flux_tree(model, cfg)
        cfg = dataclasses.replace(cfg, fused_layout="grouped")
        if model is not None:
            model = shard_flux_params(model, mesh)
    logger.info("mesh %s: rank %d on %s, attention over %s%s, %s layout", mesh.shape, mesh.global_rank,
                mesh.device, axes or "no axis", " + sp rows" if cfg.attn_seq_axis else "", cfg.fused_layout)
    return model, cfg


def slice_flux_stages(model, cfg, mesh: Mesh):
    """Keep this pp stage's blocks of each stack (:func:`stage_blocks`), in place; a
    stack already cut to its slice passes. Returns the model."""
    for stack, depth in (("double_blocks", cfg.depth), ("single_blocks", cfg.depth_single_blocks)):
        keep = stage_blocks(depth, mesh)
        blocks = model[stack]
        if len(blocks) == depth and len(keep) < depth:
            setattr(model, stack, torch.nn.ModuleList(blocks[i] for i in keep))
    return model


def gather_flux_stages(model, cfg, mesh: Mesh):
    """A host copy of the flux tree with every pp stage's blocks (every rank of the pp
    axis must call it): each buffer of the j-th local block gathered from the stages,
    whose slices are contiguous and in stage order."""
    from ..utils.tree import tree_to

    full = tree_to(model, "cpu")
    s = mesh.size("pp")
    for stack, depth in (("double_blocks", cfg.depth), ("single_blocks", cfg.depth_single_blocks)):
        if len(stage_blocks(depth, mesh)) == depth:
            continue
        local = model[stack]
        stages = [[tree_to(blk, "cpu") for blk in local] for _ in range(s)]
        for j, blk in enumerate(local):
            for name, mod in blk.named_modules():
                for key, t in mod._buffers.items():
                    if t is None:
                        continue
                    parts = mesh.all_gather(t[None], "pp", 0).cpu()
                    for st in range(s):
                        stages[st][j].get_submodule(name)._buffers[key] = parts[st].clone()
        setattr(full, stack, torch.nn.ModuleList(b for st in stages for b in st))
    return full


def shard_flux_params(model, mesh: Mesh, tp_axis: str = "tp"):
    """Keep this rank's slice of every flux Linear, in place (the tree must already be
    in the grouped layout under tp, ``utils/checkpoint.py:relayout_flux_tree``).
    Returns the model."""
    from ..models.flux import _map_linears

    _map_linears(model, lambda path, lin: shard_flux_leaf(path, lin, mesh, tp_axis))
    return model


# ---------------------------------------------------------------- text encoders (tp)

_ENC_BLOCK_LINEAR_KIND = {
    # T5 (models/t5.py blocks)
    "q": "col",
    "k": "col",
    "v": "col",
    "o": "row",
    "wi_0": "col",
    "wi_1": "col",
    "wo": "row",
    # CLIP (models/clip.py blocks)
    "q_proj": "col",
    "k_proj": "col",
    "v_proj": "col",
    "out_proj": "row",
    "fc1": "col",
    "fc2": "row",
}
# leaves that must be sharded together for the forward to run in local heads / slices
_ENC_GROUPS = (("q", "k", "v", "o"), ("wi_0", "wi_1", "wo"),
               ("q_proj", "k_proj", "v_proj", "out_proj"), ("fc1", "fc2"))


def _enc_linear_spec(lin: Linear, kind: str, size: int) -> Dict[str, Optional[int]]:
    """Per-field dims of one encoder Linear (JAX ``_enc_linear_shardings``): weight-only
    kinds carry per-out-channel (out,) or blockwise (out, nblocks) scales; blockwise
    scales shard WITH the kernel's in-axis on row leaves, per-out-channel ones are
    replicated there. A field whose sliced dim ``size`` does not divide is replicated
    (the JAX guard)."""
    if kind == "col":
        spec = {"weight": 0, "q": 0, "bias": 0, "w_scale": 0, "w_scale_inv": 0}
    else:
        blockwise = lin.kind in ("wo_int4", "wo_int2")
        spec = {"weight": 1, "q": 1, "bias": None, "w_scale": None,
                "w_scale_inv": 1 if blockwise else None}
    spec.update(in_scale=None, in_scale_inv=None)
    for name, dim in spec.items():
        t = getattr(lin, name)
        if dim is not None and (t is None or t.dim() <= dim or t.shape[dim] % size):
            spec[name] = None
    return spec


def encoder_param_shardings(params, mesh: Mesh, tp_axis: str = "tp", num_heads: Optional[int] = None):
    """``[{leaf: {field: dim or None}} per block]`` for a T5 or CLIP tree: Megatron
    col/row over the blocks' Linear leaves, everything else (embeddings, norms)
    replicated. Fields follow the JAX guard. A group of leaves that one forward
    consumes together (q/k/v/o, the feed-forward) is sharded only when every kernel
    in it is, and attention only when ``num_heads`` splits over tp; otherwise the
    group is replicated (the JAX package lets GSPMD reshard there instead)."""
    size = mesh.size(tp_axis)
    out = []
    for blk in params["blocks"]:
        table = {}
        for leaf, v in blk.items():
            if isinstance(v, Linear) and leaf in _ENC_BLOCK_LINEAR_KIND and size > 1:
                table[leaf] = _enc_linear_spec(v, _ENC_BLOCK_LINEAR_KIND[leaf], size)
        for group in _ENC_GROUPS:
            members = [g for g in group if g in table]
            heads_split = num_heads is None or num_heads % size == 0 or group[0] in ("wi_0", "fc1")
            whole = all(table[g]["q" if getattr(blk[g], "q") is not None else "weight"] is not None
                        for g in members)
            if members and not (whole and heads_split):
                for g in members:
                    table[g] = dict.fromkeys(LINEAR_FIELDS)
        out.append(table)
    return out


def shard_encoder_params(params, mesh: Mesh, tp_axis: str = "tp", num_heads: Optional[int] = None):
    """Keep this rank's slice of every T5/CLIP block Linear, in place (a slice already
    taken stays); returns params."""
    size, rank = mesh.size(tp_axis), mesh.rank(tp_axis)
    if size == 1:
        return params
    for blk, table in zip(params["blocks"], encoder_param_shardings(params, mesh, tp_axis, num_heads)):
        for leaf, spec in table.items():
            lin = blk[leaf]
            kdim = spec["q" if lin.q is not None else "weight"]
            if kdim is None or lin.shard is not None:  # replicated, or this rank's slice already
                continue
            fields = {name: (getattr(lin, name) if spec.get(name) is None or getattr(lin, name) is None
                             else _chunk(getattr(lin, name), spec[name], size, rank))
                      for name in LINEAR_FIELDS}
            new = Linear(lin.kind, **fields)
            new.shard = LinearShard("col" if kdim == 0 else "row", mesh, tp_axis)
            setattr(blk, leaf, new)
    return params


def sharded_bytes(tree: torch.nn.Module) -> int:
    """Bytes of the tree's buffers held by this rank."""
    return sum(b.numel() * b.element_size() for b in tree.buffers())


def gather_linear(lin: Linear) -> Linear:
    """The whole Linear from every tp rank's slice (the inverse of
    :func:`slice_linear`), on the host; an unsharded Linear passes."""
    shard = lin.shard
    if shard is None:
        return lin
    spec = _linear_spec(shard.mode)
    fields = {}
    for name in LINEAR_FIELDS:
        t = getattr(lin, name)
        dim = spec[name]
        if t is None or dim is None or t.dim() <= dim:
            fields[name] = None if t is None else t.cpu()
        elif name == "q" and shard.mode == "row" and lin.kind == "int4":
            fields[name] = _pack_int4(shard.mesh.all_gather(_unpack_int4(t), shard.axis, 1).cpu())
        else:
            fields[name] = shard.mesh.all_gather(t, shard.axis, dim).cpu()
    return Linear(lin.kind, **fields)


def gather_flux_params(model):
    """A host copy of the whole flux tree from the ranks' shards, leaf by leaf (every
    rank of the tp axis must call it)."""
    from ..models.flux import _map_linears
    from ..utils.tree import tree_to

    full = tree_to(model, "cpu")
    _map_linears(full, lambda path, lin: gather_linear(lin))
    return full


def local_heads(num_heads: int, lin: Linear) -> Tuple[int, int]:
    """(first head, heads) of this rank for attention fed by column leaf ``lin``."""
    shard = getattr(lin, "shard", None)
    if shard is None or shard.mode != "col":
        return 0, num_heads
    size = shard.mesh.size(shard.axis)
    n = num_heads // size
    return shard.mesh.rank(shard.axis) * n, n


def parse_axes(shape: Dict[str, int]) -> Dict[str, int]:
    """Validate the axes of a config's ``mesh`` (JAX pipeline.py:135-140)."""
    unknown = [a for a in shape if a not in SERVING_AXES]
    if unknown:
        raise ValueError(
            f"mesh axes {unknown} are not serving axes — supported: "
            "dp (batch), tp (Megatron), sp (sequence), pp (GPipe block stages)"
        )
    return {a: int(s) for a, s in shape.items()}
