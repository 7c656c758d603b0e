"""Flow-matching training, on one device or over a (dp, tp) mesh (JAX counterpart:
``flux_fp8_api_tpu.parallel.train``).

The objective is rectified flow, the one FLUX models are trained with: the model
predicts the velocity ε − x₀ at ``x_t = (1 − t)·x₀ + t·ε``. Three steps are built on it:

- :func:`make_train_step`: every float tensor of the tree trains, plain SGD;
- :func:`make_optimizer_train_step`: the same with a ``torch.optim`` optimizer
  (:func:`adamw` gives optax's AdamW defaults) and optax's global-norm clip;
- :func:`make_lora_train_step`: QLoRA, rank-r adapters on a frozen (typically
  quantized) base, what ``train_lora`` and ``bench_train`` run.

Every step trains with ``use_pallas=False``: the max-free attention kernel has no
backward (it raises under a gradient, as the JAX package fails at trace time), so
attention is the rope pass, through its autograd Function and CUDA backward build, and
``F.scaled_dot_product_attention``. ``remat`` (on by default) runs each block under
``torch.utils.checkpoint``.

Randomness comes from ``torch.Generator``s, so a seed draws other t and ε than the
JAX package's keys; every loss and step takes explicit ``t`` and ``noise`` as well, so
draws can be carried across. Train state is one ``torch.save`` file in a directory,
written atomically (orbax is the JAX package's).

On a mesh (the model as ``mesh.py:setup_flux`` leaves it, ``cfg.mesh`` its mesh) every
step takes the whole batch on every rank: t and ε are drawn whole, as on one rank, and
each dp rank takes its rows. The loss is the mean over the whole batch, so each rank's
gradients are its rows' share, summed over dp. Under tp the linears carry Megatron's
conjugate pair (``ops/quant.py``), and a replicated tensor used inside the split region
(a q/k-norm scale, an adapter) gets its ∂ summed over tp there. The moments of
:class:`OptaxAdamW` are laid out like their parameters. The state file holds whole
tensors in the flat layout at global block indices, gathered on the first rank, so a
state written on one mesh restores on another or on one rank (JAX's orbax restore,
parallel/train.py:184-190).
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from ..lora import Adapters, adapter_tensors, merge_lora_adapters
from ..models.flux import FluxStatic, flux_apply
from ..ops.packing import make_img_ids, make_txt_ids
from ..ops.quant import Linear
from ..ops.schedule import get_lin_function
from ..utils.tree import ParamTree

STATE_FILE = "train_state.pt"
# 2: whole tensors at global block indices, the optimizer state keyed by tensor name
STATE_FORMAT = 2

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]


def sample_timesteps(generator: torch.Generator, batch: int, image_seq_len: int,
                     t_sampling: str) -> torch.Tensor:
    """(batch,) fp32 flow times in (0, 1) on the generator's device. ``"uniform"``:
    t ~ U(0, 1). ``"logit_normal"``: t = σ(N(0, 1)) warped by the sampler's own
    resolution shift (``ops/schedule.py:time_shift`` with σ = 1 and mu from
    ``get_lin_function()(image_seq_len)``), the SD3/FLUX training density."""
    device = generator.device
    if t_sampling == "logit_normal":
        t = torch.sigmoid(torch.randn((batch,), generator=generator, device=device))
        em = math.exp(get_lin_function()(image_seq_len))
        return em * t / (em * t + (1.0 - t))
    if t_sampling == "uniform":
        return torch.rand((batch,), generator=generator, device=device)
    raise ValueError(f"unknown t_sampling {t_sampling!r} (uniform|logit_normal)")


def flow_matching_loss(
    model: ParamTree,
    cfg: FluxStatic,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    t_sampling: str = "uniform",
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    stack_runner=None,
) -> torch.Tensor:
    """Rectified-flow MSE in fp32: ``x_t = (1 − t)·x₀ + t·ε``, target ``ε − x₀``.

    ``batch``: ``latents`` (B, L, C) packed clean latents, ``txt``, ``y``, ``img_ids``,
    ``txt_ids``. t is drawn first (:func:`sample_timesteps`), then ε ~ N(0, 1) in fp32
    cast to the latents' dtype, both from ``generator``; given ``t`` or ``noise`` are
    used instead of a draw. ``stack_runner``: as in ``flux_apply`` (pp)."""
    x0 = batch["latents"]
    b = x0.shape[0]
    t, noise = draw(batch, generator, t_sampling, t, noise)
    t = t.to(x0.device, torch.float32)
    t_b = t.to(x0.dtype)[:, None, None]
    x_t = (1.0 - t_b) * x0 + t_b * noise
    guidance = torch.full((b,), 1.0, dtype=torch.float32, device=x0.device) if cfg.guidance_embed else None
    pred = flux_apply(model, cfg, x_t, batch["img_ids"], batch["txt"], batch["txt_ids"], t, batch["y"], guidance,
                      stack_runner=stack_runner)
    target = noise - x0
    return torch.mean((pred.float() - target.float()) ** 2)


def draw(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator], t_sampling: str = "uniform",
         t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
    """(t, ε) for the whole batch: t first, then ε, from ``generator``, where not given."""
    x0 = batch["latents"]
    if t is None:
        t = sample_timesteps(generator, x0.shape[0], x0.shape[1], t_sampling)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device).to(x0.dtype)
    return t, noise


def train_cfg(cfg: FluxStatic, remat: bool, dequant: bool = False) -> FluxStatic:
    """The configuration a train step runs: the differentiable attention path (no
    sequence split), ``remat`` as asked, and for adapters the dequantize path of the
    quantized linears."""
    return dataclasses.replace(cfg, use_pallas=False, attn_seq_axis=None, remat=remat,
                               dequant_linears=dequant or cfg.dequant_linears)


def dp_loss_and_grads(loss_fn, tensors: List[torch.Tensor], mesh, batch, generator, t_sampling: str,
                      t=None, noise=None, backward: bool = False):
    """The loss over the whole batch and its gradients, on one rank or a mesh: the
    draws whole, this dp rank's rows through ``loss_fn(batch, t, noise)``, the rows'
    share of the gradients summed over dp → (loss, grads). ``backward``: the gradients
    are taken by ``loss.backward()`` into each tensor's ``.grad`` (the pp step, whose
    stages backpropagate outside the graph of the loss), which the tensors keep."""
    t, noise = draw(batch, generator, t_sampling, t, noise)
    rows = None if mesh is None else mesh.batch_rows(batch["latents"].shape[0])
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
        t, noise = t[rows], noise[rows]
    loss = loss_fn(batch, t, noise)
    if backward:
        loss.backward()
        grads = [p.grad for p in tensors]
    else:
        grads = _grads(loss, tensors)
    loss = loss.detach()
    if rows is not None:  # each dp rank's mean is 1/dp of the whole batch's
        n = mesh.size("dp")
        loss = mesh.all_reduce_sum(loss.float().clone(), "dp") / n
        grads = [None if g is None else (mesh.all_reduce_sum(g.float().clone(), "dp") / n).to(g.dtype) for g in grads]
        if backward:
            for p, g in zip(tensors, grads):
                p.grad = g
    return loss, grads


def split_axes(model: ParamTree, tensors: List[torch.Tensor], cfg: FluxStatic) -> List[Optional[str]]:
    """Per tensor, the mesh axis it is split over (its slices make the whole tensor),
    or None where every rank holds it whole: a tp slice of a sharded Linear."""
    from .mesh import _linear_spec

    mesh, axes = cfg.mesh, {}
    if mesh is None:
        return [None] * len(tensors)
    for module in model.modules():
        if isinstance(module, Linear) and module.shard is not None:
            spec = _linear_spec(module.shard.mode)
            for name, t in module._buffers.items():
                if t is not None and spec.get(name) is not None and t.dim() > spec[name]:
                    axes[id(t)] = module.shard.axis
    return [axes.get(id(t)) for t in tensors]


def trainable_tensors(model: ParamTree) -> List[torch.Tensor]:
    """What a full-parameter step trains, each made a leaf that requires grad: the
    weight and bias of every float Linear and every other float tensor of the tree
    (the q/k-norm scales). A quantized Linear stays frozen. A tensor made under
    ``torch.inference_mode`` is replaced in its module by a copy, since such a tensor
    cannot require grad."""
    out = []
    for module in model.modules():
        if isinstance(module, Linear):
            keys = ("weight", "bias") if module.kind == "float" else ()
        else:
            keys = tuple(module._buffers)
        for key in keys:
            buf = module._buffers[key]
            if buf is None or not buf.is_floating_point():
                continue
            if buf.is_inference():
                buf = module._buffers[key] = buf.clone()
            out.append(buf.requires_grad_())
    return out


def _grads(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


@torch.no_grad()
def sgd_update(params: List[torch.Tensor], grads: List[torch.Tensor], lr: float = 1e-4) -> None:
    """``p ← p − lr·g`` in p's dtype, in place (JAX ``sgd_update``: the product rounded,
    then the difference)."""
    for p, g in zip(params, grads):
        p.copy_(p - lr * g.to(p.dtype))


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, split=None, mesh=None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: with ‖g‖ the norm over every gradient, each g
    is kept while ‖g‖ < ``max_norm`` and otherwise becomes ``(g / ‖g‖)·max_norm``. The
    norm is accumulated in fp32 (optax's, in the gradients' dtype); no host sync: the
    choice is a ``torch.where``. On a ``mesh``, ``split`` (:func:`split_axes`) names
    the axis each gradient is sliced over: those squares are summed over it."""
    split = split or [None] * len(grads)
    sq = {}
    for g, axis in zip(grads, split):
        sq[axis] = sq.get(axis, 0) + torch.sum(g.float() * g.float())
    total = sq.pop(None, 0)
    for axis, part in sq.items():
        total = total + mesh.all_reduce_sum(part.reshape(1).clone(), axis)[0]
    norm = torch.sqrt(total)
    return [torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


class OptaxAdamW(torch.optim.Optimizer):
    """AdamW computed as optax ``adamw`` computes it (``scale_by_adam``, then
    ``add_decayed_weights``, then ``scale_by_learning_rate``), with its defaults:
    betas (0.9, 0.999), eps 1e-8 outside the square root, weight decay 1e-4 (torch's
    ``AdamW`` defaults to 1e-2 and forms its bias corrections in double, optax in
    fp32). Per step, with one count for all tensors:
    ``mu = (1−b1)·g + b1·mu``, ``nu = (1−b2)·g² + b2·nu``, ``bc = 1 − b^count`` in
    fp32, ``u = (mu/bc1) / (√(nu/bc2) + eps) + wd·p``, ``p = p + (−lr)·u``. The
    moments take the parameters' dtype, as optax's do. Each operation runs over all
    tensors at once (``torch._foreach_*``)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["count"], st["mu"], st["nu"] = 0, torch.zeros_like(p), torch.zeros_like(p)
                st["count"] += 1
            b1, b2 = group["betas"]
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            count = torch.tensor(float(states[0]["count"]), dtype=torch.float32)

            def bias_correction(decay):
                bc = 1 - torch.pow(torch.tensor(decay, dtype=torch.float32), count)
                return [float(bc.to(p.dtype)) for p in params]

            denom = torch._foreach_sqrt(torch._foreach_div(nus, bias_correction(b2)))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mus, bias_correction(b1)), denom)
            torch._foreach_add_(upd, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


def adamw(lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    """A factory of :class:`OptaxAdamW`, ``optax.adamw(lr)``'s counterpart."""
    return lambda params: OptaxAdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)


def optimizer_update(opt: torch.optim.Optimizer, params, grads, max_grad_norm: Optional[float] = None,
                     split=None, mesh=None) -> None:
    """One optimizer step of ``params`` with ``grads``, clipped first when
    ``max_grad_norm`` is given (``optax.chain(clip_by_global_norm(max_grad_norm),
    optimizer)``; on a mesh over ``split``, :func:`clip_by_global_norm`); the grads
    are cleared after."""
    if max_grad_norm is not None:
        grads = clip_by_global_norm(grads, max_grad_norm, split, mesh)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _mesh_step(tcfg: FluxStatic, t_sampling: str = "uniform"):
    """→ ``loss_and_grads(model, tensors, batch, generator, t, noise)``: the loss over
    the whole batch and its gradients, on one rank or on ``tcfg.mesh``
    (:func:`dp_loss_and_grads`)."""

    def loss_and_grads(model, tensors, batch, generator, t, noise):
        def loss_fn(local, t_l, noise_l):
            return flow_matching_loss(model, tcfg, local, generator, t_sampling, t_l, noise_l)

        return dp_loss_and_grads(loss_fn, tensors, tcfg.mesh, batch, generator, t_sampling, t, noise)

    return loss_and_grads


def make_train_step(cfg: FluxStatic, remat: bool = True, lr: float = 1e-4):
    """→ ``step(params, batch, generator=None, t=None, noise=None) -> (params, loss)``: one
    SGD step of every float tensor of ``params`` (updated in place; the same tree is
    returned). Training runs the differentiable attention path (``use_pallas=False``)
    and, with ``remat`` (default on), recomputes each block in backward. On a mesh
    (``cfg.mesh``) ``batch`` is the whole batch on every rank and the tree this rank's
    shard."""
    tcfg = train_cfg(cfg, remat)
    loss_and_grads = _mesh_step(tcfg)

    def step(params, batch, generator=None, t=None, noise=None):
        tensors = trainable_tensors(params)
        loss, grads = loss_and_grads(params, tensors, batch, generator, t, noise)
        sgd_update(tensors, grads, lr)
        return params, loss

    return step


def make_optimizer_train_step(cfg: FluxStatic, optimizer: OptimizerFactory, remat: bool = True,
                              t_sampling: str = "uniform", max_grad_norm: Optional[float] = None):
    """Train step with a ``torch.optim`` optimizer (JAX ``make_optax_train_step``) →
    ``(init_fn, step_fn)``: ``init_fn(params) -> opt`` builds ``optimizer(tensors)``
    over every float tensor of the tree; ``step_fn(params, opt, batch, generator,
    t=None, noise=None) -> (params, opt, loss)`` updates in place. ``max_grad_norm``
    clips first, as ``optax.chain(clip_by_global_norm(max_grad_norm), ...)`` does. On a
    mesh as :func:`make_train_step`; the moments are laid out like the parameters."""
    tcfg = train_cfg(cfg, remat)
    loss_and_grads = _mesh_step(tcfg, t_sampling)

    def init_fn(params):
        return optimizer(trainable_tensors(params))

    def step_fn(params, opt, batch, generator=None, t=None, noise=None):
        tensors = trainable_tensors(params)
        loss, grads = loss_and_grads(params, tensors, batch, generator, t, noise)
        optimizer_update(opt, tensors, grads, max_grad_norm, split_axes(params, tensors, tcfg), tcfg.mesh)
        return params, opt, loss

    return init_fn, step_fn


def make_lora_train_step(cfg: FluxStatic, optimizer: OptimizerFactory, remat: bool = True,
                         t_sampling: str = "uniform", max_grad_norm: Optional[float] = None):
    """QLoRA: gradients only into rank-r adapters on a frozen base → ``(init_fn,
    step_fn)`` with ``init_fn(adapters) -> opt`` and ``step_fn(adapters, opt, base,
    batch, generator, t=None, noise=None) -> (adapters, opt, loss)``.

    The forward runs on :func:`~..lora.merge_lora_adapters`'s skeleton copy of
    ``base`` with ``use_pallas=False``, the dequantize path of the quantized linears
    (the serving kinds round the activation, which has no gradient) and ``remat``, as
    JAX forces them. The base's tensors never require grad and are never written, so
    its bytes stay as they were; the adapters are updated in place. The result goes
    to serving through ``lora.save_lora_adapters`` → ``pipeline.load_lora``. On a
    mesh the base is this rank's shard and the adapters are whole on every rank (JAX
    replicates them), in the base's layout: a column-parallel leaf's branch keeps the
    rank's rows of B, a row-parallel leaf's reduces ``x·Aᵀ`` over tp first
    (``ops/quant.py``)."""
    tcfg = train_cfg(cfg, remat, dequant=True)
    loss_and_grads = _mesh_step(tcfg, t_sampling)

    def init_fn(adapters: Adapters):
        return optimizer([p.requires_grad_() for p in adapter_tensors(adapters)])

    def step_fn(adapters: Adapters, opt, base: ParamTree, batch, generator=None, t=None, noise=None):
        tensors = adapter_tensors(adapters)
        loss, grads = loss_and_grads(merge_lora_adapters(base, adapters), tensors, batch, generator, t, noise)
        optimizer_update(opt, tensors, grads, max_grad_norm)
        return adapters, opt, loss

    return init_fn, step_fn


def make_dummy_batch(cfg: FluxStatic, batch: int, h_latent: int, w_latent: int, txt_len: int,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A batch of N(0, 1) latents, text and vector in the compute dtype, with the id
    grids, on the generator's device."""
    device = generator.device
    seq = (h_latent // 2) * (w_latent // 2)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(cfg.dtype)

    return {
        "latents": normal(batch, seq, cfg.in_channels),
        "txt": normal(batch, txt_len, cfg.context_in_dim),
        "y": normal(batch, cfg.vec_in_dim),
        "img_ids": make_img_ids(h_latent, w_latent, batch, device),
        "txt_ids": make_txt_ids(txt_len, batch, device),
    }


# ------------------------------------------------------------------- save / resume


def flat_tensors(tree) -> Dict[str, torch.Tensor]:
    """Path → tensor of a module's buffers, or of a nested dict/list of tensors."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_buffers())
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            out[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}.{i}" if prefix else str(i))

    walk(tree, "")
    return out


class StateMap:
    """The map between a rank's tensors and the state file's whole ones: the file
    holds each tensor whole, in the flat fused layout, under its global block index.
    ``cfg`` (None: one rank, flat) gives the layout and the mesh (tp slices, pp
    stages)."""

    STACKS = {"double_blocks": "depth", "single_blocks": "depth_single_blocks"}

    def __init__(self, params, cfg: Optional[FluxStatic]):
        from ..utils.checkpoint import grouped_permutations

        self.cfg = cfg
        self.mesh = None if cfg is None else cfg.mesh
        self.perms = grouped_permutations(cfg) if cfg is not None and cfg.fused_layout == "grouped" else {}
        self.modules = dict(params.named_modules()) if isinstance(params, torch.nn.Module) else {}

    def _where(self, name: str):
        """(stack, local block, leaf, field) of a block tensor, else None."""
        parts = name.split(".")
        if parts[0] in self.STACKS and len(parts) >= 3:
            return parts[0], int(parts[1]), parts[2], parts[-1]
        return None

    def _stage(self, stack: str) -> Optional[range]:
        """This pp stage's global blocks of ``stack`` where the stages split it, else None."""
        from .mesh import stage_blocks

        if self.mesh is None:
            return None
        depth = getattr(self.cfg, self.STACKS[stack])
        keep = stage_blocks(depth, self.mesh)
        return keep if len(keep) < depth else None

    def _perm(self, where, inverse: bool):
        """(dim, index) of the layout permutation of this tensor, or None."""
        if where is None or where[2] not in self.perms:
            return None
        axis, perm = self.perms[where[2]]
        field = where[3]
        dim = {("out", "weight"): 0, ("out", "bias"): 0, ("out", "b"): 0, ("in", "weight"): 1,
               ("in", "a"): 1}.get((axis, field))
        if dim is None:
            return None
        return dim, torch.as_tensor(np.argsort(perm) if inverse else perm)

    def _tp(self, name: str):
        """(dim, mesh, axis) of a tensor sliced over tp, or None."""
        from .mesh import _linear_spec

        lin = self.modules.get(name.rsplit(".", 1)[0])
        if not isinstance(lin, Linear) or lin.shard is None:
            return None
        dim = _linear_spec(lin.shard.mode).get(name.rsplit(".", 1)[1])
        return None if dim is None else (dim, lin.shard.mesh, lin.shard.axis)

    def names(self, name: str) -> List[str]:
        """The global names behind this rank's tensor ``name``: one per pp stage where
        the stages split its stack (in stage order), else ``name``."""
        where = self._where(name)
        stage = None if where is None else self._stage(where[0])
        if stage is None:
            return [name]
        rest = name.split(".", 2)[2]
        return [f"{where[0]}.{where[1] + s * len(stage)}.{rest}" for s in range(self.mesh.size("pp"))]

    def whole(self, name: str, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """→ {global name: whole host tensor} of this rank's ``t`` (every rank calls
        it for every tensor, in the same order: it gathers)."""
        t = t.detach()
        tp = self._tp(name)
        if tp is not None:
            t = tp[1].all_gather(t, tp[2], tp[0])
        perm = self._perm(self._where(name), inverse=True)
        if perm is not None:
            t = t.index_select(perm[0], perm[1].to(t.device))
        names = self.names(name)
        if len(names) == 1:
            return {name: t.cpu()}
        return dict(zip(names, self.mesh.all_gather(t.contiguous()[None], "pp", 0).cpu()))

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``t`` saved for ``name``."""
        perm = self._perm(self._where(name), inverse=False)
        if perm is not None:
            t = t.index_select(perm[0], perm[1])
        tp = self._tp(name)
        if tp is not None:
            n = t.shape[tp[0]] // tp[1].size(tp[2])
            t = t.narrow(tp[0], tp[1].rank(tp[2]) * n, n)
        return t

    def own(self, name: str) -> str:
        """The global name of this rank's tensor ``name``."""
        names = self.names(name)
        return names[self.mesh.rank("pp")] if len(names) > 1 else name


def whole_tensors(tree, cfg: Optional[FluxStatic] = None, tensors=None) -> Dict[str, torch.Tensor]:
    """{name at its global block index: whole host tensor} of the tree's (or
    adapters') tensors, or of only ``tensors``: as the state file holds them
    (:class:`StateMap`). On a mesh every rank must call it: it gathers."""
    canon = StateMap(tree, cfg)
    want = None if tensors is None else {id(x) for x in tensors}
    out: Dict[str, torch.Tensor] = {}
    for name, x in flat_tensors(tree).items():
        if want is None or id(x) in want:
            out.update(canon.whole(name, x))
    return out


def local_adapters(whole: Dict[str, torch.Tensor], cfg: Optional[FluxStatic] = None, device=None) -> Adapters:
    """Adapters from ``{"stack.i.leaf.a|b": whole tensor}`` (flat layout, as
    :func:`whole_tensors` gives them) in ``cfg``'s fused layout, each a leaf that
    requires grad: what every rank of a mesh trains."""
    canon = StateMap({}, cfg)
    out: Adapters = {}
    for key in sorted(whole, key=lambda k: (k.split(".")[0], int(k.split(".")[1]), k)):
        stack, i, leaf, ab = key.split(".")
        blocks = out.setdefault(stack, [])
        while len(blocks) <= int(i):
            blocks.append({})
        x = canon.local(key, whole[key]).to(device).contiguous()
        blocks[int(i)].setdefault(leaf, {})[ab] = x.requires_grad_()
    return out


def _opt_names(params, opt) -> List[Tuple[str, torch.Tensor]]:
    """(name in the tree, tensor) of every tensor the optimizer steps."""
    names = {id(t): k for k, t in flat_tensors(params).items()}
    return [(names[id(p)], p) for group in opt.param_groups for p in group["params"]]


def save_train_state(path, params, opt_state, step: int, overwrite: bool = False,
                     cfg: Optional[FluxStatic] = None) -> None:
    """Write ``{format, params, opt_state, step}`` into the directory ``path`` as one
    ``torch.save`` file: a temporary file in that directory, then ``os.replace``, so a
    reader never sees half a state. ``params`` is a tree (module) or adapters;
    ``opt_state`` a ``torch.optim`` optimizer or None. Raises when a state is there
    already, unless ``overwrite`` (the trainer's one rolling state).

    Every tensor is written whole, in the flat layout, at its global block index: with
    ``cfg`` on a mesh (``cfg.mesh``) every rank calls this, the tp slices and pp
    stages are gathered and the first rank writes; ``cfg.fused_layout`` "grouped" is
    inverted. An optimizer's per-tensor state is keyed by its tensor's name and goes
    through the same map. On a mesh a failure of the first rank (the file exists, the
    write fails) raises on every rank."""
    canon = StateMap(params, cfg)
    mesh = canon.mesh
    target = os.path.join(path, STATE_FILE)
    root = mesh is None or mesh.is_root
    error: Optional[BaseException] = None
    if root:
        try:
            os.makedirs(path, exist_ok=True)
            if os.path.exists(target) and not overwrite:
                raise FileExistsError(f"{target} exists (pass overwrite=True to replace it)")
        except OSError as exc:
            error = exc
    _raise_together(mesh, error, "saving the train state failed on the first rank")
    whole: Dict[str, torch.Tensor] = {}
    for name, t in flat_tensors(params).items():
        whole.update(canon.whole(name, t))
    opt = None
    if hasattr(opt_state, "param_groups"):
        opt = {"state": {}, "param_groups": [{k: v for k, v in g.items() if k != "params"}
                                             for g in opt_state.param_groups]}
        for name, p in _opt_names(params, opt_state):
            entries = {g: {} for g in canon.names(name)}
            for k, v in opt_state.state.get(p, {}).items():
                parts = canon.whole(name, v) if isinstance(v, torch.Tensor) and v.shape == p.shape and v.dim() else {}
                for g in entries:
                    entries[g][k] = parts.get(g, v)
            opt["state"].update(entries)
    if root:
        state = {"format": STATE_FORMAT, "params": whole, "opt_state": opt if opt is not None else opt_state,
                 "step": int(step)}
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=path, prefix=".train_state.", suffix=".tmp")
            os.close(fd)
            torch.save(state, tmp)
            os.replace(tmp, target)
        except Exception as exc:  # raised below, on every rank
            error = exc
        finally:
            if tmp is not None and os.path.exists(tmp):
                os.remove(tmp)
    # no rank goes on (and reads) before the file is there
    _raise_together(mesh, error, "saving the train state failed on the first rank")


def _raise_together(mesh, error: Optional[BaseException], other: str) -> None:
    """Raise ``error`` where it was caught and a RuntimeError(``other``) on every other
    rank of ``mesh`` (no rank is left waiting in a collective), or nothing."""
    failed = error is not None
    if mesh is not None:
        failed = mesh.any_failed(failed)
    if error is not None:
        raise error
    if failed:
        raise RuntimeError(other)


def restore_train_state(path, params_template, opt_state_template, cfg: Optional[FluxStatic] = None):
    """→ ``(params, opt_state, step)`` from :func:`save_train_state`'s directory. The
    templates (the same tree or adapters, and the same kind of optimizer) receive the
    saved values in place, on their own devices, and are returned. With ``cfg`` on a
    mesh each rank takes its part of the whole tensors: its stage's blocks, the
    grouped layout, its tp slice (the shard rules), whatever mesh wrote the file."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if state.get("format") != STATE_FORMAT:
        raise ValueError(f"train state at {path} has format {state.get('format', 1)}, this version reads "
                         f"format {STATE_FORMAT} (whole tensors and optimizer state keyed by name): "
                         "start the run anew or restore it with the version that wrote it")
    canon = StateMap(params_template, cfg)
    dest = flat_tensors(params_template)
    names = {g for k in dest for g in canon.names(k)}
    if sorted(state["params"]) != sorted(names):
        raise ValueError(f"train state at {path} does not match the template's tensors")
    with torch.no_grad():
        for k, t in dest.items():
            t.copy_(canon.local(k, state["params"][canon.own(k)]))
    opt, saved = opt_state_template, state["opt_state"]
    if hasattr(opt, "param_groups") and saved is not None:
        for group, hyper in zip(opt.param_groups, saved["param_groups"]):
            group.update({k: v for k, v in hyper.items() if k != "params"})
        for name, p in _opt_names(params_template, opt):
            entries = {}
            for k, v in saved["state"].get(canon.own(name), {}).items():
                moment = isinstance(v, torch.Tensor) and v.dim() > 0  # saved whole, like its tensor
                entries[k] = canon.local(name, v).to(p.device).clone() if moment else v
            opt.state[p] = entries
    elif saved is not None:
        opt = saved
    return params_template, opt, state["step"]
