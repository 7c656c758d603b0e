"""Flow-matching training on one device (JAX counterpart:
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
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Callable, Dict, List, Optional

import torch

from ..lora import Adapters, adapter_tensors, merge_lora_adapters
from ..models.flux import FluxStatic, flux_apply
from ..ops.packing import make_img_ids, make_txt_ids
from ..ops.quant import Linear
from ..ops.schedule import get_lin_function
from ..utils.tree import ParamTree

STATE_FILE = "train_state.pt"

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
) -> torch.Tensor:
    """Rectified-flow MSE in fp32: ``x_t = (1 − t)·x₀ + t·ε``, target ``ε − x₀``.

    ``batch``: ``latents`` (B, L, C) packed clean latents, ``txt``, ``y``, ``img_ids``,
    ``txt_ids``. t is drawn first (:func:`sample_timesteps`), then ε ~ N(0, 1) in fp32
    cast to the latents' dtype, both from ``generator``; given ``t`` or ``noise`` are
    used instead of a draw."""
    x0 = batch["latents"]
    b = x0.shape[0]
    if t is None:
        t = sample_timesteps(generator, b, x0.shape[1], t_sampling)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device).to(x0.dtype)
    t = t.to(x0.device, torch.float32)
    t_b = t.to(x0.dtype)[:, None, None]
    x_t = (1.0 - t_b) * x0 + t_b * noise
    guidance = torch.full((b,), 1.0, dtype=torch.float32, device=x0.device) if cfg.guidance_embed else None
    pred = flux_apply(model, cfg, x_t, batch["img_ids"], batch["txt"], batch["txt_ids"], t, batch["y"], guidance)
    target = noise - x0
    return torch.mean((pred.float() - target.float()) ** 2)


def train_cfg(cfg: FluxStatic, remat: bool, dequant: bool = False) -> FluxStatic:
    """The configuration a train step runs: the differentiable attention path,
    ``remat`` as asked, and for adapters the dequantize path of the quantized linears."""
    return dataclasses.replace(cfg, use_pallas=False, remat=remat, dequant_linears=dequant or cfg.dequant_linears)


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
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: with ‖g‖ the norm over every gradient, each g
    is kept while ‖g‖ < ``max_norm`` and otherwise becomes ``(g / ‖g‖)·max_norm``. The
    norm is accumulated in fp32 (optax's, in the gradients' dtype); no host sync: the
    choice is a ``torch.where``."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
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


def optimizer_update(opt: torch.optim.Optimizer, params, grads, max_grad_norm: Optional[float] = None) -> None:
    """One optimizer step of ``params`` with ``grads``, clipped first when
    ``max_grad_norm`` is given (``optax.chain(clip_by_global_norm(max_grad_norm),
    optimizer)``); the grads are cleared after."""
    if max_grad_norm is not None:
        grads = clip_by_global_norm(grads, max_grad_norm)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_step(cfg: FluxStatic, remat: bool = True, lr: float = 1e-4):
    """→ ``step(params, batch, generator, t=None, noise=None) -> (params, loss)``: one
    SGD step of every float tensor of ``params`` (updated in place; the same tree is
    returned). Training runs the differentiable attention path (``use_pallas=False``)
    and, with ``remat`` (default on), recomputes each block in backward."""
    tcfg = train_cfg(cfg, remat)

    def step(params, batch, generator=None, t=None, noise=None):
        tensors = trainable_tensors(params)
        loss = flow_matching_loss(params, tcfg, batch, generator, t=t, noise=noise)
        sgd_update(tensors, _grads(loss, tensors), lr)
        return params, loss.detach()

    return step


def make_optimizer_train_step(cfg: FluxStatic, optimizer: OptimizerFactory, remat: bool = True,
                              t_sampling: str = "uniform", max_grad_norm: Optional[float] = None):
    """Train step with a ``torch.optim`` optimizer (JAX ``make_optax_train_step``) →
    ``(init_fn, step_fn)``: ``init_fn(params) -> opt`` builds ``optimizer(tensors)``
    over every float tensor of the tree; ``step_fn(params, opt, batch, generator,
    t=None, noise=None) -> (params, opt, loss)`` updates in place. ``max_grad_norm``
    clips first, as ``optax.chain(clip_by_global_norm(max_grad_norm), ...)`` does."""
    tcfg = train_cfg(cfg, remat)

    def init_fn(params):
        return optimizer(trainable_tensors(params))

    def step_fn(params, opt, batch, generator=None, t=None, noise=None):
        tensors = trainable_tensors(params)
        loss = flow_matching_loss(params, tcfg, batch, generator, t_sampling, t, noise)
        optimizer_update(opt, tensors, _grads(loss, tensors), max_grad_norm)
        return params, opt, loss.detach()

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
    to serving through ``lora.save_lora_adapters`` → ``pipeline.load_lora``."""
    tcfg = train_cfg(cfg, remat, dequant=True)

    def init_fn(adapters: Adapters):
        return optimizer([p.requires_grad_() for p in adapter_tensors(adapters)])

    def step_fn(adapters: Adapters, opt, base: ParamTree, batch, generator=None, t=None, noise=None):
        tensors = adapter_tensors(adapters)
        loss = flow_matching_loss(merge_lora_adapters(base, adapters), tcfg, batch, generator,
                                  t_sampling, t, noise)
        optimizer_update(opt, tensors, _grads(loss, tensors), max_grad_norm)
        return adapters, opt, loss.detach()

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


def _flat(tree) -> Dict[str, torch.Tensor]:
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


def save_train_state(path, params, opt_state, step: int, overwrite: bool = False) -> None:
    """Write ``{params, opt_state, step}`` into the directory ``path`` as one
    ``torch.save`` file: a temporary file in that directory, then ``os.replace``, so a
    reader never sees half a state. ``params`` is a tree (module) or adapters;
    ``opt_state`` a ``torch.optim`` optimizer (its ``state_dict``) or None. Raises
    when a state is there already, unless ``overwrite`` (the trainer's one rolling
    state)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    if os.path.exists(target) and not overwrite:
        raise FileExistsError(f"{target} exists (pass overwrite=True to replace it)")
    state = {
        "params": {k: v.detach() for k, v in _flat(params).items()},
        "opt_state": opt_state.state_dict() if hasattr(opt_state, "state_dict") else opt_state,
        "step": int(step),
    }
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".train_state.", suffix=".tmp")
    os.close(fd)
    try:
        torch.save(state, tmp)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def restore_train_state(path, params_template, opt_state_template):
    """→ ``(params, opt_state, step)`` from :func:`save_train_state`'s directory. The
    templates (the same tree or adapters, and the same kind of optimizer) receive the
    saved values in place, on their own devices, and are returned."""
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    saved = state["params"]
    dest = _flat(params_template)
    if sorted(saved) != sorted(dest):
        raise ValueError(f"train state at {path} does not match the template's tensors")
    with torch.no_grad():
        for k, t in dest.items():
            t.copy_(saved[k])
    opt = opt_state_template
    if hasattr(opt, "load_state_dict"):
        opt.load_state_dict(state["opt_state"])
    elif state["opt_state"] is not None:
        opt = state["opt_state"]
    return params_template, opt, state["step"]
