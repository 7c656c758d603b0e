"""Pipeline parallelism (pp) over the depth of the block stacks (JAX counterpart:
``flux_fp8_api_tpu.parallel.pp``).

A stage is a contiguous depth slice of a stack (``mesh.py:stage_blocks``): each pp
rank holds depth/S blocks of every stack that its S stages divide, and the whole of a
stack they do not divide, which then runs on every stage as a plain loop (flux-dev's
19 doubles at S = 2). The batch of each dp rank splits into M microbatches that flow
through the stages in GPipe order: stage s runs microbatch m once stage s − 1 has
sent it, sends it on, and the last stage's outputs are broadcast to every stage, so
each pp rank takes the next Euler step on the whole result (JAX replicates it with a
``psum``). A stage with nothing to do waits in its ``recv``; JAX's SPMD schedule
instead computes the bubble ticks and drops them. The values are the same.

The backward is written by hand, since autograd does not cross ``dist.send``: each
stage keeps its microbatch inputs and the graph of its slice (each block under
``torch.utils.checkpoint`` with ``remat``), receives ∂out from the next stage, runs
``torch.autograd.backward`` on its slice and sends ∂in to the stage before it. The
∂vec_silu of every stage is summed over pp and stage 0's ∂carry is broadcast, so every
rank backpropagates the replicated layers around the stacks to the same gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import Mesh


def _as_tuple(carry) -> Tuple[torch.Tensor, ...]:
    return tuple(carry) if isinstance(carry, (tuple, list)) else (carry,)


def run_stack(body: Callable, carry, blocks: Sequence, extras, remat: bool = False):
    """``carry = body(carry, blk, extras)`` over ``blocks``; with ``remat`` under a
    gradient each block runs under ``torch.utils.checkpoint`` (only its inputs are
    kept for the backward)."""
    remat = remat and torch.is_grad_enabled()
    for blk in blocks:
        carry = checkpoint(body, carry, blk, extras, use_reentrant=False) if remat else body(carry, blk, extras)
    return carry


class PPRunner:
    """The stack runner of :func:`make_pp_runner`: ``runner(body, carry, blocks,
    extras, depth)`` → the carry after the stack, on every pp rank. ``blocks`` is the
    stage's slice of a stack of global depth ``depth``; ``carry`` a tensor or a tuple
    of tensors with the batch first; ``extras`` ``(vec_silu, cos, sin)``, split per
    microbatch with the carry."""

    def __init__(self, mesh: Mesh, num_microbatches: int, dp_axis: Optional[str], remat: bool):
        self.mesh, self.m, self.axis, self.remat = mesh, num_microbatches, "pp", remat
        self.stages = mesh.size("pp")
        self.dp = mesh.size(dp_axis) if dp_axis else 1

    def pipelines(self, depth: int) -> bool:
        return self.stages > 1 and depth % self.stages == 0

    def __call__(self, body: Callable, carry, blocks: Sequence, extras, depth: int):
        if not self.pipelines(depth):
            # no uniform stage partition: the stack is whole on every stage
            return run_stack(body, carry, blocks, extras, self.remat)
        batch = _as_tuple(carry)[0].shape[0]
        if batch % self.m:
            raise ValueError(f"batch {batch * self.dp} must split into dp={self.dp} shards of "
                             f"M={self.m} microbatches")
        tensors = _as_tuple(carry)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, extras[0])):
            out = _PipelinedStack.apply(self, body, blocks, len(tensors), *tensors, *extras)
        else:
            out, _ = self.forward(body, blocks, tensors, tuple(extras), keep=False)
        return out if isinstance(carry, (tuple, list)) else out[0]

    def _split(self, ts) -> List[tuple]:
        return list(zip(*(t.chunk(self.m, 0) for t in ts)))

    def forward(self, body, blocks, tensors: tuple, extras: tuple, keep: bool):
        """The GPipe forward on this stage → (the replicated outputs, with ``keep`` the
        stage's [(inputs, vec_silu, outputs)] per microbatch with their graphs)."""
        mesh, axis, s, last = self.mesh, self.axis, self.mesh.rank(self.axis), self.stages - 1
        outs, saved = [], []
        for xs, ex in zip(self._split(tensors), self._split(extras)):
            xs = xs if s == 0 else tuple(mesh.recv(x, axis, s - 1) for x in xs)
            if keep:  # the stage's own graph: its inputs as leaves
                xs = tuple(x.detach().requires_grad_(x.is_floating_point()) for x in xs)
                ex = (ex[0].detach().requires_grad_(), *ex[1:])
                with torch.enable_grad():
                    ys = _as_tuple(run_stack(body, xs if len(xs) > 1 else xs[0], blocks, ex, self.remat))
                saved.append((xs, ex[0], ys))
            else:
                ys = _as_tuple(run_stack(body, xs if len(xs) > 1 else xs[0], blocks, ex))
            if s < last:
                for y in ys:
                    mesh.send(y.detach(), axis, s + 1)
            else:
                outs.append(tuple(y.detach() for y in ys))
        if s == last:
            out = tuple(torch.cat(parts, 0).contiguous() for parts in zip(*outs))
        else:
            out = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors)
        for t in out:  # the last stage's result on every stage
            mesh.broadcast(t, axis, last)
        return out, saved

    def backward(self, saved, grads: tuple, like: tuple):
        """The GPipe backward on this stage → (∂ of the stack's input carry, ∂vec_silu),
        the same on every pp rank."""
        mesh, axis, s, last = self.mesh, self.axis, self.mesh.rank(self.axis), self.stages - 1
        splits = self._split(grads) if s == last else [None] * len(saved)
        d_in, d_vec = [], []
        for (xs, vec, ys), g in zip(saved, splits):
            g = g if s == last else tuple(mesh.recv(y, axis, s + 1) for y in ys)
            torch.autograd.backward(ys, g)
            dx = tuple(torch.zeros_like(x) if x.grad is None else x.grad for x in xs)
            if s > 0:
                for d in dx:
                    mesh.send(d, axis, s - 1)
            d_in.append(dx)
            d_vec.append(torch.zeros_like(vec) if vec.grad is None else vec.grad)
        if s == 0:
            carry = tuple(torch.cat(parts, 0).contiguous() for parts in zip(*d_in))
        else:
            carry = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in like)
        for t in carry:  # stage 0's ∂carry on every stage
            mesh.broadcast(t, axis, 0)
        d_vec = torch.cat(d_vec, 0)
        d_vec = mesh.all_reduce_sum(d_vec.float(), axis).to(d_vec.dtype)
        return carry, d_vec


class _PipelinedStack(torch.autograd.Function):
    """The pipelined stack as one autograd node: the forward keeps each stage's graph,
    the backward runs :meth:`PPRunner.backward`."""

    @staticmethod
    def forward(ctx, runner: PPRunner, body, blocks, n_carry: int, *tensors):
        carry, extras = tensors[:n_carry], tensors[n_carry:]
        out, saved = runner.forward(body, blocks, carry, extras, keep=True)
        ctx.runner, ctx.saved, ctx.like, ctx.n_extras = runner, saved, carry, len(extras)
        return out

    @staticmethod
    def backward(ctx, *grads):
        grads = tuple(torch.zeros_like(t) if g is None else g.contiguous() for g, t in zip(grads, ctx.like))
        d_carry, d_vec = ctx.runner.backward(ctx.saved, grads, ctx.like)
        ctx.saved = None
        return (None, None, None, None, *d_carry, d_vec, *([None] * (ctx.n_extras - 1)))


def make_pp_runner(mesh: Mesh, num_microbatches: int, dp_axis: Optional[str] = None,
                   remat: bool = False) -> PPRunner:
    """→ a ``stack_runner`` for :func:`~..models.flux.flux_apply` that pipelines each
    block stack over ``mesh``'s "pp" axis (JAX ``make_pp_runner``, parallel/pp.py:47-184).

    ``num_microbatches`` (M): each dp rank's batch splits into M microbatches, which
    needs ``batch/dp % M == 0`` (a ValueError at the call otherwise). ``remat`` runs
    each block under ``torch.utils.checkpoint`` under a gradient. pp composes only with
    dp: a tp or sp axis of more than one rank raises, as in JAX."""
    if "pp" not in mesh.shape:
        raise ValueError(f"mesh {tuple(mesh.shape)} has no 'pp' axis")
    other = [a for a, n in mesh.shape.items() if a not in ("pp", dp_axis) and n > 1]
    if other:
        raise ValueError(f"pp composes only with dp; mesh has non-trivial axes {other} "
                         "(tp/sp shard the same weights the pp stages hold whole)")
    if int(num_microbatches) < 1:
        raise ValueError("num_microbatches must be >= 1")
    return PPRunner(mesh, int(num_microbatches), dp_axis if dp_axis in mesh.shape else None, remat)


def make_pp_train_step(cfg, mesh: Mesh, num_microbatches: int, optimizer=None, dp_axis: Optional[str] = "dp",
                       remat: bool = True, t_sampling: str = "uniform", lr: float = 1e-4):
    """The full-parameter flow-matching step over a (dp, pp) mesh (JAX
    ``make_pp_train_step``, parallel/pp.py:187-241) on this rank's stage slice (the
    tree as :func:`~.mesh.setup_flux` leaves it).

    → ``step(params, batch, generator=None, t=None, noise=None) -> (params, loss)``
    (SGD at ``lr``) or, with ``optimizer`` (a factory such as ``train.adamw``),
    ``(init_fn, step_fn)`` with ``step_fn(params, opt, batch, generator=None, t=None,
    noise=None) -> (params, opt, loss)``. ``batch`` is the whole batch on every rank
    (each dp rank takes its rows; t and ε are drawn whole and sliced); the loss is the
    mean over the whole batch. Attention is the differentiable path
    (``use_pallas=False``): the rope pass and SDPA."""
    from .train import (
        dp_loss_and_grads, flow_matching_loss, optimizer_update, sgd_update, trainable_tensors, train_cfg,
    )

    tcfg = dataclasses.replace(train_cfg(cfg, remat=False), mesh=mesh)
    runner = make_pp_runner(mesh, num_microbatches, dp_axis, remat)

    def loss_and_grads(params, batch, generator, t, noise):
        tensors = trainable_tensors(params)
        for p in tensors:
            p.grad = None

        def loss_fn(local, t_l, noise_l):
            return flow_matching_loss(params, tcfg, local, generator, t_sampling, t_l, noise_l, stack_runner=runner)

        loss, grads = dp_loss_and_grads(loss_fn, tensors, mesh, batch, generator, t_sampling, t, noise,
                                        backward=True)
        for p in tensors:
            p.grad = None
        return tensors, loss, [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]

    if optimizer is None:
        def step(params, batch, generator=None, t=None, noise=None):
            tensors, loss, grads = loss_and_grads(params, batch, generator, t, noise)
            sgd_update(tensors, grads, lr)
            return params, loss

        return step

    def init_fn(params):
        return optimizer(trainable_tensors(params))

    def step_fn(params, opt, batch, generator=None, t=None, noise=None):
        tensors, loss, grads = loss_and_grads(params, batch, generator, t, noise)
        optimizer_update(opt, tensors, grads)
        return params, opt, loss

    return init_fn, step_fn
