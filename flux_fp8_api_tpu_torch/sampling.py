"""Euler denoise loop and the step cache (JAX counterpart: ``flux_fp8_api_tpu.sampling``).

Both of the JAX package's drive modes exist: the per-step loop with an optional tqdm
bar (the reference's it/s metric, flux_pipeline.py:628-630) and the ``fused`` serving
mode, which here is the same Python loop without the bar. Capturing the fused loop in
a CUDA graph is later work (ROADMAP).

The step cache (:class:`CacheConfig`, JAX ``_denoise_scan_cached``) skips model
evaluations that would change little and reuses the last evaluated velocity. The JAX
scan decides on the device with ``lax.cond``; this eager loop decides on the host. The
``interval`` mode and forced steps need no device value. The ``dynamic`` mode keeps its
accumulated drift on the device and reads one boolean per unforced step: a device sync,
after which the card waits while the host enqueues the next step's first kernels. At
1024² on an H100 80GB HBM3 (700 W) an unforced ``dynamic`` step costs about 1.7 ms more
than an uncached step (the median of 16 alternating groups in two runs; ≈ 1% of a
200 ms step): 0.6–0.76 ms is the indicator's own device work, and the rest is that wait
(``dynamic`` at threshold 0 against the uncached loop, ``dynamic_sync_cost`` in
chip_smoke.py; PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from .models.flux import FluxStatic, flux_apply, flux_cache_indicator


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """The step cache of a request (JAX sampling.py:28-100), validated as there.

    - ``mode="interval"``: evaluate every ``interval``-th step.
    - ``mode="dynamic"``: evaluate when the relative L1 drift of
      :func:`~.models.flux.flux_cache_indicator`, accumulated since the last
      evaluation, reaches ``threshold``; ``coefficients`` (highest degree first)
      rescale each step's drift by a polynomial first.
    - ``order``: what a skipped step uses, 0 the last evaluated velocity, 1 its linear
      extrapolation in t from the last two evaluations.
    - The first ``warmup`` and the last ``tail`` steps always evaluate.

    Every field is a runtime value of one loop per (mode, order).
    """

    mode: str = "none"
    interval: int = 2
    threshold: float = 0.25
    warmup: int = 2
    tail: int = 1
    order: int = 0
    coefficients: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.mode not in ("none", "interval", "dynamic"):
            raise ValueError(f"cache mode must be none|interval|dynamic, got {self.mode!r}")
        if self.interval < 1:
            raise ValueError(f"cache interval must be >= 1, got {self.interval}")
        if self.warmup < 1:
            raise ValueError(f"cache warmup must be >= 1 (step 0 has nothing cached), got {self.warmup}")
        if self.tail < 0 or self.threshold < 0:
            raise ValueError("cache tail and threshold must be >= 0")
        if self.order not in (0, 1):
            raise ValueError(f"cache order must be 0 or 1, got {self.order}")

    @classmethod
    def parse(cls, spec) -> "CacheConfig":
        """Coerce None | CacheConfig | dict (HTTP request body) to a CacheConfig."""
        if spec is None:
            return cls(mode="none")
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, dict):
            known = {f.name for f in dataclasses.fields(cls)}
            bad = set(spec) - known
            if bad:
                raise ValueError(f"unknown cache option(s): {sorted(bad)}")
            if spec and "mode" not in spec:
                # the JAX package reads this as mode "none"; options without a mode
                # are a client error here, not a silently uncached request
                raise ValueError("cache options given without a cache mode")
            spec = dict(spec)
            if spec.get("coefficients") is not None:
                spec["coefficients"] = tuple(float(c) for c in spec["coefficients"])
            for k in ("interval", "warmup", "tail", "order"):
                if k in spec:
                    spec[k] = int(spec[k])
            if "threshold" in spec:
                spec["threshold"] = float(spec["threshold"])
            return cls(**spec)
        raise TypeError(f"cache must be None, CacheConfig or dict, got {type(spec)}")


def _euler(cfg: FluxStatic, img, t_curr: float, t_prev: float):
    """(t_vec, dt): the timestep vector in the compute dtype and the step size rounded
    as the JAX step rounds it (f32 difference, then the latent's dtype)."""
    b = img.shape[0]
    t_vec = torch.full((b,), t_curr, dtype=torch.float32, device=img.device).to(cfg.dtype)
    dt = (torch.tensor(t_prev, dtype=torch.float32) - torch.tensor(t_curr, dtype=torch.float32)).to(img.dtype)
    return t_vec, dt.to(img.device)


def _guidance_vec(cfg: FluxStatic, img, guidance: float):
    """The guidance vector in the compute dtype, or None for a model without guidance."""
    if not cfg.guidance_embed:
        return None
    return torch.full((img.shape[0],), float(guidance), dtype=torch.float32, device=img.device).to(cfg.dtype)


def _update(img, dt, pred):
    """The Euler update of every step, evaluated or cached."""
    return img + dt * pred


def make_denoise_step(cfg: FluxStatic, collect_amax: bool = False, stack_runner=None):
    """Bind the model config; returns ``step(model, img, img_ids, txt, txt_ids, vec,
    t_curr, t_prev, guidance)`` → img, or (img, amaxes) with ``collect_amax``.
    ``stack_runner``: as in ``flux_apply`` (pp)."""

    def step(model, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance):
        t_vec, dt = _euler(cfg, img, t_curr, t_prev)
        out = flux_apply(model, cfg, img, img_ids, txt, txt_ids, t_vec, vec, _guidance_vec(cfg, img, guidance),
                         collect_amax=collect_amax, stack_runner=stack_runner)
        if collect_amax:
            pred, amaxes = out
            return _update(img, dt, pred), amaxes
        return _update(img, dt, out)

    return step


def _polyval(coefficients, x: torch.Tensor) -> torch.Tensor:
    """Horner's rule in x's dtype, highest degree first (``jnp.polyval``)."""
    y = torch.zeros_like(x)
    for c in coefficients:
        y = y * x + c
    return y


def _relative_drift(ind: torch.Tensor, prev_ind: torch.Tensor, dp_mesh) -> torch.Tensor:
    """mean|ind − prev| / mean|prev| over the whole batch. With the batch's rows split
    over ``dp_mesh``'s dp ranks, the two sums are all-reduced first, so every rank
    takes the one decision that JAX's mean over a dp-sharded batch gives (each rank's
    own means would differ, ranks would skip different steps and the next collective
    would deadlock)."""
    if dp_mesh is None:
        return (ind - prev_ind).abs().mean() / (prev_ind.abs().mean() + 1e-8)
    sums = dp_mesh.all_reduce_sum(torch.stack([(ind - prev_ind).abs().sum(), prev_ind.abs().sum()]), "dp")
    n = ind.numel() * dp_mesh.size("dp")
    return (sums[0] / n) / (sums[1] / n + 1e-8)


def _denoise_cached(model, cfg: FluxStatic, cache: CacheConfig, img, img_ids, txt, txt_ids, vec,
                    timesteps, guidance: float, pairs, dp_mesh=None) -> Tuple[torch.Tensor, int]:
    """The Euler loop with the step cache (JAX ``_denoise_scan_cached``, sampling.py:175-271);
    → (img, model evaluations). ``pairs`` iterates (t_curr, t_prev) over ``timesteps``.

    The skip decision is the host's: ``interval`` and forced steps need no device value,
    ``dynamic`` reads its accumulated drift once per unforced step (``dp_mesh``: the
    mesh whose dp ranks each hold some of the batch rows). Timestep differences are
    fp32 tensors, as in the JAX scan (Python floats would give an fp64 slope)."""
    n_steps = len(timesteps) - 1
    dev = img.device
    ts = torch.tensor(timesteps, dtype=torch.float32, device=dev)
    g_vec = _guidance_vec(cfg, img, guidance)
    dynamic, first_order = cache.mode == "dynamic", cache.order == 1
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    accum, prev_ind = zero, None
    cached = prev = t_last = t_prev_last = None  # order 1: the last two evaluations, fp32
    n_evals = 0
    for i, (t_curr, t_prev) in enumerate(pairs):
        t_vec, dt = _euler(cfg, img, t_curr, t_prev)
        evaluate = i < cache.warmup or i >= n_steps - cache.tail
        if dynamic:
            ind = flux_cache_indicator(model, cfg, img, t_vec, vec, g_vec).float()
            if not evaluate:  # step 0 is forced (warmup >= 1), so prev_ind exists here
                rel = _relative_drift(ind, prev_ind, dp_mesh)
                if cache.coefficients is not None:
                    rel = _polyval(cache.coefficients, rel)
                accum = accum + rel.abs()
                evaluate = bool(accum >= cache.threshold)  # the step's one device sync
            prev_ind = ind
        elif not evaluate:
            evaluate = i % cache.interval == 0

        if evaluate:
            pred = flux_apply(model, cfg, img, img_ids, txt, txt_ids, t_vec, vec, g_vec)
            n_evals += 1
            accum = zero
            if first_order:
                prev, t_prev_last = cached, t_last
                cached, t_last = pred.float(), ts[i]
                pred = cached
            else:
                cached = pred
        elif first_order and prev is not None:
            slope = (cached - prev) / (t_last - t_prev_last)
            pred = cached + (ts[i] - t_last) * slope
        else:
            pred = cached
        img = _update(img, dt, pred.to(img.dtype) if first_order else pred)
    return img, n_evals


def denoise(
    model,
    cfg: FluxStatic,
    img: torch.Tensor,
    img_ids: torch.Tensor,
    txt: torch.Tensor,
    txt_ids: torch.Tensor,
    vec: torch.Tensor,
    timesteps,
    guidance: float,
    fused: bool = True,
    progress: bool = False,
    cache: Optional[CacheConfig] = None,
    stats: Optional[Dict[str, Any]] = None,
    dp_mesh=None,
    stack_runner=None,
) -> torch.Tensor:
    """Run the full denoise loop over ``timesteps`` (num_steps + 1 floats).
    ``fused=False`` with ``progress`` shows the per-step tqdm bar.

    ``cache`` with a mode other than "none" runs the step cache, and ``stats`` (if
    given) receives ``stats["model_evals"]``, the number of model evaluations (an int).
    ``dp_mesh``: the mesh over whose dp ranks the batch rows are split (the dynamic
    cache's drift is reduced over it). ``stack_runner`` plugs a block-stack strategy
    into ``flux_apply`` (``parallel/pp.py``); the step cache refuses one, as in JAX
    (sampling.py:280-318)."""
    if cache is not None and cache.mode != "none" and stack_runner is not None:
        raise ValueError("the step cache requires the default scan runner (it does not run under pp)")
    pairs = list(zip(timesteps[:-1], timesteps[1:]))
    if progress and not fused:
        from tqdm import tqdm

        pairs = tqdm(pairs)
    if cache is not None and cache.mode != "none":
        img, n_evals = _denoise_cached(model, cfg, cache, img, img_ids, txt, txt_ids, vec,
                                       timesteps, guidance, pairs, dp_mesh)
        if stats is not None:
            stats["model_evals"] = n_evals
        return img
    step = make_denoise_step(cfg, stack_runner=stack_runner)
    for t_curr, t_prev in pairs:
        img = step(model, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance)
    return img
