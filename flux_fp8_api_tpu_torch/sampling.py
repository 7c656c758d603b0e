"""Euler denoise loop (JAX counterpart: ``flux_fp8_api_tpu.sampling``).

Both of the JAX package's drive modes exist: the per-step loop with an optional tqdm
bar (the reference's it/s metric, flux_pipeline.py:628-630) and the ``fused`` serving
mode, which here is the same Python loop without the bar. Capturing the fused loop in
a CUDA graph is later work (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .models.flux import FluxStatic, flux_apply


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """The step-cache request option, validated like the JAX package's. Only
    ``mode="none"`` runs in this port; the cached modes are ROADMAP work."""

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
        if self.mode != "none":
            raise NotImplementedError(
                f"step cache mode {self.mode!r} is not ported yet (ROADMAP: step cache)"
            )

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


def make_denoise_step(cfg: FluxStatic, collect_amax: bool = False):
    """Bind the model config; returns ``step(model, img, img_ids, txt, txt_ids, vec,
    t_curr, t_prev, guidance)`` → img, or (img, amaxes) with ``collect_amax``."""

    def step(model, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance):
        t_vec, dt = _euler(cfg, img, t_curr, t_prev)
        g_vec = None
        if cfg.guidance_embed:
            g_vec = torch.full((img.shape[0],), float(guidance), dtype=torch.float32,
                               device=img.device).to(cfg.dtype)
        out = flux_apply(model, cfg, img, img_ids, txt, txt_ids, t_vec, vec, g_vec,
                         collect_amax=collect_amax)
        if collect_amax:
            pred, amaxes = out
            return img + dt * pred, amaxes
        return img + dt * out

    return step


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
) -> torch.Tensor:
    """Run the full denoise loop over ``timesteps`` (num_steps + 1 floats).
    ``fused=False`` with ``progress`` shows the per-step tqdm bar."""
    step = make_denoise_step(cfg)
    pairs = list(zip(timesteps[:-1], timesteps[1:]))
    if progress and not fused:
        from tqdm import tqdm

        pairs = tqdm(pairs)
    for t_curr, t_prev in pairs:
        img = step(model, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance)
    return img
