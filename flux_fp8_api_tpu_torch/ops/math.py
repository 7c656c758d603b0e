"""Elementwise and normalisation math for the FLUX DiT
(JAX counterpart: ``flux_fp8_api_tpu.ops.math``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def timestep_embedding(
    t: torch.Tensor, dim: int, max_period: int = 10000, time_factor: float = 1000.0
) -> torch.Tensor:
    """Sinusoidal timestep embedding (reference ``modules/flux_model.py:95-116``):
    (N,) → (N, dim) fp32 ``[cos(args), sin(args)]``, zero-padded for odd dim."""
    t = time_factor * t.float()
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back (reference ``flux_model.py:158-164``)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters, in fp32, cast back (reference
    ``nn.LayerNorm(hidden, elementwise_affine=False, eps=1e-6)``)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (reference ``nn.GELU(approximate="tanh")``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation ``(1 + scale) * x + shift``; shift/scale are (B, 1, D)."""
    return (1.0 + scale) * x + shift


def clamp_policy(x: torch.Tensor, do_clamp: bool) -> torch.Tensor:
    """fp16-only ±32000 activation clamp (reference flux_model.py:397-399,481-483)."""
    if do_clamp:
        return torch.clamp(x, -32000.0, 32000.0)
    return x
