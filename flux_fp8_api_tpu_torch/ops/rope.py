"""Multi-axis rotary position embeddings in the half-split layout
(JAX counterpart: ``flux_fp8_api_tpu.ops.rope``, whose docstring argues the layout).

A pair is (x[k], x[k + d/2]); ``out = x·[cos; cos] + rotate_half(x)·[sin; sin]`` with
``rotate_half(x) = concat(−x[d/2:], x[:d/2])``. Tables are fp32 and full head width.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def deinterleave_permutation(head_dim: int) -> np.ndarray:
    """Channel permutation from the reference's interleaved rope pairs onto the
    half-split layout: channel 2j → j, channel 2j+1 → j + head_dim/2."""
    perm = np.empty(head_dim, dtype=np.int64)
    half = head_dim // 2
    perm[np.arange(half)] = np.arange(0, head_dim, 2)
    perm[np.arange(half, head_dim)] = np.arange(1, head_dim, 2)
    return perm


def rope_cos_sin(pos: torch.Tensor, dim: int, theta: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for one position axis (reference ``rope``, flux_model.py:49-57):
    (..., n) positions → two (..., n, dim // 2) fp32 tables."""
    if dim % 2:
        raise ValueError(f"rope dim must be even, got {dim}")
    scale = torch.arange(0, dim, 2, dtype=torch.float32, device=pos.device) / dim
    omega = 1.0 / (theta**scale)
    out = pos.float()[..., None] * omega
    return torch.cos(out), torch.sin(out)


def embed_nd_cos_sin(
    ids: torch.Tensor, axes_dim: Sequence[int], theta: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n, n_axes) positions → (cos, sin), each (..., n, sum(axes_dim)) fp32:
    every axis's per-pair angles, then the same angles again for the second half."""
    if ids.shape[-1] != len(axes_dim):
        raise ValueError(f"ids have {ids.shape[-1]} axes, axes_dim has {len(axes_dim)}")
    parts = [rope_cos_sin(ids[..., i], d, theta) for i, d in enumerate(axes_dim)]
    cos_half = torch.cat([c for c, _ in parts], dim=-1)
    sin_half = torch.cat([s for _, s in parts], dim=-1)
    return torch.cat([cos_half, cos_half], dim=-1), torch.cat([sin_half, sin_half], dim=-1)


def apply_rope(
    xq: torch.Tensor, xk: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q/k (..., seq, head_dim) by half-split pairs in fp32; cos/sin broadcast
    to (..., seq, head_dim). Results keep the input dtype."""

    def rot(x):
        x32 = x.float()
        half = x32.shape[-1] // 2
        rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
        return (x32 * cos + rotated * sin).to(x.dtype)

    return rot(xq), rot(xk)
