"""Joint-sequence attention for the FLUX DiT, BTNH layout at the public functions
(JAX counterpart: ``flux_fp8_api_tpu.ops.attention``).

Dispatch is by device only, inside :func:`~.attention_kernel.qknorm_attention`: CUDA
tensors run the hand-written kernel with the rope rotation fused in, CPU tensors run
its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention_kernel import qknorm_attention


def attention_core(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention over the joint (txt + img) sequence, optionally with rope.

    ROPE CONTRACT: the tables of batch row 0 are applied to every batch row, which is
    valid because FLUX builds one shared position grid per batch (as in the JAX
    package's fused path).

    Args:
      q, k, v: (B, L, N, H).
      cos, sin: optional rope tables, (B, L, 1, H) as the model builds them, or (L, H).
    Returns:
      (B, L, N, H) in q's dtype.
    """
    b, l, n, h = q.shape
    # fold batch into heads: (B, L, N, H) → (B·N, L, H); a view when B == 1
    qh, kh, vh = (x.permute(0, 2, 1, 3).reshape(b * n, x.shape[1], h) for x in (q, k, v))
    cos2d = sin2d = None
    if cos is not None:
        cos2d = (cos[0, :, 0, :] if cos.dim() == 4 else cos).float().contiguous()
        sin2d = (sin[0, :, 0, :] if sin.dim() == 4 else sin).float().contiguous()
    out = qknorm_attention(qh, kh, vh, 1.0 / (h**0.5), cos=cos2d, sin=sin2d)
    return out.reshape(b, n, l, h).permute(0, 2, 1, 3)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> torch.Tensor:
    """RoPE + attention + head merge (reference ``attention``, flux_model.py:41-45):
    (B, L, N, H) q/k/v → (B, L, N·H)."""
    b, l, n, h = q.shape
    return attention_core(q, k, v, cos=cos, sin=sin).reshape(b, l, n * h)
