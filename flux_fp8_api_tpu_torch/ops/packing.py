"""Latent 2×2 patchify/unpatchify and position-id grids
(JAX counterpart: ``flux_fp8_api_tpu.ops.packing``; reference flux_pipeline.py:268-292,
440-448)."""

from __future__ import annotations

import torch


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, (H/2)*(W/2), C*4), patch channel order (c, ph, pw)."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"latent dims must be even, got {h}x{w}")
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, (h w), (c ph pw)) → (B, C, H, W) with h=ceil(height/16), w=ceil(width/16)."""
    b, seq, feat = x.shape
    h = -(-height // 16)
    w = -(-width // 16)
    c = feat // 4
    if seq != h * w:
        raise ValueError(f"sequence {seq} != {h}*{w}")
    x = x.reshape(b, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h * 2, w * 2)


def make_img_ids(h_latent: int, w_latent: int, batch: int, device=None) -> torch.Tensor:
    """(B, (h/2)(w/2), 3) position ids: (0, row, col)."""
    h2, w2 = h_latent // 2, w_latent // 2
    ids = torch.zeros((h2, w2, 3), dtype=torch.float32, device=device)
    ids[..., 1] = torch.arange(h2, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] = torch.arange(w2, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(1, h2 * w2, 3).expand(batch, h2 * w2, 3)


def make_txt_ids(seq_len: int, batch: int, device=None) -> torch.Tensor:
    """Zero text position ids (reference ``flux_emphasis.py:433-439``)."""
    return torch.zeros((batch, seq_len, 3), dtype=torch.float32, device=device)
