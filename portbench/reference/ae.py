"""The FLUX autoencoder's decoder in float32, after BFL's ``flux/modules/autoencoder.py``:
conv_in, a middle of resnet / attention / resnet, up levels of ``num_res_blocks + 1``
resnets each followed (but for the last) by nearest ×2 and a 3×3 conv, then group
norm, swish and conv_out. Group norms have 32 groups and eps 1e-6. ``grid`` "wo_fp8"
rounds every conv weight to e4m3 with one scale per output channel (the control).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .quant import E4M3_MAX, fp8_scale

QUERY_CHUNK = 4096  # attention queries per product in the middle block


class Decoder:
    def __init__(self, a: Dict, w, grid: str = "none"):
        self.a, self.w, self.grid = a, w, grid

    def _weight(self, name):
        w = self.w.get(name).float()
        if self.grid == "wo_fp8" and w.dim() == 4:
            s = fp8_scale(w.abs().amax(dim=(1, 2, 3)), E4M3_MAX)[:, None, None, None]
            w = torch.clamp(w * s, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).float() / s
        return w

    def conv(self, name, x, pad=None):
        w = self._weight(f"{name}.weight")
        return F.conv2d(x, w, self.w.get(f"{name}.bias").float(), padding=w.shape[-1] // 2 if pad is None else pad)

    def gn(self, name, x):
        return F.group_norm(x, 32, self.w.get(f"{name}.weight").float(), self.w.get(f"{name}.bias").float(), 1e-6)

    def resnet(self, name, x):
        h = self.conv(f"{name}.conv1", F.silu(self.gn(f"{name}.norm1", x)))
        h = self.conv(f"{name}.conv2", F.silu(self.gn(f"{name}.norm2", h)))
        if f"{name}.nin_shortcut.weight" in self.w:
            x = self.conv(f"{name}.nin_shortcut", x)
        return x + h

    def attn(self, name, x):
        h = self.gn(f"{name}.norm", x)
        b, c, hh, ww = x.shape
        q, k, v = (self.conv(f"{name}.{n}", h).reshape(b, c, -1).transpose(1, 2) for n in ("q", "k", "v"))
        out = torch.cat([torch.softmax(q[:, i:i + QUERY_CHUNK] @ k.transpose(1, 2) * c**-0.5, dim=-1) @ v
                         for i in range(0, q.shape[1], QUERY_CHUNK)], dim=1)
        return x + self.conv(f"{name}.proj_out", out.transpose(1, 2).reshape(b, c, hh, ww))

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, z, h, w) → image (B, 3, 8h, 8w) in about [-1, 1]."""
        a = self.a
        z = z.float() / a["scale_factor"] + a["shift_factor"]
        h = self.conv("decoder.conv_in", z)
        h = self.resnet("decoder.mid.block_1", h)
        h = self.attn("decoder.mid.attn_1", h)
        h = self.resnet("decoder.mid.block_2", h)
        for i in reversed(range(len(a["ch_mult"]))):
            for j in range(a["num_res_blocks"] + 1):
                h = self.resnet(f"decoder.up.{i}.block.{j}", h)
            if i != 0:
                h = self.conv(f"decoder.up.{i}.upsample.conv", F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv("decoder.conv_out", F.silu(self.gn("decoder.norm_out", h)))


def to_pixels(y: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [-1, 1] → (B, H, W, 3) uint8, as the served image rounds it."""
    y = torch.clamp(y.permute(0, 2, 3, 1).float(), -1.0, 1.0)
    return torch.floor(torch.clamp((y + 1.0) * 127.5, 0.0, 255.0)).to(torch.uint8)
