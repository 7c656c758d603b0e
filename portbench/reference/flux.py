"""The FLUX.1 flow transformer in float32, after BFL's ``flux/model.py`` and
``flux/modules/layers.py``: interleaved rotary pairs, qkv laid out as (K, H, D), RMS
qk-norms, adaLN modulation, joint attention over [txt; img], double then single
blocks. Every linear of the blocks is a :class:`QLinear` on the configuration's grid
(modulation included); the embedders and the final layer stay float, as the
configurations' ``quantize_flow_embedder_layers: false`` and the tier's partition say.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .quant import QLinear

HEAD_CHUNK = 8  # heads per attention product, to bound the float32 score matrix


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: int = 10000) -> torch.Tensor:
    t = 1000.0 * t.float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rope(ids: torch.Tensor, axes_dim, theta: int) -> torch.Tensor:
    """(B, L, n_axes) positions → (B, L, D/2, 2, 2) rotation matrices."""
    parts = []
    for i, d in enumerate(axes_dim):
        omega = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=ids.device) / d)
        ang = ids[..., i].double()[..., None] * omega
        parts.append(torch.stack([torch.cos(ang), -torch.sin(ang), torch.sin(ang), torch.cos(ang)], -1))
    return torch.cat(parts, dim=-2).reshape(*ids.shape[:2], -1, 2, 2).float()


def apply_rope(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """x (B, H, L, D), pe (B, 1, L, D/2, 2, 2)."""
    x_ = x.reshape(*x.shape[:-1], -1, 1, 2)
    return (pe[..., 0] * x_[..., 0] + pe[..., 1] * x_[..., 1]).reshape(x.shape)


def attention(q, k, v, pe) -> torch.Tensor:
    """(B, H, L, D) each → (B, L, H·D): softmax(q·kᵀ/√D)·v on rotated q and k."""
    q, k = apply_rope(q, pe), apply_rope(k, pe)
    out = []
    for h in range(0, q.shape[1], HEAD_CHUNK):
        s = q[:, h:h + HEAD_CHUNK] @ k[:, h:h + HEAD_CHUNK].transpose(-1, -2) / math.sqrt(q.shape[-1])
        out.append(torch.softmax(s, dim=-1) @ v[:, h:h + HEAD_CHUNK])
    x = torch.cat(out, dim=1)
    return x.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1)


def rms(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * scale.float()


def ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class Flux:
    """``w`` holds the BFL checkpoint's tensors (``w.get(name)``, ``name in w``);
    ``grid`` is the block linears'."""

    def __init__(self, p: Dict, w, grid: str):
        self.p = p
        self.hs, self.h = p["hidden_size"], p["num_heads"]

        get = w.get

        def f(name, g="none"):
            return QLinear(get(f"{name}.weight"), get(f"{name}.bias") if f"{name}.bias" in w else None, g)

        self.img_in, self.txt_in = f("img_in"), f("txt_in")
        emb = ["time_in", "vector_in"] + (["guidance_in"] if p["guidance_embed"] else [])
        self.emb = {e: (f(f"{e}.in_layer"), f(f"{e}.out_layer")) for e in emb}
        self.final = (f("final_layer.adaLN_modulation.1"), f("final_layer.linear"))
        self.double: List[Dict] = []
        for i in range(p["depth"]):
            b = f"double_blocks.{i}."
            blk = {}
            for s in ("img", "txt"):
                for n in ("mod.lin", "attn.qkv", "attn.proj", "mlp.0", "mlp.2"):
                    blk[f"{s}_{n}"] = f(b + f"{s}_{n}", grid)
                blk[f"{s}_q"] = get(b + f"{s}_attn.norm.query_norm.scale")
                blk[f"{s}_k"] = get(b + f"{s}_attn.norm.key_norm.scale")
            self.double.append(blk)
        self.single: List[Dict] = []
        for i in range(p["depth_single_blocks"]):
            b = f"single_blocks.{i}."
            self.single.append({"linear1": f(b + "linear1", grid), "linear2": f(b + "linear2", grid),
                                "mod": f(b + "modulation.lin", grid),
                                "q": get(b + "norm.query_norm.scale"), "k": get(b + "norm.key_norm.scale")})

    def linears(self):
        for blk in self.double + self.single:
            for v in blk.values():
                if isinstance(v, QLinear):
                    yield v

    def _qkv(self, qkv, qs, ks):
        b, l, _ = qkv.shape
        q, k, v = qkv.reshape(b, l, 3, self.h, -1).permute(2, 0, 3, 1, 4)
        return rms(q, qs), rms(k, ks), v

    def __call__(self, img, img_ids, txt, txt_ids, t, y, guidance=None) -> torch.Tensor:
        """img (B, L_img, 64), txt (B, L_txt, 4096), t and guidance (B,), y (B, 768)."""
        img, txt = self.img_in(img), self.txt_in(txt)

        def mlp_emb(name, x):
            a, b = self.emb[name]
            return b(F.silu(a(x)))

        vec = mlp_emb("time_in", timestep_embedding(t))
        if self.p["guidance_embed"]:
            vec = vec + mlp_emb("guidance_in", timestep_embedding(guidance))
        vec = vec + mlp_emb("vector_in", y)
        pe = rope(torch.cat([txt_ids, img_ids], dim=1), self.p["axes_dim"], self.p["theta"])[:, None]
        sv = F.silu(vec)[:, None, :]
        lt = txt.shape[1]
        for blk in self.double:
            im = blk["img_mod.lin"](sv).chunk(6, dim=-1)
            tm = blk["txt_mod.lin"](sv).chunk(6, dim=-1)
            iq, ik, iv = self._qkv(blk["img_attn.qkv"]((1 + im[1]) * ln(img) + im[0]), blk["img_q"], blk["img_k"])
            tq, tk, tv = self._qkv(blk["txt_attn.qkv"]((1 + tm[1]) * ln(txt) + tm[0]), blk["txt_q"], blk["txt_k"])
            a = attention(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2), torch.cat([tv, iv], 2), pe)
            ta, ia = a[:, :lt], a[:, lt:]
            img = img + im[2] * blk["img_attn.proj"](ia)
            img = img + im[5] * blk["img_mlp.2"](F.gelu(blk["img_mlp.0"]((1 + im[4]) * ln(img) + im[3]),
                                                       approximate="tanh"))
            txt = txt + tm[2] * blk["txt_attn.proj"](ta)
            txt = txt + tm[5] * blk["txt_mlp.2"](F.gelu(blk["txt_mlp.0"]((1 + tm[4]) * ln(txt) + tm[3]),
                                                       approximate="tanh"))
        x = torch.cat([txt, img], dim=1)
        for blk in self.single:
            shift, scale, gate = blk["mod"](sv).chunk(3, dim=-1)
            h = blk["linear1"]((1 + scale) * ln(x) + shift)
            q, k, v = self._qkv(h[..., :3 * self.hs], blk["q"], blk["k"])
            a = attention(q, k, v, pe)
            x = x + gate * blk["linear2"](torch.cat([a, F.gelu(h[..., 3 * self.hs:], approximate="tanh")], -1))
        x = x[:, lt:]
        shift, scale = self.final[0](sv).chunk(2, dim=-1)
        return self.final[1]((1 + scale) * ln(x) + shift)
