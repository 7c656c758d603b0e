"""T5 v1.1 and CLIP text encoders in float32 (HF ``modeling_t5`` / ``modeling_clip``).

T5: RMS norms without bias, unscaled attention with a bidirectional relative position
bias (32 buckets, max distance 128) computed once and shared, gated GELU (tanh), no
attention mask. CLIP: learned positions, causal mask, quick GELU, affine LayerNorm
(eps 1e-5), pooled at the first ``eos_token_id`` or, for the openai configs whose
``eos_token_id`` is 2, at the largest id (HF's legacy rule).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .quant import QLinear


def _rms(x, w, eps):
    return w.float() * x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _buckets(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    num_buckets //= 2
    ret = (rel > 0).to(torch.int64) * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.int64)
    return ret + torch.where(n < max_exact, n, torch.clamp(large, max=num_buckets - 1))


class T5:
    def __init__(self, c: Dict, get, grid: str):
        self.c = c
        self.shared = get("shared.weight")
        self.rel = get("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight").float()
        self.final = get("encoder.final_layer_norm.weight")
        self.layers = []
        for i in range(c["num_layers"]):
            b = f"encoder.block.{i}.layer."
            lin = {n: QLinear(get(b + k), None, grid) for n, k in (
                ("q", "0.SelfAttention.q.weight"), ("k", "0.SelfAttention.k.weight"),
                ("v", "0.SelfAttention.v.weight"), ("o", "0.SelfAttention.o.weight"),
                ("wi_0", "1.DenseReluDense.wi_0.weight"), ("wi_1", "1.DenseReluDense.wi_1.weight"),
                ("wo", "1.DenseReluDense.wo.weight"))}
            lin["ln1"], lin["ln2"] = get(b + "0.layer_norm.weight"), get(b + "1.layer_norm.weight")
            self.layers.append(lin)

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        c, eps = self.c, 1e-6
        b, l = ids.shape
        h, dk = c["num_heads"], c["d_kv"]
        x = self.shared.float()[ids]
        pos = torch.arange(l, device=ids.device)
        bias = self.rel[_buckets(pos[None, :] - pos[:, None], c["relative_attention_num_buckets"],
                                 c["relative_attention_max_distance"])].permute(2, 0, 1)[None]
        for ly in self.layers:
            y = _rms(x, ly["ln1"], eps)
            q, k, v = (ly[n](y).reshape(b, l, h, dk) for n in ("q", "k", "v"))
            p = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k) + bias, dim=-1)
            x = x + ly["o"](torch.einsum("bhlm,bmhd->blhd", p, v).reshape(b, l, h * dk))
            y = _rms(x, ly["ln2"], eps)
            x = x + ly["wo"](F.gelu(ly["wi_0"](y), approximate="tanh") * ly["wi_1"](y))
        return _rms(x, self.final, eps)


class CLIP:
    def __init__(self, c: Dict, get, grid: str):
        self.c = c
        t = "text_model."
        self.tok = get(t + "embeddings.token_embedding.weight")
        self.pos = get(t + "embeddings.position_embedding.weight")
        self.final = (get(t + "final_layer_norm.weight"), get(t + "final_layer_norm.bias"))
        self.layers = []
        for i in range(c["num_layers"]):
            b = f"{t}encoder.layers.{i}."
            ly = {n: QLinear(get(f"{b}{k}.weight"), get(f"{b}{k}.bias"), grid) for n, k in (
                ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
                ("o", "self_attn.out_proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))}
            for n in ("layer_norm1", "layer_norm2"):
                ly[n] = (get(f"{b}{n}.weight"), get(f"{b}{n}.bias"))
            self.layers.append(ly)

    def _ln(self, x, p):
        return F.layer_norm(x, (x.shape[-1],), p[0].float(), p[1].float(), 1e-5)

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, L) ids → the pooled (B, hidden) state."""
        c = self.c
        b, l = ids.shape
        h = c["num_heads"]
        hd = c["hidden_size"] // h
        x = self.tok.float()[ids] + self.pos.float()[None, :l]
        causal = torch.triu(torch.full((l, l), float("-inf"), device=ids.device), diagonal=1)
        for ly in self.layers:
            y = self._ln(x, ly["layer_norm1"])
            q = ly["q"](y).reshape(b, l, h, hd) * hd**-0.5
            k, v = (ly[n](y).reshape(b, l, h, hd) for n in ("k", "v"))
            p = torch.softmax(torch.einsum("blhd,bmhd->bhlm", q, k) + causal, dim=-1)
            x = x + ly["o"](torch.einsum("bhlm,bmhd->blhd", p, v).reshape(b, l, h * hd))
            y = ly["fc1"](self._ln(x, ly["layer_norm2"]))
            x = x + ly["fc2"](y * torch.sigmoid(1.702 * y))
        x = self._ln(x, self.final)
        if c["eos_token_id"] == 2 and c["vocab_size"] >= 49408:
            pos = torch.argmax(ids, dim=-1)
        else:
            pos = torch.argmax((ids == c["eos_token_id"]).to(torch.int32), dim=-1)
        return x[torch.arange(b, device=ids.device), pos]
