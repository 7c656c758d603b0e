"""CLIP text encoder (JAX counterpart: ``flux_fp8_api_tpu.models.clip``).

HF CLIPTextModel semantics: learned absolute positions, causal mask, quick_gelu,
affine LayerNorm (eps 1e-5) in fp32, and pooling at the first eos token (with HF's
legacy argmax rule for openai-era configs whose eos_token_id is 2).

Under tensor parallelism (``parallel/mesh.py:shard_encoder_params``) each rank's
q/k/v and fc1 hold its heads and channels, and out_proj and fc2 all-reduce their
partial products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.quant import Linear, linear_apply, quantize_blocks_weight_only
from ..parallel.mesh import local_heads
from ..utils.config import into_device
from ..utils.tree import ParamTree


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "CLIPConfig":
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            max_position_embeddings=cfg["max_position_embeddings"],
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            eos_token_id=cfg.get("eos_token_id", 49407),
        )


def _ln(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["weight"].float(), p["bias"].float(), eps).to(x.dtype)


def _clip_attention(blk, x, cfg: CLIPConfig, dtype):
    b, l, d = x.shape
    hd = d // cfg.num_heads
    h = local_heads(cfg.num_heads, blk["q_proj"])[1]
    q = linear_apply(blk["q_proj"], x, dtype)[0].reshape(b, l, h, hd) * (hd**-0.5)
    k = linear_apply(blk["k_proj"], x, dtype)[0].reshape(b, l, h, hd)
    v = linear_apply(blk["v_proj"], x, dtype)[0].reshape(b, l, h, hd)
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    causal = torch.triu(torch.full((l, l), float("-inf"), device=x.device), diagonal=1)
    probs = torch.softmax(scores + causal, dim=-1).to(dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, h * hd)
    return linear_apply(blk["out_proj"], out, dtype)[0]


def _clip_block(blk, x, cfg: CLIPConfig, dtype):
    x = x + _clip_attention(blk, _ln(x, blk["layer_norm1"], cfg.layer_norm_eps), cfg, dtype)
    h = _ln(x, blk["layer_norm2"], cfg.layer_norm_eps)
    h = linear_apply(blk["fc1"], h, dtype)[0]
    h = linear_apply(blk["fc2"], h * torch.sigmoid(1.702 * h), dtype)[0]
    return x + h


def clip_encode(params: ParamTree, cfg: CLIPConfig, input_ids: torch.Tensor, dtype=torch.bfloat16):
    """(B, L) ids → (last_hidden_state (B, L, D), pooler_output (B, D))."""
    b, l = input_ids.shape
    x = params["token_embedding"].to(dtype)[input_ids]
    x = x + params["position_embedding"].to(dtype)[None, :l]
    for blk in params["blocks"]:
        x = _clip_block(blk, x, cfg, dtype)
    x = _ln(x, params["final_layer_norm"], cfg.layer_norm_eps)
    if cfg.eos_token_id == 2 and cfg.vocab_size >= 49408:
        eos_pos = torch.argmax(input_ids, dim=-1)
    else:
        eos_pos = torch.argmax((input_ids == cfg.eos_token_id).to(torch.int32), dim=-1)
    return x, x[torch.arange(b, device=x.device), eos_pos]


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator, dtype=torch.float32) -> ParamTree:
    """Random init on ``generator``'s device: N(0, 1)·0.02 matrices, zero biases."""
    device = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(dtype) * 0.02

    def lin(i, o):
        return Linear("float", weight=normal(o, i), bias=torch.zeros((o,), dtype=dtype, device=device))

    def lnp():
        return {
            "weight": torch.ones((cfg.hidden_size,), dtype=dtype, device=device),
            "bias": torch.zeros((cfg.hidden_size,), dtype=dtype, device=device),
        }

    d, m = cfg.hidden_size, cfg.intermediate_size

    def block():
        return {
            "q_proj": lin(d, d),
            "k_proj": lin(d, d),
            "v_proj": lin(d, d),
            "out_proj": lin(d, d),
            "layer_norm1": lnp(),
            "fc1": lin(d, m),
            "fc2": lin(m, d),
            "layer_norm2": lnp(),
        }

    return ParamTree({
        "token_embedding": normal(cfg.vocab_size, d),
        "position_embedding": normal(cfg.max_position_embeddings, d),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "final_layer_norm": lnp(),
    })


def quantize_clip_params(params: ParamTree, tier: str) -> ParamTree:
    """Weight-only tier over the block linears, in place (reference
    clip_quantization_dtype, util.py:65 + conditioner.py:56-70)."""
    quantize_blocks_weight_only(params["blocks"], tier)
    return params


def load_clip_checkpoint(sd_get, cfg: CLIPConfig, dtype=torch.bfloat16, report=None,
                         device=None) -> ParamTree:
    """HF CLIPTextModel state dict → the encoder's tree, each tensor moved to
    ``device`` as it is read. With a ``report`` (utils.checkpoint.LoadReport) missing
    tensors zero-fill (norm weights with ones) and are recorded instead of raising.
    ``device`` defaults to cuda:0 (``into_device``)."""
    from ..utils.checkpoint import LoadReport

    device = into_device(device)

    def fetch(name, shape, fill=0.0):
        return LoadReport.fetch(sd_get, name, shape, fill, report).to(device, dtype)

    def lin(name, out_f, in_f):
        return Linear("float", weight=fetch(f"{name}.weight", (out_f, in_f)),
                      bias=fetch(f"{name}.bias", (out_f,)))

    def lnp(name):
        return {"weight": fetch(f"{name}.weight", (cfg.hidden_size,), fill=1.0),
                "bias": fetch(f"{name}.bias", (cfg.hidden_size,))}

    h, inter = cfg.hidden_size, cfg.intermediate_size
    blocks = []
    for i in range(cfg.num_layers):
        p = f"text_model.encoder.layers.{i}."
        blocks.append({
            "q_proj": lin(p + "self_attn.q_proj", h, h),
            "k_proj": lin(p + "self_attn.k_proj", h, h),
            "v_proj": lin(p + "self_attn.v_proj", h, h),
            "out_proj": lin(p + "self_attn.out_proj", h, h),
            "layer_norm1": lnp(p + "layer_norm1"),
            "fc1": lin(p + "mlp.fc1", inter, h),
            "fc2": lin(p + "mlp.fc2", h, inter),
            "layer_norm2": lnp(p + "layer_norm2"),
        })
    return ParamTree({
        "token_embedding": fetch("text_model.embeddings.token_embedding.weight", (cfg.vocab_size, h)),
        "position_embedding": fetch("text_model.embeddings.position_embedding.weight",
                                    (cfg.max_position_embeddings, h)),
        "blocks": blocks,
        "final_layer_norm": lnp("text_model.final_layer_norm"),
    })
