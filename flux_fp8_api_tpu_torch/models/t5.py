"""T5 v1.1 encoder (JAX counterpart: ``flux_fp8_api_tpu.models.t5``).

HF T5 v1.1 semantics: RMS layer norm in fp32 without bias, no embedding or attention
scaling, gated-gelu feed-forward, bidirectional relative position bias computed once
and shared by all blocks, and — as the reference does — no attention mask.

Under tensor parallelism (``parallel/mesh.py:shard_encoder_params``) q/k/v and the
gated up-projections hold this rank's heads and channels, o and the down-projection
all-reduce their partial products, and each rank adds its heads' rows of the position
bias.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..ops.quant import Linear, linear_apply, quantize_blocks_weight_only
from ..parallel.mesh import local_heads
from ..utils.config import into_device
from ..utils.tree import ParamTree


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    d_kv: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "T5Config":
        return cls(
            vocab_size=cfg["vocab_size"],
            d_model=cfg["d_model"],
            d_ff=cfg["d_ff"],
            num_layers=cfg["num_layers"],
            num_heads=cfg["num_heads"],
            d_kv=cfg["d_kv"],
            relative_attention_num_buckets=cfg.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=cfg.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=cfg.get("layer_norm_epsilon", 1e-6),
        )


def _t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (weight.float() * x32 * torch.rsqrt(var + eps)).to(x.dtype)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """HF T5's bidirectional bucket function (modeling_t5._relative_position_bucket)."""
    num_buckets = num_buckets // 2
    ret = (relative_position > 0).to(torch.int64) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int64)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_bias_table: torch.Tensor, seq_len: int, cfg: T5Config) -> torch.Tensor:
    """(1, heads, L, L) fp32 additive attention bias from the learned bucket table."""
    pos = torch.arange(seq_len, device=rel_bias_table.device)
    buckets = relative_position_bucket(
        pos[None, :] - pos[:, None],
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    return rel_bias_table.float()[buckets].permute(2, 0, 1)[None]


def _t5_attention(blk, x, position_bias, cfg: T5Config, dtype):
    b, l, _ = x.shape
    h0, h = local_heads(cfg.num_heads, blk["q"])
    dk = cfg.d_kv
    q, k, v = (linear_apply(blk[n], x, dtype)[0].reshape(b, l, h, dk) for n in ("q", "k", "v"))
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) + position_bias[:, h0:h0 + h]
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, h * dk)
    return linear_apply(blk["o"], out, dtype)[0]


def _t5_block(blk, x, position_bias, cfg: T5Config, dtype):
    h = _t5_layer_norm(x, blk["ln1"], cfg.layer_norm_epsilon)
    x = x + _t5_attention(blk, h, position_bias, cfg, dtype)
    h = _t5_layer_norm(x, blk["ln2"], cfg.layer_norm_epsilon)
    gate = torch.nn.functional.gelu(linear_apply(blk["wi_0"], h, dtype)[0], approximate="tanh")
    return x + linear_apply(blk["wo"], gate * linear_apply(blk["wi_1"], h, dtype)[0], dtype)[0]


def t5_encode(params: ParamTree, cfg: T5Config, input_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, L) token ids → (B, L, d_model) last_hidden_state."""
    x = params["shared"].to(dtype)[input_ids]
    position_bias = compute_position_bias(params["rel_bias"], input_ids.shape[1], cfg)
    for blk in params["blocks"]:
        x = _t5_block(blk, x, position_bias, cfg, dtype)
    return _t5_layer_norm(x, params["final_ln"], cfg.layer_norm_epsilon)


def t5_encode_streamed(params: ParamTree, cfg: T5Config, input_ids: torch.Tensor, device,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`t5_encode` with the host tree's blocks streamed to ``device`` one layer
    ahead of their compute (JAX models/t5.py:144-207): ``shared``, ``rel_bias`` and
    ``final_ln`` are copied first, each block's copy is enqueued on the side stream
    before the block ahead of it runs (``offload.BlockStream``), and nothing is
    retained: an encode reads each block once, so the card holds about two blocks of
    weights plus activations, and nothing comes back. The same ops as
    :func:`t5_encode`, so the same values bit for bit. ``input_ids`` on ``device``."""
    from ..offload import BlockStream

    stream = BlockStream(device)
    tops = {k: params[k].to(device, non_blocking=True) for k in ("shared", "rel_bias", "final_ln")}
    x = tops["shared"].to(dtype)[input_ids]
    position_bias = compute_position_bias(tops["rel_bias"], input_ids.shape[1], cfg)
    blocks = params["blocks"]
    nxt = stream.put(blocks[0]) if len(blocks) else None
    for j in range(len(blocks)):
        (blk, done), nxt = nxt, (stream.put(blocks[j + 1]) if j + 1 < len(blocks) else None)
        stream.ready(done)
        x = _t5_block(blk, x, position_bias, cfg, dtype)
        del blk  # freed once its compute is enqueued: two blocks on the card at most
    return _t5_layer_norm(x, tops["final_ln"], cfg.layer_norm_epsilon)


def init_t5_params(cfg: T5Config, generator: torch.Generator, dtype=torch.float32) -> ParamTree:
    """Random init on ``generator``'s device: N(0, 1)·0.02 matrices, unit norms."""
    device = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device).to(dtype) * 0.02

    def lin(i, o):
        return Linear("float", weight=normal(o, i))

    inner = cfg.num_heads * cfg.d_kv

    def block():
        return {
            "q": lin(cfg.d_model, inner),
            "k": lin(cfg.d_model, inner),
            "v": lin(cfg.d_model, inner),
            "o": lin(inner, cfg.d_model),
            "ln1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "wi_0": lin(cfg.d_model, cfg.d_ff),
            "wi_1": lin(cfg.d_model, cfg.d_ff),
            "wo": lin(cfg.d_ff, cfg.d_model),
            "ln2": torch.ones((cfg.d_model,), dtype=dtype, device=device),
        }

    return ParamTree({
        "shared": normal(cfg.vocab_size, cfg.d_model),
        "rel_bias": normal(cfg.relative_attention_num_buckets, cfg.num_heads),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "final_ln": torch.ones((cfg.d_model,), dtype=dtype, device=device),
    })


def quantize_t5_params(params: ParamTree, tier: str) -> ParamTree:
    """Apply a weight-only tier ('qfloat8'/'qint8'/'qint4'/'qint2') to every block
    linear, in place (the reference quantizes the whole HF module via quanto/bnb,
    conditioner.py:56-70)."""
    quantize_blocks_weight_only(params["blocks"], tier)
    return params


def load_t5_checkpoint(sd_get, cfg: T5Config, dtype=torch.bfloat16, report=None,
                       device=None) -> ParamTree:
    """HF T5EncoderModel state dict → the encoder's tree, each tensor moved to
    ``device`` as it is read. ``sd_get(name)`` returns a tensor or raises KeyError.

    HF key layout: shared.weight, encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}.weight,
    …layer.0.layer_norm.weight, …layer.1.DenseReluDense.{wi_0,wi_1,wo}.weight,
    …layer.1.layer_norm.weight, encoder.final_layer_norm.weight, and block 0's
    relative_attention_bias. With a ``report`` (utils.checkpoint.LoadReport) missing
    tensors zero-fill (norms with ones) and are recorded instead of raising.
    ``device`` defaults to cuda:0 (``into_device``)."""
    from ..utils.checkpoint import LoadReport

    device = into_device(device)

    def fetch(name, shape, fill=0.0):
        return LoadReport.fetch(sd_get, name, shape, fill, report).to(device, dtype)

    def lin(name, out_f, in_f):
        return Linear("float", weight=fetch(name, (out_f, in_f)))

    def ln(name):
        return fetch(name, (cfg.d_model,), fill=1.0)

    d, ff, inner = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.d_kv
    blocks = []
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}."
        blocks.append({
            "q": lin(p + "layer.0.SelfAttention.q.weight", inner, d),
            "k": lin(p + "layer.0.SelfAttention.k.weight", inner, d),
            "v": lin(p + "layer.0.SelfAttention.v.weight", inner, d),
            "o": lin(p + "layer.0.SelfAttention.o.weight", d, inner),
            "ln1": ln(p + "layer.0.layer_norm.weight"),
            "wi_0": lin(p + "layer.1.DenseReluDense.wi_0.weight", ff, d),
            "wi_1": lin(p + "layer.1.DenseReluDense.wi_1.weight", ff, d),
            "wo": lin(p + "layer.1.DenseReluDense.wo.weight", d, ff),
            "ln2": ln(p + "layer.1.layer_norm.weight"),
        })
    return ParamTree({
        "shared": fetch("shared.weight", (cfg.vocab_size, d)),
        "rel_bias": fetch("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                          (cfg.relative_attention_num_buckets, cfg.num_heads)),
        "blocks": blocks,
        "final_ln": ln("encoder.final_layer_norm.weight"),
    })
