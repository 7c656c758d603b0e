"""Model-bundle construction from a ModelSpec, random-init paths
(JAX counterpart: ``flux_fp8_api_tpu.utils.loader``; reference util.py:82-95,225-333).

No checkpoint loader is ported yet: a config that names a flow, VAE or text-encoder
checkpoint raises. Without one, every model is drawn from a fixed seed on its device:
the flow at full width, built and quantized leaf by leaf; 2-layer CLIP and T5 towers
at the config's widths with a hub-free word-level tokenizer.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Optional

import numpy as np
import torch

from ..models.autoencoder import init_autoencoder_params
from ..models.clip import CLIPConfig, init_clip_params
from ..models.conditioner import TextEncoder, apply_quantization
from ..models.flux import FluxStatic, fp8_tier, init_flux_params
from ..models.t5 import T5Config, init_t5_params
from .config import ModelSpec, into_device, into_dtype
from .tree import ParamTree

FLOW_SEED, AE_SEED, CLIP_SEED, T5_SEED = 0, 1, 2, 3


@dataclasses.dataclass
class LoadedModels:
    """reference LoadedModels (util.py:298-308)."""

    flow: ParamTree
    flow_cfg: FluxStatic
    flow_prequantized: bool
    ae: ParamTree
    clip: TextEncoder
    t5: TextEncoder
    config: ModelSpec


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def flow_quant_kind(config: ModelSpec) -> Optional[str]:
    tier = config.flow_quantization_dtype
    if tier is None:
        return None
    name = str(getattr(tier, "value", tier))
    if name in ("bfloat16", "bf16", "float16", "fp16"):
        return None
    if name != "qfloat8":
        raise NotImplementedError(
            f"flow_quantization_dtype={name!r} is not ported yet (ROADMAP: other quant kinds)"
        )
    return "fp8"


def load_flow_model(config: ModelSpec):
    """→ (model, FluxStatic, prequantized=False). The model is drawn on the flux device
    leaf by leaf, each Linear quantized to the config's tier as soon as it exists, so
    the float model is never held whole (24 GB in bf16 at flux-dev size)."""
    if config.ckpt_path:
        raise NotImplementedError("flow checkpoints are not loadable yet (ROADMAP: checkpoint loaders)")
    cfg = FluxStatic.from_params(
        config.params, compute_dtype=config.flow_dtype, fp8_fast_accum=config.fp8_fast_accum
    )
    leaf_fn = None
    if flow_quant_kind(config) == "fp8":
        leaf_fn = fp8_tier(config.quantize_modulation, config.quantize_flow_embedder_layers)
    device = into_device(config.flux_device)
    model = init_flux_params(cfg, _generator(device, FLOW_SEED), torch.bfloat16, leaf_fn)
    return model, cfg, False


def load_autoencoder(config: ModelSpec) -> ParamTree:
    if config.ae_path:
        raise NotImplementedError("VAE checkpoints are not loadable yet (ROADMAP: checkpoint loaders)")
    if config.ae_quantization_dtype is not None:
        raise NotImplementedError("VAE quantization is not ported yet (ROADMAP: other quant kinds)")
    device = into_device(config.ae_device)
    return init_autoencoder_params(
        config.ae_params, _generator(device, AE_SEED), into_dtype(config.ae_dtype)
    )


class ToyTokenizer:
    """Hub-free word-level tokenizer for random-init runs, on the ``tokenizers``
    backend alone. It gives the same ids and decodes as the JAX package's
    ``_toy_tokenizer`` (an HF ``PreTrainedTokenizerFast`` over the same backend) for
    the calls the pipeline makes."""

    def __init__(self, style: str):
        from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers
        from tokenizers.processors import TemplateProcessing

        vocab = {"<pad>": 0, "<bos>": 1, "<eos>": 2, "<unk>": 3}
        for i in range(4, 256):
            vocab[f"tok{i}"] = i
        for w in "a an the of on in photo image test beautiful cat dog house hill sun sky red blue".split():
            vocab.setdefault(w, len(vocab))
        tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Whitespace()
        if style == "clip":
            tok.post_processor = TemplateProcessing(
                single="<bos> $A <eos>", special_tokens=[("<bos>", 1), ("<eos>", 2)]
            )
            special = ["<bos>", "<eos>", "<unk>"]
            self.bos_token_id, self.pad_token = 1, "<eos>"
        else:
            tok.post_processor = TemplateProcessing(single="$A <eos>", special_tokens=[("<eos>", 2)])
            special = ["<eos>", "<unk>", "<pad>"]
            self.bos_token_id, self.pad_token = None, "<pad>"
        tok.add_special_tokens([AddedToken(t, special=True) for t in special])
        self.eos_token_id = 2
        self.pad_token_id = vocab[self.pad_token]
        self._tok = tok

    def __call__(self, text, truncation=False, max_length=None, padding=False,
                 add_special_tokens=True, return_tensors=None):
        tok = self._tok
        if truncation and max_length:
            tok.enable_truncation(max_length)
        else:
            tok.no_truncation()
        if padding == "max_length":
            tok.enable_padding(length=max_length, pad_id=self.pad_token_id, pad_token=self.pad_token)
        else:
            tok.no_padding()
        texts = [text] if isinstance(text, str) else list(text)
        ids = [e.ids for e in tok.encode_batch(texts, add_special_tokens=add_special_tokens)]
        if return_tensors == "np":
            return SimpleNamespace(input_ids=np.asarray(ids, dtype=np.int64))
        return SimpleNamespace(input_ids=ids[0] if isinstance(text, str) else ids)

    def decode(self, ids, skip_special_tokens=False, clean_up_tokenization_spaces=True) -> str:
        out = self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)
        if clean_up_tokenization_spaces:
            # transformers' clean_up_tokenization
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re")):
                out = out.replace(a, b)
        return out


def _toy_tokenizer(style: str) -> ToyTokenizer:
    return ToyTokenizer(style)


def _random_clip(config: ModelSpec, device: torch.device) -> TextEncoder:
    cfg = CLIPConfig(
        vocab_size=512,
        hidden_size=config.params.vec_in_dim,
        intermediate_size=4 * config.params.vec_in_dim,
        num_layers=2,
        num_heads=8,
        eos_token_id=2,
    )
    params = apply_quantization(
        "clip", init_clip_params(cfg, _generator(device, CLIP_SEED), torch.bfloat16),
        config.clip_quantization_dtype,
    )
    return TextEncoder("clip", params, cfg, _toy_tokenizer("clip"), max_length=77,
                       dtype=into_dtype(config.text_enc_dtype), device=device)


def _random_t5(config: ModelSpec, device: torch.device) -> TextEncoder:
    cfg = T5Config(
        vocab_size=512,
        d_model=config.params.context_in_dim,
        d_ff=2 * config.params.context_in_dim,
        num_layers=2,
        num_heads=8,
        d_kv=config.params.context_in_dim // 8,
    )
    params = apply_quantization(
        "t5", init_t5_params(cfg, _generator(device, T5_SEED), torch.bfloat16),
        config.text_enc_quantization_dtype,
    )
    return TextEncoder("t5", params, cfg, _toy_tokenizer("t5"),
                       max_length=config.text_enc_max_length,
                       dtype=into_dtype(config.text_enc_dtype), device=device)


def _is_local_path(path: Any) -> bool:
    from pathlib import Path

    return path is not None and Path(str(path)).exists()


def load_text_encoders(config: ModelSpec):
    """→ (clip, t5) random-init TextEncoders (reference util.py:259-275). A hub id
    (the shipped configs name ``openai/clip-vit-large-patch14``) falls back to the
    random tower as in the JAX package; a local checkpoint directory raises."""
    if _is_local_path(config.clip_path) or _is_local_path(config.text_enc_path):
        raise NotImplementedError(
            "text-encoder checkpoints are not loadable yet (ROADMAP: checkpoint loaders)"
        )
    device = into_device(config.text_enc_device)
    return _random_clip(config, device), _random_t5(config, device)


def load_models_from_config(config: ModelSpec) -> LoadedModels:
    """reference util.py:325-333."""
    clip, t5 = load_text_encoders(config)
    flow, flow_cfg, prequant = load_flow_model(config)
    return LoadedModels(
        flow=flow,
        flow_cfg=flow_cfg,
        flow_prequantized=prequant or config.prequantized_flow,
        ae=load_autoencoder(config),
        clip=clip,
        t5=t5,
        config=config,
    )
