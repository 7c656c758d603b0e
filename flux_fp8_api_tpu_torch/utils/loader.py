"""Model-bundle construction from a ModelSpec: checkpoints when the config names them,
random-init otherwise (JAX counterpart: ``flux_fp8_api_tpu.utils.loader``; reference
util.py:82-95,225-333).

Every model is built on its device leaf by leaf, each flow Linear quantized to the
config's tier as soon as it is read or drawn, so the float flow is never held whole
(24 GB in bf16 at flux-dev size). Without a checkpoint the flow is drawn at full
width from a fixed seed and the CLIP and T5 towers have 2 layers at the config's
widths with a hub-free word-level tokenizer.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..models.autoencoder import init_autoencoder_params, quantize_ae_params
from ..models.clip import CLIPConfig, init_clip_params
from ..models.conditioner import TextEncoder, apply_quantization
from ..models.flux import FluxStatic, init_flux_params, max_logit_bound, quant_tier
from ..models.t5 import T5Config, init_t5_params
from .checkpoint import (
    PREQUANT_FORMAT,
    is_prequantized_reference_file,
    load_ae_checkpoint,
    load_flux_checkpoint,
    load_prequantized,
    reference_prequant_has_input_scales,
)
from .config import ModelSpec, into_device, into_dtype
from .safetensors_io import SafetensorsFile
from .tree import ParamTree

logger = logging.getLogger(__name__)

FLOW_SEED, AE_SEED, CLIP_SEED, T5_SEED = 0, 1, 2, 3

FLOW_QUANT_KINDS = {
    "qfloat8": "fp8",
    "qint8": "int8",
    # the reference's gigaquant flow tier (config-dev-gigaquant.json: qint4 via quanto)
    # → packed int4 weights run through the int8 product
    "qint4": "int4",
}


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
    """The flow's Linear kind for the config's tier; None for the float tiers."""
    tier = config.flow_quantization_dtype
    if tier is None:
        return None
    name = str(getattr(tier, "value", tier))
    if name in ("bfloat16", "bf16", "float16", "fp16"):
        return None
    kind = FLOW_QUANT_KINDS.get(name)
    if kind is None:
        # skipping quantization would place a 24 GB bf16 flow on the card, or measure
        # full precision while claiming a quantized tier
        raise ValueError(
            f"flow_quantization_dtype={name!r} is not a supported flow tier "
            f"(supported: {sorted(FLOW_QUANT_KINDS)}, or bf16/fp16 for none)"
        )
    return kind


def load_flow_model(config: ModelSpec):
    """→ (model, FluxStatic, prequantized). Reads ``ckpt_path`` when set (a
    ``flux-fp8-api-tpu/prequant-v1`` file, a reference-prequantized file or a float BFL
    file), else draws the model from a seed (reference util.py:240-256 plus the
    quantize-on-load step, float8_quantize.py:395-496). ``prequantized`` is True when
    the file carries tuned input scales, so calibration can be skipped."""
    cfg = FluxStatic.from_params(
        config.params, compute_dtype=config.flow_dtype, fp8_fast_accum=config.fp8_fast_accum,
        use_pallas=config.use_pallas,
    )
    kind = flow_quant_kind(config)
    leaf_fn = None
    if kind is not None:
        leaf_fn = quant_tier(kind, config.quantize_modulation, config.quantize_flow_embedder_layers)
    device = into_device(config.flux_device)
    if not config.ckpt_path:
        model = init_flux_params(cfg, _generator(device, FLOW_SEED), torch.bfloat16, leaf_fn)
        return model, cfg, False

    f = SafetensorsFile(config.ckpt_path)
    if f.metadata.get("format") == PREQUANT_FORMAT:
        model, prequant = load_prequantized(f, cfg, device), True
    elif is_prequantized_reference_file(f):
        # fp8 leaves as the file has them; without tuned input scales the reference
        # re-runs the amax trials (float8_quantize.py:139-185), so calibration runs
        model = load_flux_checkpoint(f, cfg, device=device)
        prequant = reference_prequant_has_input_scales(f)
    else:
        if config.prequantized_flow and kind is not None:
            logger.warning("prequantized_flow=true but %s is a plain float checkpoint: "
                           "quantizing at load instead", config.ckpt_path)
        model, prequant = load_flux_checkpoint(f, cfg, leaf_fn=leaf_fn, device=device), False
    # the attention kernel's max-free softmax needs this bound under MAX_SAFE_LOGIT
    # (FluxPipeline refuses a model above it): a checkpoint is the first model whose
    # qk-norm scales are not known in advance
    logger.info("%s: attention |logit| bound %.2f", config.ckpt_path, max_logit_bound(model, cfg))
    return model, cfg, prequant


def flux_from_pretrained(config_path: str, **overrides):
    """Standalone flow load from a config file, without the pipeline (the reference's
    ``Flux.from_pretrained``, flux_model.py:718-734) → ``(model, FluxStatic,
    prequantized)``. ``overrides`` patch ModelSpec fields (e.g. ``ckpt_path=...``);
    an unknown field raises ValueError rather than loading random weights."""
    from .config import load_config_from_path

    config = load_config_from_path(config_path)
    if overrides:
        unknown = set(overrides) - set(ModelSpec.model_fields)
        if unknown:
            raise ValueError(f"unknown ModelSpec override(s): {sorted(unknown)}")
        config = ModelSpec.model_validate({**config.model_dump(), **overrides})
    return load_flow_model(config)


def load_autoencoder(config: ModelSpec) -> ParamTree:
    """The VAE from ``ae_path`` or a seed, with the ``ae_quantization_dtype`` tier:
    weight-only fp8 on the conv weights (a deliberate deviation: the reference's flag
    finds no nn.Linear in the conv-only AE and does nothing, util.py:288-291). fp8 is
    the only conv tier; any other requested value maps onto it with a warning, as in
    the JAX package."""
    device = into_device(config.ae_device)
    dtype = into_dtype(config.ae_dtype)
    if config.ae_path:
        params = load_ae_checkpoint(config.ae_path, config.ae_params, dtype, device=device)
    else:
        params = init_autoencoder_params(config.ae_params, _generator(device, AE_SEED), dtype)
    if config.ae_quantization_dtype is not None:
        tier = str(getattr(config.ae_quantization_dtype, "value", config.ae_quantization_dtype))
        if tier != "qfloat8":
            logger.warning("ae_quantization_dtype=%s: only qfloat8 is implemented for the conv "
                           "AE; applying weight-only fp8 instead", tier)
        params = quantize_ae_params(params)
    return params


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


def _looks_like_hub_id(path) -> bool:
    """True for an HF hub id ("org/name") that is not a local path. The shipped
    configs name hub repos (openai/clip-vit-large-patch14); with no hub access those
    fall back to the random tower with a warning."""
    p = str(path)
    return not Path(p).exists() and re.fullmatch(r"[\w.\-]+/[\w.\-]+", p) is not None


def load_text_encoders(config: ModelSpec):
    """→ (clip, t5) TextEncoders (reference util.py:259-275): a local HF directory
    loads through ``TextEncoder.from_pretrained``; a hub id or no path gives the
    random tower."""
    device = into_device(config.text_enc_device)
    dtype = config.text_enc_dtype
    if config.clip_path and not _looks_like_hub_id(config.clip_path):
        clip = TextEncoder.from_pretrained(
            "clip", config.clip_path, max_length=77, dtype=dtype,
            quantization_dtype=config.clip_quantization_dtype,
            tokenizer_path=config.clip_tokenizer_path, device=device,
        )
    else:
        if config.clip_path:
            logger.warning("clip_path=%r is a hub id, not a local path: using a RANDOM-weight "
                           "toy CLIP — images will not follow prompts", config.clip_path)
        clip = _random_clip(config, device)
    if config.text_enc_path and not _looks_like_hub_id(config.text_enc_path):
        t5 = TextEncoder.from_pretrained(
            "t5", config.text_enc_path, max_length=config.text_enc_max_length, dtype=dtype,
            quantization_dtype=config.text_enc_quantization_dtype,
            tokenizer_path=config.t5_tokenizer_path, device=device,
        )
    else:
        if config.text_enc_path:
            logger.warning("text_enc_path=%r is a hub id, not a local path: using a RANDOM-weight "
                           "toy T5 — images will not follow prompts", config.text_enc_path)
        t5 = _random_t5(config, device)
    return clip, t5


def load_models_from_config(config: ModelSpec) -> LoadedModels:
    """reference util.py:325-333."""
    clip, t5 = load_text_encoders(config)
    flow, flow_cfg, prequant = load_flow_model(config)
    # with a checkpoint the loader's detection is final: a reference-prequantized file
    # without input scales must calibrate even when the config claims
    # prequantized_flow (JAX loader.py:336-342); without one, the config flag holds
    return LoadedModels(
        flow=flow,
        flow_cfg=flow_cfg,
        flow_prequantized=prequant if config.ckpt_path else config.prequantized_flow,
        ae=load_autoencoder(config),
        clip=clip,
        t5=t5,
        config=config,
    )
