"""Text-encoder wrapper: tokenizer + encoder + weight-only tier
(JAX counterpart: ``flux_fp8_api_tpu.models.conditioner``; reference ``HFEmbedder``,
modules/conditioner.py:38-117). Resident on one device, or offloaded to the host
(T5 optionally streamed per layer, only without a mesh). Under tp the pipeline shards
the params in place (``parallel/mesh.py:shard_encoder_params``), an offloaded encoder's
host tree, so that each move to the card carries the rank's slice.

Checkpoints load from local HF-style directories (``config.json`` + safetensors,
optionally sharded through ``model.safetensors.index.json``); ``from_pretrained``
takes paths, never hub ids.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..utils.config import into_device, into_dtype
from ..utils.safetensors_io import SafetensorsFile
from ..utils.tree import ParamTree, tree_to
from .clip import CLIPConfig, clip_encode, load_clip_checkpoint, quantize_clip_params
from .t5 import T5Config, load_t5_checkpoint, quantize_t5_params, t5_encode, t5_encode_streamed


def _hf_state_dict_getter(model_dir: Path) -> Callable[[str], torch.Tensor]:
    """``sd_get(name)`` over a (possibly sharded) HF safetensors directory; raises
    KeyError for an absent name. ``sd_get.all_keys`` holds every tensor name, for the
    unexpected-key report."""
    index = model_dir / "model.safetensors.index.json"
    if index.exists():
        weight_map: Dict[str, str] = json.loads(index.read_text())["weight_map"]
        files: Dict[str, SafetensorsFile] = {}

        def get(name: str) -> torch.Tensor:
            fname = weight_map.get(name)
            if fname is None:
                raise KeyError(name)
            if fname not in files:
                files[fname] = SafetensorsFile(model_dir / fname)
            return files[fname].get(name)

        get.all_keys = set(weight_map)
        return get
    candidates = sorted(model_dir.glob("*.safetensors"))
    if not candidates:
        raise FileNotFoundError(f"no safetensors files in {model_dir}")
    shards = [SafetensorsFile(c) for c in candidates]

    def get(name: str) -> torch.Tensor:
        for s in shards:
            if name in s:
                return s.get(name)
        raise KeyError(name)

    get.all_keys = set().union(*(set(s.keys()) for s in shards))
    return get


class TextEncoder:
    """One text encoder (CLIP or T5) with its tokenizer. kind="clip" returns the pooled
    vector (reference output_key "pooler_output"); kind="t5" the last_hidden_state.

    ``offload`` keeps the weights on the host (page-locked when ``device`` is a card)
    between encodes: :meth:`to_device` puts a copy on the card and :meth:`to_host`
    drops it (JAX conditioner.py:72-179). ``stream`` (T5 only, and only offloaded)
    leaves the weights on the host and streams T5's blocks per layer inside each
    encode (``t5_encode_streamed``); its moves are no-ops."""

    def __init__(
        self,
        kind: str,
        params: ParamTree,
        config,
        tokenizer,
        max_length: int,
        dtype=torch.bfloat16,
        device: Optional[torch.device] = None,
        offload: bool = False,
        stream: bool = False,
    ):
        if kind not in ("clip", "t5"):
            raise ValueError(f"unknown text encoder kind {kind!r}")
        self.kind = kind
        self.config = config
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.dtype = dtype
        self.device = into_device(device)  # None → cuda:0; "cpu" for the host
        self.offload = offload
        self.stream = bool(stream and offload and kind == "t5")
        if offload:
            self.host_params = tree_to(params, "cpu", pin=self.device.type == "cuda")
            self.params = self.host_params
        else:
            self.params = params.to(self.device)

    def to_device(self):
        """Host → card (reference HFEmbedder.cuda(), conditioner.py:98-100): a device
        copy beside the host tree. A resident or streaming encoder does nothing."""
        if self.offload and not self.stream:
            self.params = tree_to(self.host_params, self.device, non_blocking=True)

    def to_host(self):
        """Back to the host tree (reference HFEmbedder.offload(), conditioner.py:95-97):
        the device copy is dropped; the weights never change, so nothing is copied
        back. A resident or streaming encoder does nothing."""
        if self.offload and not self.stream:
            self.params = self.host_params

    def encode_ids(self, input_ids) -> torch.Tensor:
        """(B, L) ids → pooled (clip) or last_hidden_state (t5), on the encoder's device."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            if self.kind == "clip":
                return clip_encode(self.params, self.config, ids, self.dtype)[1]
            if self.stream:
                return t5_encode_streamed(self.params, self.config, ids, self.device, self.dtype)
            return t5_encode(self.params, self.config, ids, self.dtype)

    def __call__(self, texts: List[str]) -> torch.Tensor:
        """Tokenize (pad to max_length, no attention mask — reference
        conditioner.py:102-117) and encode."""
        batch = self.tokenizer(
            texts, truncation=True, max_length=self.max_length,
            padding="max_length", return_tensors="np",
        )
        return self.encode_ids(batch.input_ids)

    @classmethod
    def from_pretrained(
        cls,
        kind: str,
        model_path: str,
        max_length: int,
        dtype="bfloat16",
        quantization_dtype=None,
        tokenizer_path: Optional[str] = None,
        device: Optional[torch.device] = None,
        offload: bool = False,
        stream: bool = False,
    ) -> "TextEncoder":
        """Load a local HF directory: its ``config.json``, its safetensors (each tensor
        moved to ``device`` as it is read, then the tier applied there) and its
        tokenizer through ``transformers.AutoTokenizer``. The load is tolerant like
        the reference's strict=False one (util.py:225-237): missing tensors fill and
        extra keys are ignored, each with a warning naming them. ``device`` defaults
        to cuda:0 (``into_device``); pass ``"cpu"`` for the host. ``offload`` and
        ``stream`` as in the constructor."""
        from transformers import AutoTokenizer

        from ..utils.checkpoint import LoadReport

        device = into_device(device)
        model_dir = Path(model_path)
        hf_cfg = json.loads((model_dir / "config.json").read_text())
        # CLIP ships CLIPTextConfig top-level or under "text_config"
        if "text_config" in hf_cfg:
            hf_cfg = {**hf_cfg, **hf_cfg["text_config"]}
        sd_get = _hf_state_dict_getter(model_dir)
        tdtype = into_dtype(dtype)
        report = LoadReport(f"{kind} checkpoint {model_path}")
        if kind == "clip":
            config = CLIPConfig.from_hf_config(hf_cfg)
            params = load_clip_checkpoint(sd_get, config, tdtype, report=report, device=device)
        else:
            config = T5Config.from_hf_config(hf_cfg)
            params = load_t5_checkpoint(sd_get, config, tdtype, report=report, device=device)
        report.finish(sd_get.all_keys)
        params = apply_quantization(kind, params, quantization_dtype)
        tokenizer = AutoTokenizer.from_pretrained(tokenizer_path or model_path)
        return cls(kind, params, config, tokenizer, max_length=max_length, dtype=tdtype, device=device,
                   offload=offload, stream=stream)


def apply_quantization(kind: str, params: ParamTree, quantization_dtype) -> ParamTree:
    """Map the reference's tier names onto the weight-only quantizers
    (conditioner.py:17-35: qfloat8→quanto fp8, qint8→bnb int8, qint4→bnb nf4,
    qint2→quanto int2), in place."""
    if quantization_dtype is None:
        return params
    tier = str(getattr(quantization_dtype, "value", quantization_dtype))
    if tier in ("bfloat16", "float16"):
        return params
    if kind == "clip":
        return quantize_clip_params(params, tier)
    return quantize_t5_params(params, tier)
