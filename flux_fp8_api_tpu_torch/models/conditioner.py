"""Text-encoder wrapper: tokenizer + encoder + weight-only tier
(JAX counterpart: ``flux_fp8_api_tpu.models.conditioner``; reference ``HFEmbedder``,
modules/conditioner.py:38-117). Resident on one device; offload, streaming, sharding
and loading from pretrained directories are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.tree import ParamTree
from .clip import clip_encode
from .t5 import quantize_t5_params, t5_encode


class TextEncoder:
    """One text encoder (CLIP or T5) with its tokenizer. kind="clip" returns the pooled
    vector (reference output_key "pooler_output"); kind="t5" the last_hidden_state."""

    def __init__(
        self,
        kind: str,
        params: ParamTree,
        config,
        tokenizer,
        max_length: int,
        dtype=torch.bfloat16,
        device: Optional[torch.device] = None,
    ):
        if kind not in ("clip", "t5"):
            raise ValueError(f"unknown text encoder kind {kind!r}")
        self.kind = kind
        self.config = config
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.params = params.to(self.device)

    def encode_ids(self, input_ids) -> torch.Tensor:
        """(B, L) ids → pooled (clip) or last_hidden_state (t5), on the encoder's device."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            if self.kind == "clip":
                return clip_encode(self.params, self.config, ids, self.dtype)[1]
            return t5_encode(self.params, self.config, ids, self.dtype)

    def __call__(self, texts: List[str]) -> torch.Tensor:
        """Tokenize (pad to max_length, no attention mask — reference
        conditioner.py:102-117) and encode."""
        batch = self.tokenizer(
            texts, truncation=True, max_length=self.max_length,
            padding="max_length", return_tensors="np",
        )
        return self.encode_ids(batch.input_ids)


def apply_quantization(kind: str, params: ParamTree, quantization_dtype) -> ParamTree:
    """Map the reference's tier names onto the weight-only quantizers
    (conditioner.py:17-35). ``qfloat8`` on T5 is ported; anything else raises."""
    if quantization_dtype is None:
        return params
    tier = str(getattr(quantization_dtype, "value", quantization_dtype))
    if tier in ("bfloat16", "float16"):
        return params
    if kind == "clip":
        raise NotImplementedError(
            f"CLIP tier {tier!r} is not ported yet (ROADMAP: other quant kinds)"
        )
    return quantize_t5_params(params, tier)
