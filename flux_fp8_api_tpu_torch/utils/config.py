"""Configuration schema (JAX counterpart: ``flux_fp8_api_tpu.utils.config``).

The same JSON schema as the JAX package, so every file in ``configs/`` loads unchanged.
Device strings resolve to ``torch.device``: ``tpu:N``, ``gpu:N`` and ``cuda:N`` all mean
CUDA device N, and asking for one on a machine without CUDA raises instead of quietly
running on the host.
"""

from __future__ import annotations

import json
from enum import Enum
from pathlib import Path
from typing import Any, List, Optional

import torch
from pydantic import BaseModel, ConfigDict


class StrEnum(str, Enum):
    def __str__(self) -> str:  # pragma: no cover
        return str(self.value)


class ModelVersion(StrEnum):
    flux_dev = "flux-dev"
    flux_schnell = "flux-schnell"


class QuantizationDtype(StrEnum):
    """Quantization tiers (reference ``util.py:29-35``)."""

    qfloat8 = "qfloat8"
    qint2 = "qint2"
    qint4 = "qint4"
    qint8 = "qint8"
    bfloat16 = "bfloat16"
    float16 = "float16"


class FluxParams(BaseModel):
    """Flow-transformer hyperparameters (reference ``modules/flux_model.py:24-36``)."""

    in_channels: int
    vec_in_dim: int
    context_in_dim: int
    hidden_size: int
    mlp_ratio: float
    num_heads: int
    depth: int
    depth_single_blocks: int
    axes_dim: List[int]
    theta: int
    qkv_bias: bool
    guidance_embed: bool


class AutoEncoderParams(BaseModel):
    """VAE hyperparameters (reference ``modules/autoencoder.py:7-16``)."""

    resolution: int
    in_channels: int
    ch: int
    out_ch: int
    ch_mult: List[int]
    num_res_blocks: int
    z_channels: int
    scale_factor: float
    shift_factor: float


class ModelSpec(BaseModel):
    """Pipeline configuration, field-compatible with the JAX package's ModelSpec.

    ``mesh`` (e.g. ``{"dp": 1, "tp": 4}``) serves over a mesh of ranks
    (``parallel/mesh.py``); ``FluxPipeline`` validates its axes. A ``pp`` axis pipelines
    the block stacks in ``pp_microbatches`` microbatches (``parallel/pp.py``).
    """

    version: ModelVersion
    params: FluxParams
    ae_params: AutoEncoderParams
    ckpt_path: Optional[str] = None
    clip_path: Optional[str] = "openai/clip-vit-large-patch14"
    ae_path: Optional[str] = None
    repo_id: Optional[str] = None
    repo_flow: Optional[str] = None
    repo_ae: Optional[str] = None
    text_enc_max_length: int = 512
    text_enc_path: Optional[str] = None
    text_enc_device: Optional[str] = "cuda:0"
    ae_device: Optional[str] = "cuda:0"
    flux_device: Optional[str] = "cuda:0"
    flow_dtype: str = "bfloat16"
    ae_dtype: str = "bfloat16"
    text_enc_dtype: str = "bfloat16"
    # deprecated reference fields, kept so reference JSON files parse (util.py:57-62)
    num_to_quant: Optional[int] = 20
    quantize_extras: bool = False
    compile_extras: bool = False
    compile_blocks: bool = False
    flow_quantization_dtype: Optional[QuantizationDtype] = QuantizationDtype.qfloat8
    text_enc_quantization_dtype: Optional[QuantizationDtype] = QuantizationDtype.qfloat8
    ae_quantization_dtype: Optional[QuantizationDtype] = None
    clip_quantization_dtype: Optional[QuantizationDtype] = None
    offload_text_encoder: bool = False
    offload_vae: bool = False
    offload_flow: bool = False
    # with offload_flow: stream the flow's blocks host → card one block ahead of their
    # compute under the denoise loop (offload.py) instead of moving the whole tree to
    # the card and back each request; calibration always moves the whole tree
    stream_flow_offload: bool = True
    # GiB of streamed blocks kept on the card between denoise steps (the leading blocks
    # that fit); None keeps every block, 0 streams every block at every step
    offload_retain_gb: Optional[float] = None
    # with offload_text_encoder: stream T5's blocks per layer at encode time
    # (models/t5.py t5_encode_streamed) instead of moving the whole tower; CLIP always
    # moves whole
    stream_text_encoder: bool = True
    prequantized_flow: bool = False
    quantize_modulation: bool = True
    quantize_flow_embedder_layers: bool = False
    clip_tokenizer_path: Optional[str] = None
    t5_tokenizer_path: Optional[str] = None
    # calibration forward passes before the fp8 input scales freeze
    # (reference num_scale_trials=12, float8_quantize.py:42,220-246)
    num_scale_trials: int = 12
    mesh: Optional[dict] = None
    # GPipe microbatches of pipeline-parallel serving (JAX parallel/pp.py); kept so
    # the JAX configs load, pp itself is not ported
    pp_microbatches: int = 1
    # serving buckets warmed by compile(): [[width, height], ...] at warmup_steps
    warmup_resolutions: Optional[List[List[int]]] = None
    warmup_steps: Optional[int] = None
    # the reference's use_fast_accum flag of its torch._scaled_mm call
    # (float8_quantize.py:284-292)
    fp8_fast_accum: bool = True
    # the attention path on the card: True runs the rope pass and then the max-free
    # attention kernel (K1); False runs the rope pass and then
    # F.scaled_dot_product_attention, the counterpart of the JAX package's XLA
    # attention. The pipeline also turns it off, at load, for weights whose
    # max_logit_bound exceeds MAX_SAFE_LOGIT.
    use_pallas: bool = True
    # LRU size of the prompt→(CLIP vec, T5 txt) conditioning cache; 0 disables
    cond_cache_size: int = 8

    model_config: ConfigDict = {
        "arbitrary_types_allowed": True,
        "use_enum_values": True,
        "extra": "ignore",
    }


_DTYPES = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def into_dtype(dtype: Any) -> torch.dtype:
    """Resolve a config dtype string to a torch dtype (reference ``util.py:98-108``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) in _DTYPES:
        return _DTYPES[str(dtype)]
    raise ValueError(f"Invalid dtype: {dtype}")


def into_device(device: Any) -> torch.device:
    """Resolve a config device string to a ``torch.device``.

    ``tpu:N``, ``gpu:N`` and ``cuda:N`` select CUDA device N (so the TPU configs load
    unchanged); ``cpu`` selects the host. Raises when CUDA is asked for and not
    available: the JAX package maps that case to the host, the port does not.
    """
    if isinstance(device, torch.device):
        return device
    name = str(device or "cuda:0").lower()
    platform, _, index = name.partition(":")
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("tpu", "gpu", "cuda"):
        raise ValueError(f"Invalid device: {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, and torch.cuda.is_available() is False"
        )
    return torch.device("cuda", int(index) if index else 0)


def load_config_from_path(path: str) -> ModelSpec:
    """JSON file → ModelSpec (reference ``util.py:216-222``)."""
    p = Path(path)
    if not p.exists():
        raise ValueError(f"Path {path} does not exist")
    if not p.is_file():
        raise ValueError(f"Path {path} is not a file")
    return ModelSpec(**json.loads(p.read_text()))


def _default_flux_params(version: ModelVersion) -> FluxParams:
    return FluxParams(
        in_channels=64,
        vec_in_dim=768,
        context_in_dim=4096,
        hidden_size=3072,
        mlp_ratio=4.0,
        num_heads=24,
        depth=19,
        depth_single_blocks=38,
        axes_dim=[16, 56, 56],
        theta=10_000,
        qkv_bias=True,
        guidance_embed=version == ModelVersion.flux_dev,
    )


def _default_ae_params() -> AutoEncoderParams:
    return AutoEncoderParams(
        resolution=256,
        in_channels=3,
        ch=128,
        out_ch=3,
        ch_mult=[1, 2, 4, 4],
        num_res_blocks=2,
        z_channels=16,
        scale_factor=0.3611,
        shift_factor=0.1159,
    )


def load_config(
    name: ModelVersion = ModelVersion.flux_dev,
    flux_path: Optional[str] = None,
    ae_path: Optional[str] = None,
    text_enc_path: Optional[str] = None,
    text_enc_device: Optional[str] = None,
    ae_device: Optional[str] = None,
    flux_device: Optional[str] = None,
    flow_dtype: str = "bfloat16",
    ae_dtype: str = "bfloat16",
    text_enc_dtype: str = "bfloat16",
    num_to_quant: Optional[int] = 20,
    compile_extras: bool = False,
    compile_blocks: bool = False,
    offload_text_enc: bool = False,
    offload_ae: bool = False,
    offload_flow: bool = False,
    quant_text_enc: Optional[str] = None,
    quant_ae: bool = False,
    prequantized_flow: bool = False,
    quantize_modulation: bool = True,
    quantize_flow_embedder_layers: bool = False,
    **extra,
) -> ModelSpec:
    """Build a ModelSpec from CLI-style arguments (reference ``util.py:122-213``)."""
    name = ModelVersion(name)
    dev = name == ModelVersion.flux_dev
    return ModelSpec(
        version=name,
        repo_id="black-forest-labs/FLUX.1-dev" if dev else "black-forest-labs/FLUX.1-schnell",
        repo_flow="flux1-dev.sft" if dev else "flux1-schnell.sft",
        repo_ae="ae.sft",
        ckpt_path=flux_path,
        params=_default_flux_params(name),
        ae_path=ae_path,
        ae_params=_default_ae_params(),
        text_enc_path=text_enc_path,
        text_enc_device=text_enc_device or "cuda:0",
        ae_device=ae_device or "cuda:0",
        flux_device=flux_device or "cuda:0",
        flow_dtype=flow_dtype,
        ae_dtype=ae_dtype,
        text_enc_dtype=text_enc_dtype,
        text_enc_max_length=512 if dev else 256,
        num_to_quant=num_to_quant,
        compile_extras=compile_extras,
        compile_blocks=compile_blocks,
        offload_flow=offload_flow,
        offload_text_encoder=offload_text_enc,
        offload_vae=offload_ae,
        text_enc_quantization_dtype={
            "float8": QuantizationDtype.qfloat8,
            "qfloat8": QuantizationDtype.qfloat8,
            "qint2": QuantizationDtype.qint2,
            "qint4": QuantizationDtype.qint4,
            "qint8": QuantizationDtype.qint8,
        }.get(quant_text_enc, None),
        ae_quantization_dtype=QuantizationDtype.qfloat8 if quant_ae else None,
        prequantized_flow=prequantized_flow,
        quantize_modulation=quantize_modulation,
        quantize_flow_embedder_layers=quantize_flow_embedder_layers,
        **extra,
    )
