"""FluxPipeline, txt2img (JAX counterpart: ``flux_fp8_api_tpu.pipeline``; reference
``flux_pipeline.py:58-729``).

The same public surface and the same calibration protocol: the first
``num_scale_trials`` denoise steps after load collect per-layer input amaxes, and the
input scales of the fp8, int8 and int4 linears freeze after them. Randomness comes from ``torch.Generator``s, so a
seed gives other noise than the JAX package's threefry keys.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP item): init
images (img2img), LoRA, offload and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import math
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .calibration import apply_input_scales, merge_amax
from .emphasis import get_weighted_text_embeddings
from .image_encoder import ImageEncoder
from .models.autoencoder import ae_decode
from .models.flux import FluxStatic, max_logit_bound
from .ops.attention_kernel import MAX_SAFE_LOGIT
from .ops.packing import make_img_ids, make_txt_ids, pack_latents, unpack_latents
from .ops.quant import ACTIVATION_KINDS, Linear
from .ops.schedule import get_schedule
from .sampling import CacheConfig, denoise, make_denoise_step
from .utils.config import ModelSpec, ModelVersion, into_device, into_dtype, load_config_from_path
from .utils.loader import load_models_from_config
from .utils.tree import ParamTree

MAX_RAND = 2**32 - 1

logger = logging.getLogger(__name__)


def _sync(t: torch.Tensor) -> None:
    """Wait for the device work behind ``t`` (timings end here)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class FluxPipeline:
    """Image-generation pipeline: input prep, schedule, noise, denoise loop,
    calibration, VAE decode and JPEG encode."""

    def __init__(
        self,
        name: str,
        clip=None,
        t5=None,
        model: Optional[ParamTree] = None,
        model_cfg: Optional[FluxStatic] = None,
        ae: Optional[ParamTree] = None,
        config: Optional[ModelSpec] = None,
        prequantized: bool = False,
        verbose: bool = False,
        debug: bool = False,
    ):
        if config is None:
            raise ValueError("ModelSpec config is required!")
        if config.offload_flow or config.offload_vae or config.offload_text_encoder:
            raise NotImplementedError("offload is not ported yet (ROADMAP: offload)")
        if config.mesh:
            raise NotImplementedError("multi-device meshes are not ported yet (ROADMAP: multi-GPU)")
        self.name = name
        self.config = config
        self.debug = debug
        self.verbose = verbose

        self.device_flux = into_device(config.flux_device)
        self.device_ae = into_device(config.ae_device)
        self.dtype = into_dtype(config.flow_dtype)
        self.ae_dtype = into_dtype(config.ae_dtype)
        # Stated numerics: fp32 matmuls and convs are full fp32, never TF32. Process-wide
        # flags; the VAE convs would otherwise run in TF32 on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.clip = clip
        self.t5 = t5
        self.model_cfg = model_cfg
        self.img_encoder = ImageEncoder()

        if model is not None and model_cfg is not None and model_cfg.use_pallas:
            # The max-free kernel is safe only while qk-norm keeps |logit| under
            # MAX_SAFE_LOGIT; the bound is static in the norm scales, so it is decided
            # once per set of weights: above it, this pipeline serves through the rope
            # pass and F.scaled_dot_product_attention (use_pallas=False), as the JAX
            # package serves through XLA attention.
            bound = max_logit_bound(model, model_cfg)
            if bound > MAX_SAFE_LOGIT:
                logger.warning(
                    "qk-norm scales give an attention |logit| bound of %.0f > %.0f: the "
                    "max-free attention kernel could overflow exp — serving these weights "
                    "with use_pallas=False (rope pass + scaled_dot_product_attention)",
                    bound, MAX_SAFE_LOGIT,
                )
                self.model_cfg = dataclasses.replace(model_cfg, use_pallas=False)
        self.model_params = model
        self.ae_params = ae

        self._needs_calibration = (
            not prequantized and self._is_quantized() and config.num_scale_trials > 0
        )
        self._amax_running = None
        self._trials_done = 0

        # prompt → (CLIP vec, T5 txt) LRU of N=1 encoder outputs (cond_cache_size)
        self._cond_cache: "OrderedDict" = OrderedDict()
        self.cond_cache_hits = 0
        self.cond_cache_misses = 0

        # per-phase wall clock of the last generate, and its final packed latents
        self.timings: Dict[str, float] = {}
        self.last_latents: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng()

        if config.compile_blocks or config.compile_extras:
            self.compile()

    # ------------------------------------------------------------------------- state

    def _is_quantized(self) -> bool:
        if self.model_params is None:
            return False
        return any(isinstance(m, Linear) and m.kind in ACTIVATION_KINDS for m in self.model_params.modules())

    # -------------------------------------------------------------------------- seeds

    def set_seed(self, seed: Optional[Union[int, str]] = None) -> Tuple[torch.Generator, int]:
        """Resolve a user seed (int/str/None) → (torch.Generator on the flux device,
        int seed) (reference flux_pipeline.py:126-149)."""
        if isinstance(seed, (int, float)):
            seed = int(abs(seed)) % MAX_RAND
        elif isinstance(seed, str):
            try:
                seed = abs(int(seed)) % MAX_RAND
            except ValueError:
                seed = int(self._rng.integers(0, MAX_RAND))
        else:
            seed = int(self._rng.integers(0, MAX_RAND))
        gen = torch.Generator(device=self.device_flux)
        gen.manual_seed(seed)
        return gen, seed

    # ---------------------------------------------------------------------- noise/prep

    def get_noise(self, num_samples: int, height: int, width: int, generator: torch.Generator) -> torch.Tensor:
        """(B, C, 2·⌈h/16⌉, 2·⌈w/16⌉) gaussian latents (flux_pipeline.py:346-371), with
        C = in_channels / 4."""
        shape = (
            num_samples,
            self.config.params.in_channels // 4,
            2 * math.ceil(height / 16),
            2 * math.ceil(width / 16),
        )
        return torch.randn(shape, generator=generator, device=self.device_flux).to(self.dtype)

    def preprocess_latent(self, init_image, height: int, width: int, num_steps: int,
                          strength: float, generator: torch.Generator, num_images: int):
        """Noise + schedule (reference flux_pipeline.py:459-523, txt2img)."""
        if init_image is not None:
            raise NotImplementedError("init images are not ported yet (ROADMAP: img2img)")
        x = self.get_noise(num_images, height, width, generator)
        timesteps = get_schedule(
            num_steps=num_steps,
            image_seq_len=x.shape[-1] * x.shape[-2] // 4,
            shift=(self.name != ModelVersion.flux_schnell.value),
        )
        return x, timesteps

    def _encode_prompts(self, prompts: List[str]):
        """Encode each distinct prompt at N=1 through the conditioning LRU
        → {prompt: (vec (1, 768), txt (1, L, 4096))}. ``timings`` gets this call's
        hits and misses; the attributes keep the lifetime totals."""
        size = self.config.cond_cache_size
        t5_len = self.config.text_enc_max_length
        out: Dict[str, Any] = {}
        hits = misses = 0
        for p in dict.fromkeys(prompts):
            hit = self._cond_cache.get((p, t5_len)) if size > 0 else None
            if hit is not None:
                self._cond_cache.move_to_end((p, t5_len))
                hits += 1
                out[p] = hit
                continue
            misses += 1
            enc = get_weighted_text_embeddings(
                self.clip, self.t5, p, num_images_per_prompt=1, t5_length=t5_len
            )
            out[p] = enc
            if size > 0:
                self._cond_cache[(p, t5_len)] = enc
                while len(self._cond_cache) > size:
                    self._cond_cache.popitem(last=False)
        self.cond_cache_hits += hits
        self.cond_cache_misses += misses
        self.timings["cond_cache_hits"] = hits
        self.timings["cond_cache_misses"] = misses
        return out

    def prepare(self, img: torch.Tensor, prompt: Union[str, List[str]]):
        """Pack latents, build id grids, embed text (reference flux_pipeline.py:233-312)."""
        bs, c, h, w = img.shape
        if bs == 1 and not isinstance(prompt, str):
            bs = len(prompt)
        packed = pack_latents(img)
        if packed.shape[0] == 1 and bs > 1:
            packed = packed.repeat_interleave(bs, dim=0)
        img_ids = make_img_ids(h, w, bs, device=self.device_flux)

        if isinstance(prompt, str) or len(set(prompt)) == 1:
            prompt_str = prompt if isinstance(prompt, str) else prompt[0]
            vec, txt = self._encode_prompts([prompt_str])[prompt_str]
            if bs > 1:
                vec = vec.repeat_interleave(bs, dim=0)
                txt = txt.repeat_interleave(bs, dim=0)
        else:
            if len(prompt) != bs:
                raise ValueError(f"got {len(prompt)} prompts for batch size {bs}")
            encs = self._encode_prompts(prompt)
            vec = torch.cat([encs[p][0] for p in prompt], dim=0)
            txt = torch.cat([encs[p][1] for p in prompt], dim=0)
        txt_ids = make_txt_ids(txt.shape[1], bs, device=self.device_flux)
        vec = vec.to(self.device_flux, self.dtype)
        txt = txt.to(self.device_flux, self.dtype)
        return packed, img_ids, vec, txt, txt_ids

    # -------------------------------------------------------------------- calibration

    def _calibration_denoise(self, img, img_ids, txt, txt_ids, vec, timesteps, guidance, silent):
        """Per-step loop that accumulates amax trials and freezes the input scales
        after num_scale_trials steps (float8_quantize.py:220-246)."""
        step_collect = make_denoise_step(self.model_cfg, collect_amax=True)
        step_plain = make_denoise_step(self.model_cfg)
        pairs = list(zip(timesteps[:-1], timesteps[1:]))
        if not silent:
            from tqdm import tqdm

            pairs = tqdm(pairs, desc="denoise(calibrating)")
        for t_curr, t_prev in pairs:
            if self._trials_done < self.config.num_scale_trials:
                img, amaxes = step_collect(
                    self.model_params, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance
                )
                self._amax_running = merge_amax(self._amax_running, amaxes)
                apply_input_scales(self.model_params, self._amax_running)
                self._trials_done += 1
                if self._trials_done >= self.config.num_scale_trials:
                    self._needs_calibration = False
            else:
                img = step_plain(
                    self.model_params, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance
                )
        return img

    # ----------------------------------------------------------------------- generate

    @torch.inference_mode()
    def generate(
        self,
        prompt: str,
        width: int = 720,
        height: int = 1024,
        num_steps: int = 24,
        guidance: float = 3.5,
        seed: Optional[Union[int, str]] = None,
        init_image=None,
        strength: float = 1.0,
        silent: bool = False,
        num_images: int = 1,
        return_seed: bool = False,
        jpeg_quality: int = 99,
        cache=None,
    ) -> io.BytesIO:
        """Generate image(s); returns JPEG bytes (reference flux_pipeline.py:525-663).
        ``cache`` is validated (sampling.CacheConfig); only mode "none" runs."""
        CacheConfig.parse(cache)
        num_steps = 4 if self.name == ModelVersion.flux_schnell.value else num_steps
        height = 16 * (height // 16)
        width = 16 * (width // 16)
        generator, seed = self.set_seed(seed)

        img, timesteps = self.preprocess_latent(
            init_image, height, width, num_steps, strength, generator, num_images
        )
        t_prepare = time.perf_counter()
        img, img_ids, vec, txt, txt_ids = self.prepare(img, prompt)
        self.timings["prepare_seconds"] = time.perf_counter() - t_prepare

        t_denoise = time.perf_counter()
        if self._needs_calibration:
            img = self._calibration_denoise(
                img, img_ids, txt, txt_ids, vec, timesteps, guidance, silent
            )
        else:
            img = denoise(
                self.model_params, self.model_cfg, img, img_ids, txt, txt_ids, vec,
                timesteps, guidance, fused=silent, progress=not silent,
            )
        _sync(img)
        self.timings["denoise_seconds"] = time.perf_counter() - t_denoise
        self.timings["denoise_it_per_s"] = (len(timesteps) - 1) / max(
            self.timings["denoise_seconds"], 1e-9
        )
        self.last_latents = img

        t_decode = time.perf_counter()
        pixels = self.vae_decode(img, height, width)
        out = self.into_bytes(pixels, jpeg_quality=jpeg_quality)
        self.timings["decode_seconds"] = time.perf_counter() - t_decode
        if return_seed:
            return out, seed
        return out

    def vae_decode(self, latents: torch.Tensor, height: int, width: int) -> np.ndarray:
        """Packed latents → (B, H, W, 3) uint8 pixels; the [-1, 1] → byte step runs on
        the device (reference flux_pipeline.py:422-448 + :373-397)."""
        x = unpack_latents(latents.float(), height, width)  # (B, C, h, w)
        x = x.permute(0, 2, 3, 1).to(self.device_ae, self.ae_dtype)  # NHWC
        y = ae_decode(self.ae_params, self.config.ae_params, x).float()
        pixels = torch.floor(torch.clamp((torch.clamp(y, -1.0, 1.0) + 1.0) * 127.5, 0.0, 255.0))
        return pixels.to(torch.uint8).cpu().numpy()

    def into_bytes(self, pixels: np.ndarray, jpeg_quality: int = 99) -> io.BytesIO:
        return self.img_encoder.encode_array(pixels, quality=jpeg_quality)

    # -------------------------------------------------------------------------- LoRA

    def load_lora(self, lora_path, scale: float, name: Optional[str] = None):
        raise NotImplementedError("LoRA is not ported yet (ROADMAP: LoRA)")

    def unload_lora(self, path_or_identifier: str):
        raise NotImplementedError("LoRA is not ported yet (ROADMAP: LoRA)")

    # -------------------------------------------------------------------- checkpoints

    def save_prequantized(self, path: str):
        """Write the quantized flow and its tuned scales so that a reload skips both
        quantization and calibration (the reference's prequantized workflow,
        README.md:186-192), in the file layout the JAX package reads too. Raises while
        the input scales are still uncalibrated (generate, or ``compile()``, first)."""
        if self._needs_calibration:
            raise RuntimeError(
                "input scales are not calibrated yet — run generate() for at least "
                f"{self.config.num_scale_trials} steps (or compile()) before saving"
            )
        from .utils.checkpoint import save_prequantized

        save_prequantized(path, self.model_params, extra_meta={
            "quantize_modulation": str(self.config.quantize_modulation),
            "quantize_flow_embedder_layers": str(self.config.quantize_flow_embedder_layers),
            "version": str(self.config.version),
        })

    # ------------------------------------------------------------------------ compile

    def warmup(self, resolutions, num_steps: int = 4, prompt: str = "warmup"):
        """One silent generate per (width, height): first-use costs (the kernel build,
        cuBLAS heuristics, allocator growth) land here instead of in a request."""
        for width, height in resolutions:
            self.generate(prompt=prompt, width=width, height=height, num_steps=num_steps,
                          seed=0, silent=True)

    def compile(self):
        """Calibration + serving-bucket warmup (reference flux_pipeline.py:179-231).

        1. While the input scales are uncalibrated, run the reference's warmup recipe —
           768×768 at 12 steps (4 for schnell) — until they freeze.
        2. If the config asks for serving warmup (compile flags or
           ``warmup_resolutions``), warm each bucket (default 720×1024) at
           ``warmup_steps`` (default 24, 4 for schnell).
        """
        schnell = self.name == ModelVersion.flux_schnell.value
        while self._needs_calibration:
            self.generate(
                prompt="A beautiful test image used to solidify the fp8 input scales prior to compilation",
                height=768, width=768, num_steps=4 if schnell else 12, guidance=3.5,
                seed=10, silent=True,
            )
        if not (self.config.warmup_resolutions or self.config.compile_blocks or self.config.compile_extras):
            return
        resolutions = [tuple(r) for r in (self.config.warmup_resolutions or [[720, 1024]])]
        steps = self.config.warmup_steps or (4 if schnell else 24)
        self.warmup(resolutions, num_steps=steps)

    # ------------------------------------------------------------------------ loaders

    @classmethod
    def load_pipeline_from_config_path(
        cls, path: str, flow_model_path: Optional[str] = None, debug: bool = False, **kwargs
    ) -> "FluxPipeline":
        """reference flux_pipeline.py:665-679 (kwargs override config fields)."""
        config = load_config_from_path(path)
        if flow_model_path:
            config.ckpt_path = flow_model_path
        for k, v in kwargs.items():
            if hasattr(config, k):
                setattr(config, k, v)
        return cls.load_pipeline_from_config(config, debug=debug)

    @classmethod
    def load_pipeline_from_config(cls, config: ModelSpec, debug: bool = False) -> "FluxPipeline":
        """reference flux_pipeline.py:681-729."""
        models = load_models_from_config(config)
        return cls(
            name=str(getattr(config.version, "value", config.version)),
            clip=models.clip,
            t5=models.t5,
            model=models.flow,
            model_cfg=models.flow_cfg,
            ae=models.ae,
            config=config,
            prequantized=models.flow_prequantized,
            debug=debug,
        )
