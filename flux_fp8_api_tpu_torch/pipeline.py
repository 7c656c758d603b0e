"""FluxPipeline: txt2img, img2img and LoRA hot-load (JAX counterpart:
``flux_fp8_api_tpu.pipeline``; reference ``flux_pipeline.py:58-729``).

The same public surface and the same calibration protocol: the first
``num_scale_trials`` denoise steps after load collect per-layer input amaxes, and the
input scales of the fp8, int8 and int4 linears freeze after them. Randomness comes from
``torch.Generator``s, so a seed gives other noise than the JAX package's threefry keys;
an init image's VAE sample is drawn from the same generator, after the noise.

The step cache (``sampling.CacheConfig``) runs as in JAX, with the skip decision made
on the host. Offload runs as in JAX: the flow on the host, streamed block by block
under the denoise loop (``offload.py``) once its input scales are calibrated, or moved
whole to the card and back around each request (calibration, and
``stream_flow_offload=False``); the VAE and the text encoders moved to the card only
for their calls.

Under ``config.mesh`` (``{"dp": …, "tp": …, "sp": …, "pp": …}``) each rank of the mesh
runs this pipeline as JAX pipeline.py:129-255 sets it up: under tp the flow relayouts
to the head-major fused layout and keeps its Megatron shard, and the text encoders
shard too; dp splits the batch rows (noise drawn whole from the seed on every rank,
each keeping its rows); sp splits attention's q rows; pp gives each stage its depth
slice of the block stacks and pipelines them (``parallel/pp.py``, composing with dp
only). The latents are all-gathered over dp. The VAE decodes (and an init image
encodes) in horizontal bands over the dp and tp ranks where their count divides the
rows (``models/autoencoder.py:Bands``), and the first rank answers. Calibration takes
each amax's MAX over the mesh. Offload under a mesh keeps each rank's own shard tree
on the host and moves it whole around each request; the flow streams block by block
only without a mesh, as in JAX.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import logging
import math
import os
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from . import lora as lora_mod
from . import offload as offload_mod
from .calibration import apply_input_scales, merge_amax, reduce_amaxes
from .emphasis import get_weighted_text_embeddings
from .image_encoder import ImageEncoder
from .models.autoencoder import Bands, ae_decode, ae_encode
from .models.flux import FluxStatic, max_logit_bound
from .ops.attention_kernel import MAX_SAFE_LOGIT
from .ops.packing import make_img_ids, make_txt_ids, pack_latents, unpack_latents
from .ops.quant import ACTIVATION_KINDS, Linear
from .ops.schedule import get_schedule
from .parallel.mesh import (
    gather_flux_params, gather_flux_stages, make_mesh, parse_axes, setup_flux, shard_encoder_params,
)
from .parallel.pp import make_pp_runner
from .sampling import CacheConfig, denoise, make_denoise_step
from .utils.config import ModelSpec, ModelVersion, into_device, into_dtype, load_config_from_path
from .utils.loader import load_models_from_config
from .utils.tree import ParamTree, copy_tree_, pin_tree_, tree_to

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
        mesh=None,
    ):
        if config is None:
            raise ValueError("ModelSpec config is required!")
        self.name = name
        self.config = config
        self.debug = debug
        self.verbose = verbose
        # the rank's mesh (parallel/mesh.py), given by the launcher or built here from
        # config.mesh (which needs the ranks' process group already up)
        self.mesh = self._make_mesh(config, mesh)

        self.device_flux = into_device(config.flux_device) if self.mesh is None else self.mesh.device
        self.device_ae = into_device(config.ae_device) if self.mesh is None else self.mesh.device
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
            # package serves through XLA attention. A pp stage may hold only its
            # blocks: the bound is the MAX over the stages.
            bound = max_logit_bound(model, model_cfg)
            if self.mesh is not None:
                bound = float(self.mesh.all_reduce_max(torch.tensor([bound], device=self.mesh.device), "pp")[0])
            if bound > MAX_SAFE_LOGIT:
                logger.warning(
                    "qk-norm scales give an attention |logit| bound of %.0f > %.0f: the "
                    "max-free attention kernel could overflow exp — serving these weights "
                    "with use_pallas=False (rope pass + scaled_dot_product_attention)",
                    bound, MAX_SAFE_LOGIT,
                )
                self.model_cfg = dataclasses.replace(model_cfg, use_pallas=False)
        # under pp the GPipe stack runner (parallel/pp.py) and each stage's depth slice
        self._pp_runner = None
        if self.mesh is not None and self.mesh.size("pp") > 1:
            self._pp_runner = make_pp_runner(self.mesh, config.pp_microbatches,
                                             dp_axis="dp" if "dp" in self.mesh.shape else None)
        if self.mesh is not None:
            model = self._place_flow(model)
            if self.mesh.size("tp") > 1:  # the text encoders shard over the same axis
                for enc in (clip, t5):
                    if enc is not None:
                        # an offloaded encoder's host tree is the one sharded: each move
                        # to the card carries the shard (JAX re-shards at to_device)
                        shard_encoder_params(enc.params, self.mesh, num_heads=enc.config.num_heads)
                        if getattr(enc, "offload", False) and self.mesh.device.type == "cuda":
                            pin_tree_(enc.host_params)
            for enc in (clip, t5):
                if getattr(enc, "stream", False):  # streaming happens only without a mesh, as in JAX
                    enc.stream = False
        self.offload_flow = config.offload_flow
        self.offload_vae = config.offload_vae
        self.offload_text_encoder = config.offload_text_encoder
        # offloaded trees live on the host, page-locked when their device is a card
        self.model_params = self._to_host(model, self.device_flux) if self.offload_flow else model
        self.ae_params = self._to_host(ae, self.device_ae) if self.offload_vae else ae
        # streamed offload: (top-level params on the card, host double blocks, host
        # single blocks), built at the first streamed generate and dropped whenever the
        # flow's weights change (a LoRA fuse, a calibration trial)
        self._stream_state = None

        self._needs_calibration = (
            not prequantized and self._is_quantized() and config.num_scale_trials > 0
        )
        if self._needs_calibration and self._pp_runner is not None:
            # calibration is a one-rank protocol (flux_apply refuses it under a runner):
            # refused here, not at the first generate (JAX pipeline.py:267-273)
            raise ValueError("pp serving requires calibrated input scales: load a prequantized "
                             "checkpoint (save_prequantized) or set num_scale_trials=0")
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
        self.loras: List[lora_mod.LoraWeights] = []  # fused LoRAs (reference flux_model.py:518)

        if config.compile_blocks or config.compile_extras:
            self.compile()

    # -------------------------------------------------------------------------- mesh

    @staticmethod
    def _make_mesh(config: ModelSpec, mesh):
        """The serving mesh of ``config.mesh`` (JAX pipeline.py:129-186): its axes
        validated; a pp axis composes only with dp and must divide a stack's depth (a
        stack it does not divide stays whole on every stage, with a warning)."""
        if not config.mesh:
            return None
        shape = parse_axes(config.mesh)
        stages = shape.get("pp", 1)
        if stages > 1:
            bad = [a for a in ("tp", "sp") if shape.get(a, 1) > 1]
            if bad:
                raise ValueError(f"pp does not compose with {bad}: serve with dp/tp/sp (freely "
                                 "composable) or dp+pp")
            depths = {"double_blocks": config.params.depth, "single_blocks": config.params.depth_single_blocks}
            for k, d in depths.items():
                if d % stages:
                    logger.warning("pp=%d doesn't divide %s depth %d: that stack stays whole on every stage "
                                   "(a plain loop, no pipeline)", stages, k, d)
            if all(d % stages for d in depths.values()):
                raise ValueError(f"pp={stages} divides neither stack depth ({depths['double_blocks']} doubles, "
                                 f"{depths['single_blocks']} singles) — every rank would hold and run the "
                                 "full model; use dp/tp/sp instead")
        if mesh is None:
            mesh = make_mesh(shape, device="cpu" if str(config.flux_device or "").startswith("cpu") else None)
        if mesh.shape != shape:
            raise ValueError(f"the mesh given is {mesh.shape}, the config asks for {shape}")
        return mesh

    def _place_flow(self, model):
        """The flow's mesh set-up on this rank (JAX pipeline.py:187-246, ``_place_flow``
        ``:371-383``; ``parallel/mesh.py:setup_flux``) → the rank's model."""
        if self.model_cfg is None:
            return model
        model, self.model_cfg = setup_flux(model, self.model_cfg, self.mesh)
        return model

    def _denoise_cfg(self, joint_seq_len: int) -> FluxStatic:
        """This request's model config: sp dropped when its joint (txt + img) length
        does not divide the sp size (JAX pipeline.py:321-334); every sp rank then
        computes the whole attention."""
        cfg = self.model_cfg
        if cfg.attn_seq_axis and joint_seq_len % self.mesh.size(cfg.attn_seq_axis):
            logger.info("joint seq %d does not divide sp=%d: head-sharded attention only for this "
                        "request", joint_seq_len, self.mesh.size(cfg.attn_seq_axis))
            return dataclasses.replace(cfg, attn_seq_axis=None)
        return cfg

    def _put_flow_input(self, *xs):
        """→ (this rank's rows of each activation, the rows): the dp split of the batch
        where dp divides it, else the whole batch and None (JAX pipeline.py:405-414)."""
        rows = None if self.mesh is None else self.mesh.batch_rows(xs[0].shape[0])
        return (xs if rows is None else tuple(x[rows] for x in xs)), rows

    def ae_band_axes(self, h: int, multiple: int = 1):
        """The mesh axes a VAE input of ``h`` rows splits over (JAX
        ``_ae_input_sharding``, pipeline.py:357-369): dp and tp together when their
        product divides ``h``, else the first of them alone that divides it, else None
        (whole on one rank). ``multiple``: what each band's rows must also divide (the
        encoder's stride-2 levels need even bands)."""
        if self.mesh is None:
            return None
        axes = [a for a in ("dp", "tp") if self.mesh.size(a) > 1]
        for cand in ([tuple(axes)] if len(axes) > 1 else []) + [(a,) for a in axes]:
            n = self.mesh.size(cand)
            if h % n == 0 and (h // n) % multiple == 0:
                return cand
        return None

    def _bands(self, h: int, multiple: int = 1) -> Optional[Bands]:
        axes = self.ae_band_axes(h, multiple)
        return None if axes is None else Bands(self.mesh, axes)

    def profile(self, log_dir: str):
        """A ``torch.profiler`` trace of what runs inside the context (one or more
        generates), written to ``log_dir`` for TensorBoard or Perfetto (JAX
        pipeline.py:927-931)."""
        from .profile_step import trace

        return trace(log_dir, self.device_flux)

    # ------------------------------------------------------------------------- state

    @staticmethod
    def _to_host(tree, device: torch.device):
        if tree is None:
            return None
        return tree_to(tree, "cpu", pin=device.type == "cuda")

    def _ensure_stream_state(self):
        """The streamed-offload state (JAX pipeline.py:389-403), built if missing: the
        host tree pinned again where a LoRA fuse left unpinned tensors, and the
        top-level params copied to the card."""
        if self._stream_state is None:
            if self.device_flux.type == "cuda":
                pin_tree_(self.model_params)
            tops, dbl, sgl = offload_mod.split_flow_params(self.model_params)
            self._stream_state = (offload_mod.tops_to_device(tops, self.device_flux), dbl, sgl)
        return self._stream_state

    def _invalidate_stream(self):
        self._stream_state = None

    def _ae_on_device(self):
        """The VAE's weights on its device: under ``offload_vae`` a copy for this call,
        dropped after it (the host tree never changes, so nothing comes back)."""
        if self.offload_vae:
            return tree_to(self.ae_params, self.device_ae, non_blocking=True)
        return self.ae_params

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

    def load_init_image_if_needed(self, init_image) -> Optional[np.ndarray]:
        """A path, base64 (or a data URL), PIL image or array → (H, W, 3) uint8
        (reference flux_pipeline.py:399-420)."""
        if init_image is None:
            return None
        if isinstance(init_image, str):
            try:
                init_image = Image.open(init_image)
            except (OSError, ValueError):  # not a readable path: base64
                init_image = Image.open(io.BytesIO(base64.b64decode(init_image.split(",")[-1])))
        if isinstance(init_image, Image.Image):
            init_image = np.array(init_image.convert("RGB"))
        return np.asarray(init_image).astype(np.uint8)

    def resize_center_crop(self, img: np.ndarray, height: int, width: int) -> np.ndarray:
        """Resize the shorter side to min(width, height) (PIL bilinear), then crop the
        centre (height, width) (reference flux_pipeline.py:450-457)."""
        im = Image.fromarray(img)
        w0, h0 = im.size
        scale = min(width, height) / min(w0, h0)
        im = im.resize((round(w0 * scale), round(h0 * scale)), Image.BILINEAR)
        w1, h1 = im.size
        left, top = (w1 - width) // 2, (h1 - height) // 2
        return np.array(im.crop((left, top, left + width, top + height)))

    def preprocess_latent(self, init_image: Optional[np.ndarray], height: int, width: int,
                          num_steps: int, strength: float, generator: torch.Generator,
                          num_images: int):
        """Noise + schedule, and for an init image its VAE encode, the noise mixed in at
        the schedule's step ``int((1 - strength) · num_steps)`` and the steps before it
        dropped (reference flux_pipeline.py:459-523)."""
        x = self.get_noise(num_images, height, width, generator)
        timesteps = get_schedule(
            num_steps=num_steps,
            image_seq_len=x.shape[-1] * x.shape[-2] // 4,
            shift=(self.name != ModelVersion.flux_schnell.value),
        )
        if init_image is not None:
            arr = self.resize_center_crop(init_image, height, width)
            nhwc = torch.from_numpy(arr.astype(np.float32) / 127.5 - 1.0)[None]
            t_encode = time.perf_counter()
            # in bands over the mesh where they divide the rows into even bands at every
            # stride-2 level of the encoder
            band = self._bands(height, 2 ** (len(self.config.ae_params.ch_mult) - 1))
            args = (self._ae_on_device(), self.config.ae_params, nhwc.to(self.device_ae, self.ae_dtype), generator)
            if band is None:
                z = ae_encode(*args)  # (1, h, w, z)
            else:  # the band's rows in, the whole latent out
                z = ae_encode(*args[:2], band.rows(args[2], 1), generator, band)
            z = z.permute(0, 3, 1, 2).to(self.device_flux, self.dtype).repeat(num_images, 1, 1, 1)
            _sync(z)
            self.timings["encode_seconds"] = time.perf_counter() - t_encode
            t_idx = int((1 - strength) * num_steps)
            t = timesteps[t_idx]
            timesteps = timesteps[t_idx:]
            x = t * x + (1.0 - t) * z
        return x, timesteps

    def _encode_prompts(self, prompts: List[str]):
        """Encode each distinct prompt at N=1 through the conditioning LRU
        → {prompt: (vec (1, 768), txt (1, L, 4096))}. ``timings`` gets this call's
        hits and misses; the attributes keep the lifetime totals."""
        size = self.config.cond_cache_size
        t5_len = self.config.text_enc_max_length
        out: Dict[str, Any] = {}
        misses: List[str] = []
        for p in dict.fromkeys(prompts):
            hit = self._cond_cache.get((p, t5_len)) if size > 0 else None
            if hit is not None:
                self._cond_cache.move_to_end((p, t5_len))
                out[p] = hit
            else:
                misses.append(p)
        if misses:  # a full hit moves no encoder
            if self.offload_text_encoder:
                self.clip.to_device()
                self.t5.to_device()
            for p in misses:
                enc = get_weighted_text_embeddings(
                    self.clip, self.t5, p, num_images_per_prompt=1, t5_length=t5_len
                )
                out[p] = enc
                if size > 0:
                    self._cond_cache[(p, t5_len)] = enc
                    while len(self._cond_cache) > size:
                        self._cond_cache.popitem(last=False)
            if self.offload_text_encoder:
                self.clip.to_host()
                self.t5.to_host()
        hits = len(out) - len(misses)
        misses = len(misses)
        self.cond_cache_hits += hits
        self.cond_cache_misses += misses
        self.timings["cond_cache_hits"] = hits
        self.timings["cond_cache_misses"] = misses
        return out

    def embed_text(self, prompt: str, num_images: int = 1):
        """→ (CLIP vec (N, vec_in_dim), T5 txt (N, L, ctx_dim)) with the emphasis grammar
        and text-encoder offload handled: the single-prompt text path of
        :meth:`prepare`, for callers that batch their own latents (the LoRA trainer's
        dataset encoder, train_lora.py)."""
        vec, txt = self._encode_prompts([prompt])[prompt]
        if num_images > 1:
            vec = vec.repeat_interleave(num_images, dim=0)
            txt = txt.repeat_interleave(num_images, dim=0)
        return vec, txt

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

    def _calibration_denoise(self, img, img_ids, txt, txt_ids, vec, timesteps, guidance, silent, cfg=None):
        """Per-step loop that accumulates amax trials and freezes the input scales
        after num_scale_trials steps (float8_quantize.py:220-246); under a mesh each
        trial's amaxes are the MAX over every rank. ``cfg``: the request's model
        config (default ``model_cfg``)."""
        cfg = self.model_cfg if cfg is None else cfg
        step_collect = make_denoise_step(cfg, collect_amax=True)
        step_plain = make_denoise_step(cfg)
        pairs = list(zip(timesteps[:-1], timesteps[1:]))
        if not silent:
            from tqdm import tqdm

            pairs = tqdm(pairs, desc="denoise(calibrating)")
        for t_curr, t_prev in pairs:
            if self._trials_done < self.config.num_scale_trials:
                img, amaxes = step_collect(
                    self.model_params, img, img_ids, txt, txt_ids, vec, t_curr, t_prev, guidance
                )
                self._amax_running = merge_amax(self._amax_running, reduce_amaxes(amaxes, self.mesh))
                apply_input_scales(self.model_params, self._amax_running)
                self._trials_done += 1
                self._invalidate_stream()  # the input scales changed under the params
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

        ``cache``: the step cache (sampling.CacheConfig, or a dict like ``{"mode":
        "dynamic", "threshold": 0.25}`` from the HTTP body), which skips model
        evaluations; ignored with a warning while calibration trials are pending or
        the flow streams (JAX pipeline.py:677-684). ``timings["cache_model_evals"]``
        then counts the evaluations run."""
        cache = CacheConfig.parse(cache)
        # streamed offload (offload.py) once the input scales are frozen and without a
        # mesh; calibration, a mesh and stream_flow_offload=False move the whole tree
        # (a rank's shard) to the card and back
        streaming = (self.offload_flow and self.config.stream_flow_offload and not self._needs_calibration
                     and self.mesh is None)
        if cache.mode != "none" and self._pp_runner is not None:
            raise ValueError("the step cache does not run under pipeline parallelism (pp): send the "
                             "request without a cache")
        if cache.mode != "none" and (self._needs_calibration or streaming):
            logger.warning("step cache ignored: calibration trials pending or streamed offload active")
            cache = CacheConfig(mode="none")
        num_steps = 4 if self.name == ModelVersion.flux_schnell.value else num_steps
        init_image = self.load_init_image_if_needed(init_image)
        self.timings.pop("encode_seconds", None)
        height = 16 * (height // 16)
        width = 16 * (width // 16)
        generator, seed = self.set_seed(seed)

        img, timesteps = self.preprocess_latent(
            init_image, height, width, num_steps, strength, generator, num_images
        )
        t_prepare = time.perf_counter()
        img, img_ids, vec, txt, txt_ids = self.prepare(img, prompt)
        self.timings["prepare_seconds"] = time.perf_counter() - t_prepare
        cfg = self.model_cfg
        rows = None
        if self.mesh is not None:
            cfg = self._denoise_cfg(txt.shape[1] + img.shape[1])
            (img, img_ids, vec, txt, txt_ids), rows = self._put_flow_input(img, img_ids, vec, txt, txt_ids)

        cache_stats: Dict[str, Any] = {}
        host_flow = None
        if self.offload_flow and not streaming:  # outside the denoise time, as in JAX
            host_flow, self.model_params = self.model_params, tree_to(self.model_params, self.device_flux)
        t_denoise = time.perf_counter()
        try:
            if self._needs_calibration:
                img = self._calibration_denoise(
                    img, img_ids, txt, txt_ids, vec, timesteps, guidance, silent, cfg
                )
            elif streaming:
                tops, dbl, sgl = self._ensure_stream_state()
                retain_gb = self.config.offload_retain_gb
                img = offload_mod.streamed_denoise(
                    tops, dbl, sgl, self.device_flux, img, img_ids, txt, txt_ids, vec,
                    timesteps, guidance, self.model_cfg, progress=not silent,
                    retain_bytes=None if retain_gb is None else int(retain_gb * 1024**3),
                )
            else:
                img = denoise(
                    self.model_params, cfg, img, img_ids, txt, txt_ids, vec,
                    timesteps, guidance, fused=silent, progress=not silent,
                    cache=cache, stats=cache_stats, dp_mesh=self.mesh if rows is not None else None,
                    stack_runner=self._pp_runner,
                )
            if rows is not None:  # every rank's rows, in order
                img = self.mesh.all_gather(img, "dp", dim=0)
            _sync(img)
            self.timings["denoise_seconds"] = time.perf_counter() - t_denoise
        finally:
            if host_flow is not None:  # back into the pinned host tree, calibrated scales too
                self.model_params = copy_tree_(host_flow, self.model_params)
        # schedule steps per second: with the step cache, the JAX package's "effective"
        # rate (a skipped step costs a few elementwise passes)
        self.timings["denoise_it_per_s"] = (len(timesteps) - 1) / max(
            self.timings["denoise_seconds"], 1e-9
        )
        if "model_evals" in cache_stats:
            self.timings["cache_model_evals"] = cache_stats["model_evals"]
        else:
            self.timings.pop("cache_model_evals", None)
        self.last_latents = img
        if self.mesh is not None and not self.mesh.is_root:
            # the first rank answers; the others decode their bands, where there are any
            if self._bands(2 * math.ceil(height / 16)) is not None:
                self.vae_decode(img, height, width)
            return (None, seed) if return_seed else None

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
        band = self._bands(x.shape[1])  # the rows in bands over the mesh, where they divide
        if band is None:
            y = ae_decode(self._ae_on_device(), self.config.ae_params, x).float()
        else:
            y = ae_decode(self._ae_on_device(), self.config.ae_params, band.rows(x, 1), band).float()
        pixels = torch.floor(torch.clamp((torch.clamp(y, -1.0, 1.0) + 1.0) * 127.5, 0.0, 255.0)).to(torch.uint8)
        if band is not None:
            pixels = band.gather(pixels, 1)
        return pixels.cpu().numpy()

    def into_bytes(self, pixels: np.ndarray, jpeg_quality: int = 99) -> io.BytesIO:
        return self.img_encoder.encode_array(pixels, quality=jpeg_quality)

    # -------------------------------------------------------------------------- LoRA

    def load_lora(self, lora_path, scale: float, name: Optional[str] = None):
        """Fuse a LoRA into the flow weights (reference flux_pipeline.py:151-168)."""
        self.model_params, self.loras = lora_mod.pipeline_load_lora(
            self.model_params, self.model_cfg, self.loras, lora_path, scale, name
        )
        self._invalidate_stream()

    def unload_lora(self, path_or_identifier: str):
        """Unfuse a previously loaded LoRA (reference flux_pipeline.py:170-177)."""
        self.model_params, self.loras = lora_mod.pipeline_unload_lora(
            self.model_params, self.model_cfg, self.loras, path_or_identifier
        )
        self._invalidate_stream()

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
        from .utils.checkpoint import relayout_flux_tree, save_prequantized

        model = self.model_params
        if self._pp_runner is not None:  # every stage's blocks
            model = gather_flux_stages(model, self.model_cfg, self.mesh)
        if self.mesh is not None and self.mesh.size("tp") > 1:
            # files always hold the flat layout (JAX pipeline.py:935-966): the shards
            # gathered, the relayout inverted; the first rank writes
            model = relayout_flux_tree(gather_flux_params(model), self.model_cfg, inverse=True)
        if self.mesh is not None and not self.mesh.is_root:
            return
        save_prequantized(path, model, extra_meta={
            "quantize_modulation": str(self.config.quantize_modulation),
            "quantize_flow_embedder_layers": str(self.config.quantize_flow_embedder_layers),
            "version": str(self.config.version),
        })

    # ------------------------------------------------------------------------ compile

    def warmup(self, resolutions, num_steps: int = 4, prompt: str = "warmup",
               autotune: Optional[bool] = None, precompile_interactive: bool = True):
        """One silent generate per (width, height) bucket: first-use costs (the kernel
        build, cuBLAS heuristics, allocator growth) land here instead of in a request
        (JAX pipeline.py:824-925).

        ``autotune`` (default: on when the flow is on a card with ``use_pallas``, and
        either no mesh or a mesh whose heads or q rows are sharded) measures the
        attention kernel's candidate tiles at each bucket's joint length before its
        generate, so the bucket runs its measured-best tile: without a mesh through
        ``ops/attention.py:autotune_blocks``, under a mesh at this rank's local shape
        with the first rank measuring for all (``parallel/mesh.py:autotune_mesh_blocks``).
        With ``config.compilation_cache_dir`` the tiles persist in its
        ``attn_blocks.json``, loaded before and saved after, so a restart measures
        nothing again. ``precompile_interactive`` adds one non-silent 1-step generate
        per bucket: the path with the per-step progress bar."""
        from .ops import attention as attn_mod
        from .parallel.mesh import autotune_mesh_blocks

        cfg = self.model_cfg
        pallas = cfg is not None and cfg.use_pallas
        if autotune is None:
            sharded = self.mesh is not None and (self.mesh.size("tp") > 1 or self.mesh.size("sp") > 1)
            autotune = pallas and self.device_flux.type == "cuda" and (self.mesh is None or sharded)
        cache_dir = self.config.compilation_cache_dir
        blocks_path = os.path.join(cache_dir, "attn_blocks.json") if cache_dir else None
        if autotune and blocks_path:
            n = attn_mod.load_tuned_blocks(blocks_path)
            if n:
                logger.info("loaded %d autotuned attention tile entries from %s", n, blocks_path)
        for width, height in resolutions:
            joint = self.config.text_enc_max_length + (height // 16) * (width // 16)
            if autotune and self.mesh is None:
                attn_mod.autotune_blocks(joint, folded_heads=cfg.num_heads, head_dim=cfg.head_dim, log=logger.info)
            elif autotune:
                autotune_mesh_blocks(self.mesh, joint, cfg.num_heads, cfg.head_dim, seq_axis=cfg.attn_seq_axis,
                                     log=logger.info)
            self.generate(prompt=prompt, width=width, height=height, num_steps=num_steps,
                          seed=0, silent=True)
            if precompile_interactive:
                self.generate(prompt=prompt, width=width, height=height, num_steps=1, seed=0, silent=False)
        if autotune and blocks_path and (attn_mod._TUNED_BLOCKS or attn_mod._TUNED_BLOCKS_RECT):
            if self.mesh is None or self.mesh.is_root:
                attn_mod.save_tuned_blocks(blocks_path)

    def compile(self):
        """Calibration + serving-bucket warmup (reference flux_pipeline.py:179-231).

        1. While the input scales are uncalibrated, run the reference's warmup recipe —
           768×768 at 12 steps (4 for schnell) — until they freeze.
        2. If the config asks for serving warmup (compile flags or
           ``warmup_resolutions``), warm each bucket (default 720×1024) at
           ``warmup_steps`` (default 24, 4 for schnell), autotuning the attention
           tiles on the card and, with ``config.precompile_interactive``, running one
           interactive 1-step generate per bucket too (:meth:`warmup`).
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
        self.warmup(resolutions, num_steps=steps, precompile_interactive=self.config.precompile_interactive)

    # ------------------------------------------------------------------------ loaders

    @classmethod
    def load_pipeline_from_config_path(
        cls, path: str, flow_model_path: Optional[str] = None, debug: bool = False, mesh=None, **kwargs
    ) -> "FluxPipeline":
        """reference flux_pipeline.py:665-679 (kwargs override config fields)."""
        config = load_config_from_path(path)
        if flow_model_path:
            config.ckpt_path = flow_model_path
        for k, v in kwargs.items():
            if hasattr(config, k):
                setattr(config, k, v)
        return cls.load_pipeline_from_config(config, debug=debug, mesh=mesh)

    @classmethod
    def load_pipeline_from_config(cls, config: ModelSpec, debug: bool = False, mesh=None) -> "FluxPipeline":
        """reference flux_pipeline.py:681-729. Under ``config.mesh``, ``mesh`` is this
        rank's (``parallel/launch.py`` builds it); the models load on its device,
        the flow relayouted and sliced leaf by leaf as it is read or drawn."""
        mesh = cls._make_mesh(config, mesh)
        models = load_models_from_config(config, mesh)
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
            mesh=mesh,
        )
