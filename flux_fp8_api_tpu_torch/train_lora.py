"""LoRA fine-tuning CLI: images and captions in, a kohya-format LoRA safetensors file out
(JAX counterpart: ``flux_fp8_api_tpu.train_lora``).

The flow stays in the config's (typically quantized) form as a frozen base; rank-r
adapters train QLoRA-style (``parallel/train.py:make_lora_train_step``: AdamW with
optax's defaults, global-norm clip 1.0, remat, the dequantize path, the rope pass and
SDPA); the export (``lora.save_lora_adapters``) is a standard ``lora_unet_*`` file that
``POST /lora`` and any FLUX stack load.

    python -m flux_fp8_api_tpu_torch.train_lora --config-path configs/config-dev-int8.json \\
        --data-dir ./my_dataset --rank 16 --steps 1000 --lr 1e-4 \\
        --width 512 --height 512 --output my_lora.safetensors

Dataset layout: a directory of images (png/jpg/jpeg/webp/bmp); each image's caption
comes from a same-stem ``.txt`` file when present, else from the filename stem
(underscores → spaces), the kohya folder convention.

Everything before the train loop reuses the serving pipeline's components: its
resize-center-crop, the VAE encode (sampled, on a generator) at the config's dtype,
and the weighted T5/CLIP embedding with prompt emphasis. The encodes cross into
training as plain host arrays, as in the JAX package.

Randomness: seeds derived from ``--seed`` draw the encoder samples, the adapters'
initial A, each step's t and ε (a generator per step, seeded from the step's index),
and the fixed validation draw; the data order is ``np.random.default_rng(seed)``'s
permutations as in JAX. A run resumed from ``--state-dir`` therefore continues the
uninterrupted run exactly.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a FLUX LoRA on a frozen (quantized) base")
    p.add_argument("--config-path", type=str, required=True,
                   help="ModelSpec JSON: the same config files serving uses; the "
                        "flow loads in its configured quantization and stays frozen")
    p.add_argument("--data-dir", type=str, required=True,
                   help="Directory of images; captions from same-stem .txt files "
                        "(else the filename stem)")
    p.add_argument("--output", type=str, required=True,
                   help="Output .safetensors path (kohya lora_unet_* format)")
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-every", type=int, default=0,
                   help="Also export every N steps (0 = only at the end)")
    p.add_argument("--no-remat", action="store_true",
                   help="Disable per-block gradient rematerialization (faster per step; "
                        "every block's activations and dequantized weights stay held)")
    p.add_argument("--state-dir", type=str, default=None,
                   help="Train-state directory: {adapters, optimizer state, step} saved "
                        "beside every export and restored at startup when present, so "
                        "interrupted runs resume exactly")
    p.add_argument("--val-every", type=int, default=0,
                   help="Every N steps, report loss on a held-out example (needs "
                        ">=4 examples; 0 = off). Uses a FIXED timestep/noise draw so "
                        "the number is comparable across evals")
    p.add_argument("--t-sampling", choices=["logit_normal", "uniform"],
                   default="logit_normal",
                   help="Timestep density: logit_normal (default; SD3/FLUX training "
                        "density, resolution-shifted like the sampler schedule) or "
                        "uniform")
    return p.parse_args(argv)


def list_examples(data_dir: str) -> List[Tuple[str, str]]:
    """→ [(image_path, caption)] following the kohya folder convention."""
    pairs = []
    for name in sorted(os.listdir(data_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in _IMAGE_EXTS:
            continue
        img_path = os.path.join(data_dir, name)
        txt_path = os.path.join(data_dir, stem + ".txt")
        if os.path.exists(txt_path):
            with open(txt_path, "r", encoding="utf-8") as f:
                caption = f.read().strip()
        else:
            caption = stem.replace("_", " ")
        pairs.append((img_path, caption))
    if not pairs:
        raise ValueError(f"no images found under {data_dir} (looked for {_IMAGE_EXTS})")
    return pairs


@torch.inference_mode()
def encode_dataset(pipe, pairs, width: int, height: int, generator: torch.Generator) -> Dict[str, np.ndarray]:
    """Encode every example once (latents through the VAE, sampled on ``generator``,
    which lives on the VAE's device; text through T5/CLIP, once per distinct caption)
    into host numpy: {latents (N, L, C), txt, y, img_ids, txt_ids}, fp32."""
    from PIL import Image

    from .models.autoencoder import ae_encode
    from .ops.packing import make_img_ids, make_txt_ids, pack_latents

    latents, txts, vecs = [], [], []
    captions: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    ae = pipe._ae_on_device()
    for i, (img_path, caption) in enumerate(pairs):
        img = np.asarray(Image.open(img_path).convert("RGB"), np.uint8)
        arr = pipe.resize_center_crop(img, height, width)
        nhwc = torch.from_numpy(arr.astype(np.float32) / 127.5 - 1.0)[None]
        z = ae_encode(ae, pipe.config.ae_params, nhwc.to(pipe.device_ae, pipe.ae_dtype), generator)
        latents.append(pack_latents(z.permute(0, 3, 1, 2).float()).cpu().numpy())
        if caption not in captions:
            vec, txt = pipe.embed_text(caption)
            captions[caption] = (vec.float().cpu().numpy(), txt.float().cpu().numpy())
        vec, txt = captions[caption]
        vecs.append(vec)
        txts.append(txt)
        if (i + 1) % 25 == 0:
            logger.info("encoded %d/%d examples", i + 1, len(pairs))
    lat = np.concatenate(latents, axis=0)
    txt = np.concatenate(txts, axis=0)
    n = lat.shape[0]
    return {
        "latents": lat,
        "txt": txt,
        "y": np.concatenate(vecs, axis=0),
        "img_ids": make_img_ids(height // 8, width // 8, n).numpy(),
        "txt_ids": make_txt_ids(txt.shape[1], n).numpy(),
    }


def _seeds(seed: int) -> Dict[str, int]:
    """Independent seeds for the run's four streams, derived from ``--seed``."""
    names = ("data", "init", "steps", "val")
    return dict(zip(names, (int(s) for s in np.random.SeedSequence(seed).generate_state(len(names)))))


def train(argv=None) -> Optional[str]:
    args = parse_args(argv)
    from .lora import init_lora_adapters, merge_lora_adapters, save_lora_adapters
    from .parallel.train import (
        STATE_FILE,
        adamw,
        flow_matching_loss,
        make_lora_train_step,
        restore_train_state,
        sample_timesteps,
        save_train_state,
        train_cfg,
    )
    from .pipeline import FluxPipeline
    from .utils.tree import tree_to

    if args.width % 16 or args.height % 16:
        raise ValueError("width/height must be multiples of 16 (2x2-packed 8x VAE latents)")

    pipe = FluxPipeline.load_pipeline_from_config_path(args.config_path)
    cfg = pipe.model_cfg
    device = pipe.device_flux
    base = pipe.model_params
    if pipe.offload_flow:
        # training runs the flow every step: a copy on the card for the whole run
        base = tree_to(base, device)
    seeds = _seeds(args.seed)

    pairs = list_examples(args.data_dir)
    logger.info("%d training examples; encoding at %dx%d", len(pairs), args.width, args.height)
    data = encode_dataset(pipe, pairs, args.width, args.height,
                          torch.Generator(device=pipe.device_ae).manual_seed(seeds["data"]))
    n = data["latents"].shape[0]

    # hold out one example for validation when asked and the set is big enough
    val_idx = None
    if args.val_every and n >= 4:
        val_idx = n - 1
        n -= 1
    elif args.val_every:
        logger.warning("--val-every needs >=4 examples; validation disabled")

    adapters = init_lora_adapters(base, args.rank, torch.Generator(device=device).manual_seed(seeds["init"]))
    init_fn, step = make_lora_train_step(cfg, adamw(args.lr), remat=not args.no_remat,
                                         t_sampling=args.t_sampling, max_grad_norm=1.0)
    opt = init_fn(adapters)

    start_step = 0
    if args.state_dir and os.path.exists(os.path.join(args.state_dir, STATE_FILE)):
        adapters, opt, start_step = restore_train_state(os.path.abspath(args.state_dir), adapters, opt)
        logger.info("resumed train state from %s @ step %d", args.state_dir, start_step)

    def on_device(idx):
        return {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(device) for k, v in data.items()}

    val = None
    if val_idx is not None:
        vbatch = on_device(slice(val_idx, val_idx + 1))
        vgen = torch.Generator(device=device).manual_seed(seeds["val"])  # a FIXED t/noise draw
        vt = sample_timesteps(vgen, 1, vbatch["latents"].shape[1], args.t_sampling)
        vnoise = torch.randn(vbatch["latents"].shape, generator=vgen, device=device)
        val = (vbatch, vt, vnoise, train_cfg(cfg, remat=False, dequant=True))

    bs = max(1, min(args.batch_size, n))
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(n)
    cursor = 0
    # fast-forward the data order to the restored step, so that a resumed run draws the
    # batches an uninterrupted one would (each step's t and ε come from its own seed)
    for _ in range(start_step):
        if cursor + bs > n:
            order = rng.permutation(n)
            cursor = 0
        cursor += bs
    ema_loss = None
    for it in range(start_step, args.steps):
        if cursor + bs > n:
            order = rng.permutation(n)
            cursor = 0
        idx = order[cursor:cursor + bs]
        cursor += bs
        gen = torch.Generator(device=device).manual_seed(seeds["steps"] + it)
        adapters, opt, loss = step(adapters, opt, base, on_device(idx), gen)
        loss_val = float(loss)
        ema_loss = loss_val if ema_loss is None else 0.98 * ema_loss + 0.02 * loss_val
        if (it + 1) % 10 == 0 or it == start_step:
            logger.info("step %d/%d  loss %.4f  ema %.4f", it + 1, args.steps, loss_val, ema_loss)
        if val is not None and (it + 1) % args.val_every == 0:
            vbatch, vt, vnoise, vcfg = val
            with torch.no_grad():
                vloss = flow_matching_loss(merge_lora_adapters(base, adapters), vcfg, vbatch, t=vt, noise=vnoise)
            logger.info("step %d  val loss %.4f", it + 1, float(vloss))
        if args.save_every and (it + 1) % args.save_every == 0:
            save_lora_adapters(args.output, adapters, cfg)
            if args.state_dir:
                save_train_state(os.path.abspath(args.state_dir), adapters, opt, it + 1, overwrite=True)
            logger.info("checkpointed adapters to %s @ step %d", args.output, it + 1)

    save_lora_adapters(args.output, adapters, cfg)
    if args.state_dir:
        save_train_state(os.path.abspath(args.state_dir), adapters, opt, args.steps, overwrite=True)
    ema_note = f", final ema loss {ema_loss:.4f}" if ema_loss is not None else ""
    logger.info("LoRA (rank %d, %d steps%s) written to %s: load with pipeline.load_lora or POST /lora",
                args.rank, args.steps, ema_note, args.output)
    return args.output


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train()
