"""The fidelity gate on the card: each quantized tier of flux-dev against its bf16 ground
truth, by SSIM (the port's counterpart of ``bench_fidelity.py full``).

    python -m flux_fp8_api_tpu_torch.bench_fidelity [--steps 28] [--tiers fp8,int8]
    python -m flux_fp8_api_tpu_torch.bench_fidelity --tiny    # hidden 64 on the CPU

flux-dev at full width and depth (hidden 3072, 19 + 38 blocks, 24 heads × 128), its
weights drawn from a seed on the card; a 1024×1024 latent and 512 text tokens from a
seed; ``steps`` Euler steps of a linear 1 → 0 schedule, guidance 3.5. The bf16 ground
truth runs resident (24 GB on an 80 GB card), and only its latent image is kept. Each
tier then draws the same weights from the same seed again, quantized leaf by leaf
(``quantize_flux_tree`` works in place, so quantizing the ground truth's tree would
destroy it; redrawing keeps the peak at one tree), calibrates its input scales with one
amax pass at t = 0.5, denoises, and is compared with the ground truth by the SSIM of
:func:`latent_image` (PSNR beside it). Tiers: ``fp8`` (``_scaled_mm`` without fast
accumulation), ``fp8_fast_accum`` (the serving default), ``int8``, ``int4``.

``run(..., compiled=Compiled(True, True))`` denoises every tier with its blocks and
extras ``torch.compile``'d, the path a ``-C`` server serves (chip_smoke phase 14; the
ground truth stays eager).

Prints one JSON line: ``metric``, ``value`` (the fp8_fast_accum SSIM), ``unit``,
``gate``, ``pass`` (every fp8 tier at or above 0.95), ``detail`` (SSIM per tier),
``psnr``, ``timings``, ``device`` and ``card`` (nvidia-smi's name and power limit).
Without a card the full-size run raises; ``--tiny`` is the CPU plumbing run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .calibration import apply_input_scales, merge_amax
from .models.flux import Compiled, FluxStatic, flux_apply, init_flux_params, quant_tier
from .ops.packing import make_img_ids, make_txt_ids, unpack_latents
from .pipeline import _sync
from .sampling import denoise
from .utils.config import FluxParams
from .utils.fidelity import psnr, ssim

TIERS = ("fp8", "fp8_fast_accum", "int8", "int4")
FP8_TIERS = ("fp8", "fp8_fast_accum")
GATE = 0.95  # fp8 against bf16 (BASELINE.md)
GUIDANCE = 3.5
WEIGHT_SEED = 0  # the weights of the ground truth and of every tier
INPUT_SEED = 1  # the latent noise and the conditioning

FLUX_DEV = FluxParams(
    in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
    num_heads=24, depth=19, depth_single_blocks=38, axes_dim=[16, 56, 56], theta=10_000,
    qkv_bias=True, guidance_embed=True,
)
# --tiny: the CPU plumbing run of this module and bench_cache
TINY = FluxParams(
    in_channels=64, vec_in_dim=32, context_in_dim=48, hidden_size=64, mlp_ratio=4.0,
    num_heads=2, depth=2, depth_single_blocks=2, axes_dim=[8, 12, 12], theta=10_000,
    qkv_bias=True, guidance_embed=True,
)


def latent_image(x: torch.Tensor, h_lat: int, w_lat: int) -> np.ndarray:
    """Packed latents → (H, W) float32 grayscale proxy for SSIM: the channel mean of
    batch row 0, min-max scaled to [0, 255] (JAX bench_fidelity.py:69-77). It keeps a
    random VAE out of the comparison."""
    lat = unpack_latents(x.float(), h_lat * 8, w_lat * 8)  # (B, C, h, w)
    img = lat[0].mean(dim=0).cpu().numpy()
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / max(hi - lo, 1e-9) * 255.0


def linear_schedule(steps: int) -> list:
    """The benches' ``steps`` + 1 timesteps, linear from 1 to 0 in fp32."""
    return np.linspace(1.0, 0.0, steps + 1, dtype=np.float32).tolist()


def make_inputs(cfg: FluxStatic, width: int, height: int, txt_len: int, device):
    """bf16 latent noise, text and vector conditioning drawn from ``INPUT_SEED`` on
    ``device``; → (dict for :func:`run_denoise`, h_lat, w_lat)."""
    gen = torch.Generator(device=device).manual_seed(INPUT_SEED)
    h_lat, w_lat = 2 * -(-height // 16), 2 * -(-width // 16)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    inputs = dict(
        img=randn(1, (h_lat // 2) * (w_lat // 2), cfg.in_channels),
        img_ids=make_img_ids(h_lat, w_lat, 1, device=device),
        txt=randn(1, txt_len, cfg.context_in_dim),
        txt_ids=make_txt_ids(txt_len, 1, device=device),
        vec=randn(1, cfg.vec_in_dim),
    )
    return inputs, h_lat, w_lat


def tier_cfg(cfg: FluxStatic, tier: Optional[str]) -> FluxStatic:
    """The model config a tier runs under: ``fp8`` is ``_scaled_mm`` without fast
    accumulation, every other tier the serving default."""
    return dataclasses.replace(cfg, fp8_fast_accum=tier != "fp8")


def draw_model(cfg: FluxStatic, device, seed: int = WEIGHT_SEED, tier: Optional[str] = None):
    """flux weights from ``seed`` on ``device``, bf16, or quantized leaf by leaf to
    ``tier``: the same draws either way, so a tier is the quantization of the bf16 tree."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaf_fn = None
    if tier is not None:
        leaf_fn = quant_tier("fp8" if tier in FP8_TIERS else tier)
    return init_flux_params(cfg, gen, torch.bfloat16, leaf_fn=leaf_fn)


def calibrate(model, cfg: FluxStatic, inputs: Dict[str, torch.Tensor]) -> None:
    """One amax pass at t = 0.5 and the input scales written from it, in place (JAX
    bench_fidelity.py:327-331): the calibration protocol's steady state."""
    x = inputs
    t = torch.full((1,), 0.5, device=x["img"].device)
    g = torch.full((1,), GUIDANCE, device=x["img"].device)
    with torch.inference_mode():  # as a pipeline's calibration writes its scales
        _, amaxes = flux_apply(model, cfg, x["img"], x["img_ids"], x["txt"], x["txt_ids"], t, x["vec"], g,
                               collect_amax=True)
        apply_input_scales(model, merge_amax(None, amaxes))


def run_denoise(model, cfg: FluxStatic, inputs: Dict[str, torch.Tensor], timesteps, cache=None,
                compiled: Optional[Compiled] = None):
    """The denoise loop on a copy of the inputs' latent, its blocks and extras compiled
    as ``compiled`` says (``sampling.denoise``); → (latents, seconds, model
    evaluations). Seconds are the host clock around the loop, ending in a device sync."""
    x = inputs
    stats: dict = {}
    start = time.perf_counter()
    with torch.inference_mode():  # as a request runs it: a serving forward compiles only without grad
        out = denoise(model, cfg, x["img"].clone(), x["img_ids"], x["txt"], x["txt_ids"], x["vec"],
                      timesteps, GUIDANCE, cache=cache, stats=stats, compiled=compiled)
    _sync(out)
    return out, time.perf_counter() - start, stats.get("model_evals", len(timesteps) - 1)


def device_fields(device) -> dict:
    """``device`` and ``card`` of a result line: the card's name and nvidia-smi's name
    and power limit, or "cpu" and None."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "card": None}
    from .ablate_attention import card_line

    return {"device": torch.cuda.get_device_name(device), "card": card_line()}


def run(params: FluxParams, device, width: int = 1024, height: int = 1024, txt_len: int = 512,
        steps: int = 28, tiers: Sequence[str] = TIERS, compiled: Optional[Compiled] = None) -> dict:
    """The gate: bf16 ground truth (eager), then each tier, its denoise compiled as
    ``compiled`` says (the served path: ``Compiled(True, True)``); → the report (the
    JSON line)."""
    cfg = FluxStatic.from_params(params)
    inputs, h_lat, w_lat = make_inputs(cfg, width, height, txt_len, device)
    timesteps = linear_schedule(steps)
    timings: Dict[str, float] = {}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    start = time.perf_counter()
    model = draw_model(cfg, device)
    _sync(inputs["img"])
    timings["bf16_draw_s"] = time.perf_counter() - start
    out, timings["bf16_denoise_s"], _ = run_denoise(model, cfg, inputs, timesteps)
    ref = latent_image(out, h_lat, w_lat)
    del model, out

    detail, db = {}, {}
    for tier in tiers:
        start = time.perf_counter()
        model = draw_model(cfg, device, tier=tier)
        run_cfg = tier_cfg(cfg, tier)
        calibrate(model, run_cfg, inputs)
        _sync(inputs["img"])
        timings[f"{tier}_draw_calibrate_s"] = time.perf_counter() - start
        out, timings[f"{tier}_denoise_s"], _ = run_denoise(model, run_cfg, inputs, timesteps, compiled=compiled)
        img = latent_image(out, h_lat, w_lat)
        detail[tier], db[tier] = ssim(ref, img), psnr(ref, img)
        del model, out

    gated = [detail[t] for t in FP8_TIERS if t in detail] or list(detail.values())
    report = {
        "metric": (f"SSIM of latent_image vs the bf16 ground truth, flux-dev ({cfg.hidden_size} hidden, "
                   f"{cfg.depth}+{cfg.depth_single_blocks} blocks) @{width}x{height}/{steps} steps, "
                   f"weights from seed {WEIGHT_SEED}"),
        "value": detail.get("fp8_fast_accum", min(gated)),
        "unit": "ssim",
        "gate": f">={GATE}",
        "pass": bool(min(gated) >= GATE),
        "detail": detail,
        "psnr": db,
        "timings": timings,
        "compiled": (compiled or Compiled())._asdict(),
        **device_fields(device),
    }
    if on_card:
        report["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=None, help="Euler steps (28; 4 with --tiny)")
    ap.add_argument("--tiers", default=",".join(TIERS), help="comma-separated subset of " + ",".join(TIERS))
    ap.add_argument("--tiny", action="store_true", help="hidden 64, 128x128, on the CPU (plumbing only)")
    args = ap.parse_args(argv)
    tiers = [t for t in args.tiers.split(",") if t]
    unknown = set(tiers) - set(TIERS)
    if unknown:
        ap.error(f"unknown tiers {sorted(unknown)}")
    if args.tiny:
        report = run(TINY, "cpu", 128, 128, 16, args.steps or 4, tiers)
    else:
        from .ops.attention import cuda_device

        report = run(FLUX_DEV, cuda_device(), steps=args.steps or 28, tiers=tiers)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
