"""Step-cache sweep on the card: the speed and fidelity of each ``CacheConfig`` policy
(the port's counterpart of the root ``bench_cache.py``).

    python -m flux_fp8_api_tpu_torch.bench_cache [--width 1024 --height 1024 --steps 28]
    python -m flux_fp8_api_tpu_torch.bench_cache --tiny    # hidden 64 on the CPU
    BENCH_POLICIES=interval3,dynamic.4 python -m ...       # a subset of POLICIES

flux-dev at full width and depth, fp8 tier, weights drawn from a seed and calibrated
with one amax pass (``bench_fidelity``); inputs from a seed, a linear 1 → 0 schedule.
The uncached loop runs once to warm and once timed; each policy then runs once, timed.
One JSON line per run: ``evals`` (model evaluations), ``seconds`` (host clock around the
loop, ending in a device sync), ``it_per_s_effective`` (schedule steps / seconds: a
skipped step costs a few elementwise passes) and ``ssim_vs_uncached`` (the SSIM of
``bench_fidelity.latent_image`` against the uncached output of the same weights, the
error of the cache alone); then the summary line: the fastest policy at SSIM ≥ 0.95,
its speed-up over uncached, the card. Random weights: ``interval`` counts do not depend
on them, ``dynamic`` thresholds would need tuning again on a checkpoint.

:func:`run` sweeps a model the caller already holds (``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional, Tuple

import torch

from .bench_fidelity import (
    FLUX_DEV, TINY, calibrate, device_fields, draw_model, latent_image, linear_schedule, make_inputs,
    run_denoise,
)
from .models.flux import Compiled, FluxStatic
from .sampling import CacheConfig
from .utils.fidelity import ssim

POLICIES: List[Tuple[str, CacheConfig]] = [
    ("interval2", CacheConfig(mode="interval", interval=2, warmup=2, tail=1)),
    ("interval3", CacheConfig(mode="interval", interval=3, warmup=2, tail=1)),
    ("dynamic.2", CacheConfig(mode="dynamic", threshold=0.2, warmup=2, tail=1)),
    ("dynamic.4", CacheConfig(mode="dynamic", threshold=0.4, warmup=2, tail=1)),
    ("interval3+o1", CacheConfig(mode="interval", interval=3, warmup=2, tail=1, order=1)),
    ("interval4", CacheConfig(mode="interval", interval=4, warmup=2, tail=1)),
    ("interval4+o1", CacheConfig(mode="interval", interval=4, warmup=2, tail=1, order=1)),
    ("interval5+o1", CacheConfig(mode="interval", interval=5, warmup=2, tail=1, order=1)),
    ("dynamic.4+o1", CacheConfig(mode="dynamic", threshold=0.4, warmup=2, tail=1, order=1)),
]


def selected_policies() -> List[Tuple[str, CacheConfig]]:
    """POLICIES, or the ones ``BENCH_POLICIES`` (comma-separated names) keeps."""
    only = os.environ.get("BENCH_POLICIES")
    if not only:
        return list(POLICIES)
    names = {s.strip() for s in only.split(",")}
    return [p for p in POLICIES if p[0] in names]


def run(model, cfg: FluxStatic, width: int = 1024, height: int = 1024, steps: int = 28,
        txt_len: int = 512, compiled: Optional[Compiled] = None) -> dict:
    """Sweep :func:`selected_policies` on ``model``, each denoise compiled as
    ``compiled`` says (``sampling.denoise``), printing one JSON line per run; → the
    summary (not printed)."""
    device = next(model.buffers()).device
    inputs, h_lat, w_lat = make_inputs(cfg, width, height, txt_len, device)
    timesteps = linear_schedule(steps)

    run_denoise(model, cfg, inputs, timesteps, compiled=compiled)  # warm: the first use of each shape
    out, base_s, _ = run_denoise(model, cfg, inputs, timesteps, compiled=compiled)
    ref = latent_image(out, h_lat, w_lat)
    base_its = steps / base_s
    print(json.dumps({"policy": "uncached", "evals": steps, "seconds": base_s,
                      "it_per_s_effective": base_its, "ssim_vs_uncached": 1.0}), flush=True)

    rows = []
    for name, cache in selected_policies():
        out, seconds, evals = run_denoise(model, cfg, inputs, timesteps, cache, compiled)
        row = {"policy": name, "evals": evals, "seconds": seconds, "it_per_s_effective": steps / seconds,
               "ssim_vs_uncached": ssim(ref, latent_image(out, h_lat, w_lat))}
        rows.append(row)
        print(json.dumps(row), flush=True)

    best = max((r for r in rows if r["ssim_vs_uncached"] >= 0.95),
               key=lambda r: r["it_per_s_effective"], default=None)
    return {
        "metric": f"step-cache best @{width}x{height} ({steps} steps, ssim>=0.95)",
        "value": best["it_per_s_effective"] if best else None,
        "unit": "it/s-effective",
        "vs_uncached": best["it_per_s_effective"] / base_its if best else None,
        "best": best["policy"] if best else None,
        "detail": {"uncached_it_per_s": base_its, "rows": rows},
        **device_fields(device),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--tiny", action="store_true", help="hidden 64, 256x256, 8 steps, on the CPU (plumbing only)")
    args = ap.parse_args(argv)
    if args.tiny:
        params, device, txt_len = TINY, torch.device("cpu"), 16
        args.width = args.height = 256
        args.steps = 8
    else:
        from .ops.attention import cuda_device

        params, device, txt_len = FLUX_DEV, cuda_device(), 512
    cfg = FluxStatic.from_params(params)
    model = draw_model(cfg, device, tier="fp8_fast_accum")
    calibrate(model, cfg, make_inputs(cfg, args.width, args.height, txt_len, device)[0])
    summary = run(model, cfg, args.width, args.height, args.steps, txt_len)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
