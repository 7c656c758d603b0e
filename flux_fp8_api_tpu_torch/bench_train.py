"""QLoRA training throughput at flux-dev's full size on the card (the port's
counterpart of the root ``bench_train.py``).

    python -m flux_fp8_api_tpu_torch.bench_train [int8|fp8|int4] [width] [height] [rank] [batch]
    python -m flux_fp8_api_tpu_torch.bench_train --tiny    # hidden 64 on the CPU

flux-dev (hidden 3072, 19 + 38 blocks) is drawn from a seed on the card leaf by leaf at
the chosen tier, rank-r adapters go on ``lora.DEFAULT_ADAPTER_TARGETS``, and the
adapter step (``parallel.train.make_lora_train_step``: AdamW, clip 1.0, remat, the
dequantize path, the rope pass and SDPA) takes one warm step on a batch of random
latents with 512 text tokens, then ``STEPS`` timed steps, each ending in a read of its
loss (a device sync). Prints one JSON line in the root bench's shape: ``metric`` (which
names the card), ``value`` (seconds per step), ``unit``, and ``detail`` with steps/s,
the first step's seconds, the final loss, peak device memory and the card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .bench_fidelity import FLUX_DEV, TINY, device_fields
from .lora import adapter_tensors, init_lora_adapters
from .models.flux import FluxStatic, init_flux_params, quant_tier
from .parallel.train import adamw, make_dummy_batch, make_lora_train_step
from .pipeline import _sync

STEPS = 6
TXT_LEN = 512


def build(kind: str, width: int, height: int, rank: int, batch: int, params, device, txt_len: int = TXT_LEN):
    """The benched step, ready to run: → (cfg, base, adapters, opt, step, batch, gen)
    with ``gen(seed)`` a generator on ``device``."""
    cfg = FluxStatic.from_params(params, use_pallas=False)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)  # noqa: E731
    model = init_flux_params(cfg, gen(0), leaf_fn=quant_tier(kind))
    adapters = init_lora_adapters(model, rank, gen(1))
    init, step = make_lora_train_step(cfg, adamw(1e-4), max_grad_norm=1.0)
    data = make_dummy_batch(cfg, batch, height // 8, width // 8, txt_len, gen(2))
    return cfg, model, adapters, init(adapters), step, data, gen


def run(kind: str = "int8", width: int = 512, height: int = 512, rank: int = 16, batch: int = 1,
        params=FLUX_DEV, device=None, steps: int = STEPS, txt_len: int = TXT_LEN) -> dict:
    """Draw the base, build the adapter step, take one warm step and ``steps`` timed
    ones; → the report (the JSON line)."""
    if device is None:
        from .ops.attention import cuda_device

        device = cuda_device()
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, model, adapters, opt, step, data, gen = build(kind, width, height, rank, batch, params, device, txt_len)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    start = time.perf_counter()
    adapters, opt, loss = step(adapters, opt, model, data, gen(3))
    float(loss)
    first = time.perf_counter() - start
    start = time.perf_counter()
    for i in range(steps):
        adapters, opt, loss = step(adapters, opt, model, data, gen(4 + i))
        last = float(loss)
    _sync(loss)
    dt = (time.perf_counter() - start) / steps
    fields = device_fields(device)
    return {
        "metric": (f"qlora train step s @{width}x{height} flux-dev {kind} base rank{rank} bs={batch} "
                   f"({cfg.hidden_size} hidden, {cfg.depth}+{cfg.depth_single_blocks} blocks; {fields['device']})"),
        "value": dt,
        "unit": "s/step",
        "detail": {
            "steps_per_s": 1.0 / dt,
            "first_step_s": first,
            "final_loss": last,
            "adapter_params": sum(p.numel() for p in adapter_tensors(adapters)),
            "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None,
            **fields,
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", nargs="?", default="int8", choices=("int8", "fp8", "int4"))
    ap.add_argument("width", nargs="?", type=int, default=512)
    ap.add_argument("height", nargs="?", type=int, default=512)
    ap.add_argument("rank", nargs="?", type=int, default=16)
    ap.add_argument("batch", nargs="?", type=int, default=1)
    ap.add_argument("--tiny", action="store_true", help="hidden 64, 2 steps, on the CPU (plumbing only)")
    args = ap.parse_args(argv)
    if args.tiny:
        report = run(args.kind, 64, 64, 2, args.batch, TINY, "cpu", steps=2, txt_len=8)
    else:
        report = run(args.kind, args.width, args.height, args.rank, args.batch)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
