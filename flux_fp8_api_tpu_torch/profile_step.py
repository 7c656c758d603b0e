"""Where a denoise step's device time goes, on the card: ``torch.profiler`` over a few
steps of the served pipeline, kernel time summed by kind.

    python -m flux_fp8_api_tpu_torch.profile_step [--config configs/config-dev.json]
        [--width 1024] [--height 1024] [--steps 4]
    python -m flux_fp8_api_tpu_torch.profile_step --train int8 [--width 512 --height 512 --steps 2]

Builds the pipeline from the config (``compile()`` calibrates and warms it), prepares
one prompt at the given size, runs two warm denoise steps, then profiles ``--steps``
steps of ``sampling.denoise`` between two device syncs. The steps run as the pipeline
serves them: compiled where the config sets ``compile_blocks`` / ``compile_extras``
(the warm steps compile the bucket), eagerly where it does not. With ``--train KIND`` it
profiles ``bench_train``'s QLoRA step instead (flux-dev at full size from a seed, the
KIND base, rank 16, batch 1, two warm steps first). Prints the card line, one
markdown table (ms per step and share of device-busy time for each kind of kernel)
and one JSON line with the same numbers, the busy and wall ms per step and the idle
share. Raises without a CUDA device, or when the profiler records no device kernel.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

from .ablate_attention import card_line
from .ops.attention import cuda_device
from .pipeline import FluxPipeline
from .sampling import denoise

# (kind, substrings of a kernel's name), first match wins
KINDS = (
    ("attention, K1 (qknorm_attention)", ("qknorm_attention",)),
    ("fused by inductor (triton_*)", ("triton_",)),
    ("rope pass backward (rope_rotate, backward build)", ("rope_rotate_kernel<true>",)),
    ("rope pass (rope_rotate)", ("rope_rotate",)),
    ("attention, SDPA forward and backward (flash / cuDNN / efficient)", ("flash", "fmha", "sdpa", "cudnn")),
    ("optimizer and clip (foreach)", ("multi_tensor",)),
    ("GEMMs (cuBLAS/cuBLASLt)", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
    ("norms and reductions", ("reduce", "norm", "softmax")),
    ("copies and casts (the fp8 activation cast among them)", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)

TOP = 12  # kernels listed by name, the longest first


def activities(device: torch.device) -> list:
    """The profiler's activities for work on ``device``: the host, and the card's
    kernels when it is one."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def trace(log_dir: str, device: torch.device):
    """A ``torch.profiler`` context that writes its trace (TensorBoard's layout, a
    Chrome trace JSON) into ``log_dir`` when it exits: ``FluxPipeline.profile``."""
    from torch.profiler import profile as torch_profile
    from torch.profiler import tensorboard_trace_handler

    return torch_profile(activities=activities(device), on_trace_ready=tensorboard_trace_handler(str(log_dir)))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile(pipe: FluxPipeline, width: int, height: int, steps: int, prompt: str = "a photo of a red house") -> dict:
    """Profile ``steps`` denoise steps at width × height; → the per-step breakdown."""
    from torch.profiler import profile as torch_profile

    gen, _ = pipe.set_seed(5)
    with torch.inference_mode():
        img, timesteps = pipe.preprocess_latent(None, height, width, steps + 2, 1.0, gen, 1)
        img, img_ids, vec, txt, txt_ids = pipe.prepare(img, prompt)
        args = (pipe.model_params, pipe.model_cfg)
        img = denoise(*args, img, img_ids, txt, txt_ids, vec, timesteps[:3], 3.5, compiled=pipe.compiled)  # warm
        torch.cuda.synchronize()
        with torch_profile(activities=activities(pipe.device_flux)) as prof:
            t = time.perf_counter()
            img = denoise(*args, img, img_ids, txt, txt_ids, vec, timesteps[2:], 3.5, compiled=pipe.compiled)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    return _breakdown(prof, steps, wall_ms, width=width, height=height, compiled=pipe.compiled._asdict())


def profile_train(kind: str, width: int, height: int, steps: int) -> dict:
    """Profile ``steps`` QLoRA train steps of ``bench_train``'s set-up; → the per-step
    breakdown."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from .bench_fidelity import FLUX_DEV
    from .bench_train import build

    _, base, adapters, opt, step, data, gen = build(kind, width, height, 16, 1, FLUX_DEV, cuda_device())
    for i in range(2):  # warm
        adapters, opt, loss = step(adapters, opt, base, data, gen(3 + i))
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(steps):
            adapters, opt, loss = step(adapters, opt, base, data, gen(5 + i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    return _breakdown(prof, steps, wall_ms, width=width, height=height, train=kind)


def _breakdown(prof, steps: int, wall_ms: float, **fields) -> dict:
    by_kind, by_name = defaultdict(float), defaultdict(float)
    kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            by_kind[kind_of(ev.name)] += ms
            by_name[ev.name] += ms
            kernels += 1
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    busy = sum(by_kind.values())
    return {
        **fields, "steps": steps,
        "ms_per_step": {k: v / steps for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "busy_ms_per_step": busy / steps, "wall_ms_per_step": wall_ms / steps,
        "idle_share": 1.0 - busy / wall_ms, "kernels_per_step": kernels / steps,
        "top_kernels_ms_per_step": {k[:120]: v / steps
                                    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]},
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=str(Path(__file__).resolve().parents[1] / "configs" / "config-dev.json"))
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--train", choices=("int8", "fp8", "int4"), default=None,
                    help="profile the QLoRA train step on this base instead of denoise steps")
    a = ap.parse_args(argv)
    cuda_device()
    if a.train:
        r = profile_train(a.train, a.width, a.height, a.steps)
        what = f"QLoRA train step, flux-dev {a.train} base, rank 16"
    else:
        pipe = FluxPipeline.load_pipeline_from_config_path(a.config)
        r = profile(pipe, a.width, a.height, a.steps)
        what = Path(a.config).name
    busy = r["busy_ms_per_step"]
    print(f"card: {card_line()} | {what} {a.width}x{a.height}, {a.steps} profiled steps", file=sys.stderr)
    print("| kind | ms/step | share of device busy |\n| --- | --- | --- |")
    for kind, ms in r["ms_per_step"].items():
        print(f"| {kind} | {ms:.3f} | {100 * ms / busy:.1f}% |")
    print(f"| device busy / wall | {busy:.3f} / {r['wall_ms_per_step']:.3f} | idle share "
          f"{100 * r['idle_share']:.1f}%, {r['kernels_per_step']:.0f} kernels per step |")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()
