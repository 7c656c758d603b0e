#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure (non-zero exit, no result line):

1. card: name and power limit;
2. build: the attention kernel library, from this checkout's sources, with nvcc;
3. kernel: the CUDA attention kernel against its plain PyTorch version at flux-dev's
   shapes (24 heads × 128; L = 4608 and 3392, an Lq ≠ Lkv call, and rows whose logits
   all underflow), with the time of each;
4. guard rail and ablation: the attention kernel's stats and ablate builds and the
   bare two-dot kernel against their plain versions at L = 4608 and 3392, with their
   times (the stats build's output must equal the serving build's bit for bit); then,
   with the launch counts at 0, the path itself: ``qknorm_attention_checked`` passing
   qk-normed inputs and raising on inputs scaled ×60 and on a NaN, and
   ``python -m flux_fp8_api_tpu_torch.ablate_attention 4608 3392 2816`` run in this
   process, whose rows are printed;
5. fp8 linear: ``torch._scaled_mm`` against its plain fp32 version at the qkv shape;
6. model: a small flux model (two heads of 128) on the card against the same model
   on the CPU, where every op takes its plain version;
7. server: the pipeline from ``configs/config-dev.json`` (full flux-dev width, random
   weights) calibrated and warmed by ``compile()``, serving three POST /generate
   requests through ``PipelineServer``; the attention kernel's launch count must be
   57 per model evaluation.

The last lines are the card line, one JSON object describing each kernel build (its
launches counted in the path of phase 7 or 4, its time and error from phase 3 or 4),
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config-dev.json"

# |kernel − plain| ≤ ATOL + RTOL·|plain|: both round p to bf16 the same way, so what is
# left is fp32 summation order inside the products and the final bf16 rounding of the
# output (one bf16 ulp is 2^-8 relative).
K1_ATOL, K1_RTOL = 1e-3, 1e-2
# stats build: its max |logit| against the plain version's, relative (summation order
# of the fp32 logits).
K1S_MAX_RTOL = 1e-3
# ablate build: out = acc·1e30 (den < 0 is clamped), with elements near 0 wherever
# Σ p·v cancels, so ‖out − plain‖ / ‖plain‖ in fp64; p ≈ −20 rounds to bf16 in steps
# of 0.125 and a logit summed in another order can cross a step.
K1A_REL_TOL = 1e-2
# bare two-dot: max|out − plain| / max|plain|; bf16 logits and output on both sides.
K2_REL_TOL = 1e-2
# fp8 linear: max|out − plain| / max|plain|; fast accumulation and the bf16 output
# each cost about 2^-8.
FP8_REL_TOL = 2e-2
# small flux model, card vs CPU: ‖a − b‖ / ‖b‖ over the prediction. The two sides
# round to bf16 in different places, and where that moves an activation across an
# e5m2 rounding boundary (2 mantissa bits) the element differs by up to 25%, so the
# check is on the norm, not the worst element.
MODEL_REL_TOL = 5e-2


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rope_tables(h_img: int, w_img: int):
    """flux-dev's rope tables for an h_img × w_img image and 512 text tokens, on the card."""
    import torch

    from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
    from flux_fp8_api_tpu_torch.ops.rope import embed_nd_cos_sin

    dev = torch.device("cuda")
    ids = torch.cat([make_txt_ids(512, 1, dev), make_img_ids(h_img // 8, w_img // 8, 1, dev)], 1)
    cos, sin = embed_nd_cos_sin(ids, (16, 56, 56), 10_000)
    return cos[0].contiguous(), sin[0].contiguous()


def phase_kernel(card: str):
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import qknorm_attention, qknorm_attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    heads, d = 24, 128
    scale = d**-0.5

    def normed(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)

    worst = 0.0
    times = {}

    def check(name, q, k, v, sm_scale, **rope):
        nonlocal worst
        out = qknorm_attention(q, k, v, sm_scale, **rope)
        ref = qknorm_attention_ref(q, k, v, sm_scale, **rope)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        if not torch.isfinite(o).all():
            fail("kernel", f"{name}: non-finite output")
        err = float((o - r).abs().max())
        bad = (o - r).abs() > K1_ATOL + K1_RTOL * r.abs()
        print(f"[{card}] K1 {name}: shape {tuple(q.shape)}x{tuple(k.shape)} max_abs_err {err:.3e} "
              f"(tol {K1_ATOL} + {K1_RTOL}*|plain|) max|plain| {float(r.abs().max()):.3e}", flush=True)
        if bool(bad.any()):
            fail("kernel", f"{name}: {int(bad.sum())} elements outside tolerance, max_abs_err {err}")
        worst = max(worst, err)
        return out

    for h_img, w_img in ((1024, 1024), (720, 1024)):
        l = 512 + (h_img // 16) * (w_img // 16)
        q, k, v = normed(heads, l, d), normed(heads, l, d), torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
        cos, sin = rope_tables(h_img, w_img)
        check(f"L={l} rope", q, k, v, scale, cos=cos, sin=sin)
        ms = cuda_time_ms(lambda: qknorm_attention(q, k, v, scale, cos=cos, sin=sin), 20)
        plain_ms = cuda_time_ms(lambda: qknorm_attention_ref(q, k, v, scale, cos=cos, sin=sin), 5)
        flops = 4 * heads * l * l * d
        times[l] = (ms, plain_ms)
        print(f"[{card}] K1 L={l}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms", flush=True)
        if l == 4608:
            # Lq != Lkv: a q shard of 1536 rows against the full sequence
            check("Lq=1536 Lkv=4608 rope", q[:, :1536], k, v, scale, cos=cos, sin=sin,
                  cos_q=cos[:1536].contiguous(), sin_q=sin[:1536].contiguous())
            check("L=4608 no rope", q, k, v, scale)
    # every logit -90 with SHIFT 20: exp underflows to 0 in f32, den is 0 → out must be 0
    l = 3392
    q = torch.ones(heads, l, d, device=dev, dtype=torch.bfloat16)
    k = torch.full((heads, l, d), -90.0 / d, device=dev, dtype=torch.bfloat16)
    v = torch.ones(heads, l, d, device=dev, dtype=torch.bfloat16)
    out = check("all-underflow", q, k, v, 1.0)
    if bool(out.float().abs().max() != 0):
        fail("kernel", "all-underflow rows must be exactly 0")
    return worst, times


def phase_guard_ablation(card: str):
    """The stats and ablate builds and the bare two-dot against their plain versions,
    then the guard-rail and ablation path with the launch counts at 0."""
    import torch

    from flux_fp8_api_tpu_torch import ablate_attention
    from flux_fp8_api_tpu_torch.ablate_attention import bare_two_dot, bare_two_dot_ref
    from flux_fp8_api_tpu_torch.ops.attention_kernel import (
        LAUNCHES, qknorm_attention, qknorm_attention_checked, qknorm_attention_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    heads, d = 24, 128
    scale = d**-0.5
    results = {}  # build → {"max_abs_err", "ms", "plain_ms"} at L = 4608

    def normed(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)

    def record(build, l, err, ms, plain_ms, what):
        print(f"[{card}] {build} L={l}: {what}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        if l == 4608:
            results[build] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    for h_img, w_img in ((1024, 1024), (720, 1024)):
        l = 512 + (h_img // 16) * (w_img // 16)
        q, k = normed(heads, l, d), normed(heads, l, d)
        v = torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
        cos, sin = rope_tables(h_img, w_img)
        rope = dict(cos=cos, sin=sin)

        out, m = qknorm_attention(q, k, v, scale, return_max_logit=True, **rope)
        serving = qknorm_attention(q, k, v, scale, **rope)
        ref, ref_m = qknorm_attention_ref(q, k, v, scale, return_max_logit=True, **rope)
        torch.cuda.synchronize()
        if not torch.equal(out, serving):
            fail("guard", f"L={l}: the stats build's output differs from the serving build's")
        m_rel = abs(float(m) - float(ref_m)) / float(ref_m)
        if not m_rel <= K1S_MAX_RTOL:
            fail("guard", f"L={l}: max logit {float(m)} vs plain {float(ref_m)}")
        o, r = out.float(), ref.float()
        err = float((o - r).abs().max())
        if bool(((o - r).abs() > K1_ATOL + K1_RTOL * r.abs()).any()):
            fail("guard", f"L={l}: stats build outside tolerance, max_abs_err {err}")
        record("qknorm_attention_stats", l, err,
               cuda_time_ms(lambda: qknorm_attention(q, k, v, scale, return_max_logit=True, **rope), 20),
               cuda_time_ms(lambda: qknorm_attention_ref(q, k, v, scale, return_max_logit=True, **rope), 5),
               f"output bit-identical to the serving build; max|logit| {float(m):.6f} vs plain "
               f"{float(ref_m):.6f} (rel {m_rel:.2e}, tol {K1S_MAX_RTOL}); max_abs_err {err:.3e}")

        out = qknorm_attention(q, k, v, scale, ablate_exp=True, **rope)
        ref = qknorm_attention_ref(q, k, v, scale, ablate_exp=True, **rope)
        o, r = out.double(), ref.double()
        rel = float((o - r).norm() / r.norm())
        if not (bool(torch.isfinite(o).all()) and rel <= K1A_REL_TOL):
            fail("guard", f"L={l}: ablate build relative error {rel}")
        record("qknorm_attention_ablate_exp", l, float((o - r).abs().max()),
               cuda_time_ms(lambda: qknorm_attention(q, k, v, scale, ablate_exp=True, **rope), 20),
               cuda_time_ms(lambda: qknorm_attention_ref(q, k, v, scale, ablate_exp=True, **rope), 5),
               f"norm_rel_err {rel:.3e} (tol {K1A_REL_TOL}) on outputs up to {float(r.abs().max()):.3e}")

        qb, kb, vb = (torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
        out, ref = bare_two_dot(qb, kb, vb).float(), bare_two_dot_ref(qb, kb, vb).float()
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= K2_REL_TOL:
            fail("guard", f"L={l}: bare two-dot relative error {rel}")
        record("bare_two_dot", l, err,
               cuda_time_ms(lambda: bare_two_dot(qb, kb, vb), 20),
               cuda_time_ms(lambda: bare_two_dot_ref(qb, kb, vb), 5),
               f"max_abs_err {err:.3e} = {rel:.2e} of max|plain| (tol {K2_REL_TOL})")

    # the path: the guard rail a user calls after loading weights, and the ablation tool
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    l = 4608
    q, k = normed(heads, l, d), normed(heads, l, d)
    v = torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_tables(1024, 1024)
    out = qknorm_attention_checked(q, k, v, scale, cos=cos, sin=sin)
    if not bool(torch.isfinite(out.float()).all()):
        fail("guard", "qknorm_attention_checked: non-finite output on qk-normed inputs")
    q_nan = q.clone()
    q_nan[7, 1234, 56] = float("nan")
    for name, qq, kk in (("x60", q * 60, k * 60), ("NaN", q_nan, k)):
        try:
            qknorm_attention_checked(qq, kk, v, scale, cos=cos, sin=sin)
        except FloatingPointError as e:
            print(f"[{card}] qknorm_attention_checked raises on {name} inputs: {e}", flush=True)
        else:
            fail("guard", f"qknorm_attention_checked passed {name} inputs")
    rows = ablate_attention.main(["4608", "3392", "2816"])
    launches = dict(LAUNCHES)
    for build in ("qknorm_attention_stats", "qknorm_attention_ablate_exp", "bare_two_dot"):
        if launches[build] == 0:
            fail("guard", f"{build} was not launched on the guard-rail and ablation path")
    for r in rows:
        if not all(x > 0 for x in (*r["ms"].values(), r["bare_two_dot_ms"])):
            fail("guard", f"ablation row with a non-positive time: {r}")
    print(f"[{card}] guard-rail and ablation path launches: {launches}", flush=True)
    return results, launches


def phase_fp8_linear(card: str):
    import torch

    from flux_fp8_api_tpu_torch.ops.quant import (
        F8_INPUT_MAX, INPUT_F8_DTYPE, fp8_linear_ref, linear_apply, quantize_linear_fp8,
        to_fp8_saturated, with_input_scale,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn(4608, 3072, generator=gen, device=dev).to(torch.bfloat16)
    w = ((torch.rand(9216, 3072, generator=gen, device=dev) * 2 - 1) * (3 / 3072) ** 0.5).to(torch.bfloat16)
    b = ((torch.rand(9216, generator=gen, device=dev) * 2 - 1) / 3072**0.5).to(torch.bfloat16)
    lin = with_input_scale(quantize_linear_fp8(w, b), x.abs().max().float())
    for fast in (True, False):
        out, _ = linear_apply(lin, x, torch.bfloat16, fast_accum=fast)
        x8 = to_fp8_saturated(x.float(), lin.in_scale, F8_INPUT_MAX).to(INPUT_F8_DTYPE)
        ref = fp8_linear_ref(lin, x8, torch.float32)
        rel = float((out.float() - ref).abs().max() / ref.abs().max())
        ms = cuda_time_ms(lambda: linear_apply(lin, x, torch.bfloat16, fast_accum=fast), 20)
        print(f"[{card}] fp8 linear x(4608,3072) W(9216,3072) use_fast_accum={fast}: "
              f"max_rel_err {rel:.3e} (tol {FP8_REL_TOL}), {ms:.4f} ms incl. activation cast", flush=True)
        if not rel <= FP8_REL_TOL:
            fail("fp8", f"use_fast_accum={fast}: relative error {rel}")


def phase_model(card: str):
    """A two-head-of-128 flux model, fp8 tier, calibrated: the card (CUDA attention
    kernel, _scaled_mm) against the CPU (every op's plain version)."""
    import torch

    from flux_fp8_api_tpu_torch.calibration import apply_input_scales
    from flux_fp8_api_tpu_torch.models.flux import FluxStatic, flux_apply, init_flux_params, quantize_flux_tree
    from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
    from flux_fp8_api_tpu_torch.utils.config import FluxParams

    params = FluxParams(in_channels=64, vec_in_dim=64, context_in_dim=128, hidden_size=256,
                        mlp_ratio=4.0, num_heads=2, depth=1, depth_single_blocks=1,
                        axes_dim=[16, 56, 56], theta=10_000, qkv_bias=True, guidance_embed=True)
    cfg = FluxStatic.from_params(params)
    gen = torch.Generator().manual_seed(2)
    cpu_model = quantize_flux_tree(init_flux_params(cfg, gen, torch.bfloat16))
    x = dict(
        img=torch.randn(1, 256, 64, generator=gen), img_ids=make_img_ids(32, 32, 1),
        txt=torch.randn(1, 40, 128, generator=gen), txt_ids=make_txt_ids(40, 1),
        timesteps=torch.full((1,), 0.5), y=torch.randn(1, 64, generator=gen),
        guidance=torch.full((1,), 3.5),
    )
    _, amaxes = flux_apply(cpu_model, cfg, **x, collect_amax=True)
    apply_input_scales(cpu_model, amaxes)
    ref = flux_apply(cpu_model, cfg, **x).float()
    gpu_model = cpu_model.to("cuda")
    out = flux_apply(gpu_model, cfg, **{k: v.cuda() for k, v in x.items()}).float().cpu()
    rel = float((out - ref).norm() / ref.norm())
    worst = float((out - ref).abs().max() / ref.abs().max())
    print(f"[{card}] small flux model (hidden 256, 2x128 heads, fp8) card vs CPU: "
          f"norm_rel_err {rel:.3e} (tol {MODEL_REL_TOL}), max_rel_err {worst:.3e}", flush=True)
    if not (torch.isfinite(out).all() and rel <= MODEL_REL_TOL):
        fail("model", f"card vs CPU relative error {rel}")


def post(url: str, body: dict):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, dict(resp.headers), resp.read()


def phase_server(card: str):
    import torch
    from PIL import Image

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.server import PipelineServer

    requests = [  # (body, expected (width, height), steps)
        ({"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
          "num_steps": 28, "seed": 11}, (1024, 1024), 28),
        ({"prompt": "a beautiful cat in the sun", "seed": 12}, (720, 1024), 24),
        ({"prompt": "a blue sky", "width": 512, "height": 512, "num_steps": 20, "seed": 13},
         (512, 512), 20),
    ]
    LAUNCHES["qknorm_attention"] = 0
    t0 = time.perf_counter()
    pipe = FluxPipeline.load_pipeline_from_config_path(str(CONFIG))  # compile() runs here
    load_s = time.perf_counter() - t0
    cfg = pipe.model_cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    warm_evals = pipe.config.num_scale_trials + (pipe.config.warmup_steps or 24)
    if LAUNCHES["qknorm_attention"] != blocks * warm_evals:
        fail("server", f"compile(): {LAUNCHES['qknorm_attention']} kernel launches, "
                       f"expected {blocks} x {warm_evals}")
    print(f"[{card}] pipeline from {CONFIG.name}: hidden {cfg.hidden_size}, {cfg.depth}+"
          f"{cfg.depth_single_blocks} blocks, fp8; load + calibrate + warm {load_s:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    evals = warm_evals
    try:
        for body, (w, h), steps in requests:
            before = LAUNCHES["qknorm_attention"]
            t = time.perf_counter()
            status, headers, payload = post(f"http://127.0.0.1:{server.port}/generate", body)
            dt = time.perf_counter() - t
            evals += steps
            if status != 200:
                fail("server", f"{body}: status {status}")
            im = Image.open(io.BytesIO(payload))
            im.load()
            if im.format != "JPEG" or im.size != (w, h):
                fail("server", f"{body}: got {im.format} {im.size}, expected JPEG {(w, h)}")
            if headers.get("x-seed") != str(body["seed"]):
                fail("server", f"X-Seed {headers.get('x-seed')!r} != {body['seed']}")
            lat = pipe.last_latents
            if lat is None or not bool(torch.isfinite(lat.float()).all()):
                fail("server", f"{body}: non-finite latents")
            launched = LAUNCHES["qknorm_attention"] - before
            if launched != blocks * steps:
                fail("server", f"{body}: {launched} kernel launches, expected {blocks} x {steps}")
            its = pipe.timings["denoise_it_per_s"]
            print(f"[{card}] POST /generate {w}x{h} {steps} steps: {dt:.3f} s/request, "
                  f"denoise {its:.3f} it/s, decode {pipe.timings['decode_seconds']:.3f} s, "
                  f"{launched} kernel launches", flush=True)
    finally:
        server.shutdown()
    launches = LAUNCHES["qknorm_attention"]
    if launches != blocks * evals:
        fail("server", f"{launches} kernel launches in the run, expected {blocks} x {evals}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("card", "torch is not installed")
    if not torch.cuda.is_available():
        fail("card", "torch.cuda.is_available() is False")
    if not (ROOT / "flux_fp8_api_tpu_torch" / "__init__.py").exists() or not CONFIG.exists():
        fail("card", f"no checkout of the port beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    from flux_fp8_api_tpu_torch import ablate_attention
    from flux_fp8_api_tpu_torch.ops import attention_kernel

    card_line = ablate_attention.card_line()  # nvidia-smi's name and power limit
    name = torch.cuda.get_device_name(0)
    print(f"card: {name} | {card_line} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    lib = attention_kernel.build_library()
    print(f"[{card_line}] build: {lib.relative_to(ROOT)} in {time.perf_counter() - t:.1f} s", flush=True)
    print((lib.parent / "ptxas.log").read_text().strip(), flush=True)

    max_err, times = phase_kernel(card_line)
    builds, path_launches = phase_guard_ablation(card_line)
    phase_fp8_linear(card_line)
    phase_model(card_line)
    launches = phase_server(card_line)

    k1_source = "flux_fp8_api_tpu_torch/csrc/qknorm_attention.cu"
    kernels = [{
        "name": "qknorm_attention",
        "route": "cuda",
        "source": k1_source,
        "replaces": "flux_fp8_api_tpu/ops/attention_kernel.py:183",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times[4608][0],
        "plain_ms": times[4608][1],
    }]
    for build, source, replaces in (
        ("qknorm_attention_stats", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:109"),
        ("qknorm_attention_ablate_exp", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:115"),
        ("bare_two_dot", "flux_fp8_api_tpu_torch/csrc/bare_two_dot.cu", "ablate_attention.py:75"),
    ):
        kernels.append({"name": build, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": path_launches[build], **builds[build]})
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
