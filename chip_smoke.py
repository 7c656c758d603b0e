#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases, each fatal on failure (non-zero exit, no result line):

1. card: name and power limit;
2. build: the attention kernel library, from this checkout's sources, with nvcc;
3. kernel: the rope pass (bit for bit) and the CUDA attention kernel K1 against their
   plain PyTorch versions at flux-dev's shapes (24 heads × 128; L = 4608, 3392 and
   1536, an Lq ≠ Lkv call, no rope, and rows whose logits all underflow), each timed
   beside its plain version and its bound (the published bf16 tensor-core rate or HBM
   bandwidth, whichever bounds it), and K1 beside ``F.scaled_dot_product_attention`` on
   the same rotated inputs under each backend that runs (a yardstick the port never
   calls);
4. guard rail and ablation: K1's stats and ablate builds and the bare two-dot (K2, a
   fourth build of K1's body) against their plain versions at L = 4608, 3392 and 1536,
   with their times (the stats build's output must equal the serving build's bit for
   bit), and beside K2 at L = 4608 the two-call library yardstick (``torch.bmm`` to a
   bf16 S, then ``torch.bmm`` by v; the port never calls it); then, with the launch
   counts at 0, the path itself: ``qknorm_attention_checked`` passing qk-normed inputs
   and raising on inputs scaled ×60 and on a NaN, and
   ``python -m flux_fp8_api_tpu_torch.ablate_attention 4608 3392 2816`` run in this
   process, whose rows are printed (K2 must come in under the whole attention call);
5. fp8 linear: ``torch._scaled_mm`` against its plain fp32 version at the qkv shape;
6. model: a small flux model (two heads of 128) on the card against the same model
   on the CPU, where every op takes its plain version;
7. server: the pipeline from ``configs/config-dev.json`` (full flux-dev width, random
   weights) calibrated and warmed by ``compile()``, serving three POST /generate
   requests through ``PipelineServer``, every launch count set to 0 just before and
   read just after: K1 and the rope pass each 57 launches per model evaluation, and
   no other build;
8. int linears: ``int8``, ``int4`` and the weight-only ``wo_int8``/``wo_int4``/
   ``wo_int2`` Linears at the qkv shape and ``int8`` at linear2's, at M = 1, 17 and
   4608 rows: the int32 product (``torch._int_mm``) equal to an exact fp64 product,
   the output against the plain version, and the times beside ``_scaled_mm`` fp8;
9. tiers: ``configs/config-dev-int8.json`` and ``configs/config-dev-gigaquant.json``
   (int4 flow with its embedders, wo_int4 T5 and CLIP, weight-only fp8 VAE) at full
   width and depth, each calibrated and warmed by ``compile()`` and serving one
   1024×1024, 28-step request, 57 K1 and 57 rope-pass launches per model evaluation;
10. checkpoints: (a) phase 7's calibrated pipeline saved prequantized, reloaded through
    a copy of ``configs/config-dev-prequant.json`` with ``ckpt_path`` set: no
    calibration trial, and phase 7's 512×512 request served again with identical
    latents; (b) a BFL float file at full width, 2 double + 2 single blocks, loaded
    by ``flux_from_pretrained``: the tree and its forward identical to the source's;
    (c) the same model as reference-prequantized files, with and without input scales:
    fp8 leaves equal to ``quantize_linear_fp8`` of the source, and the prequantized
    flag as the loader's detection says;
11. high logit bound: a flux-dev-width bf16 model (2 double + 2 single blocks, random
    weights) with one channel of its last block's k-norm scale raised until
    ``max_logit_bound`` is above ``MAX_SAFE_LOGIT``. The
    ``FluxPipeline`` built from it must log the bound and serve with
    ``model_cfg.use_pallas`` False; with every launch count set to 0 just before, one
    1024×1024 request through ``PipelineServer`` launches the rope pass 4 times per
    model evaluation and no build of K1, with finite latents; then one 512×512 forward
    of the same weights on the card against the CPU in fp32.

The last lines are the card line, one JSON object describing each kernel build (its
launches counted in the path of phase 7 or 4; its time, plain time, bound, library
time and error at L = 4608 from phase 3 or 4),
and ``{"ok": true, "device": {...}}``. Phases 7-10 free their pipelines before the
next (phase 7's lives until phase 10 has saved it).
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import shutil
import sys
import tempfile
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
# published peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core and
# fp32 non-tensor rates, HBM3 bandwidth. A card below its 700 W power limit is slower.
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# fp8 linear: max|out − plain| / max|plain|; fast accumulation and the bf16 output
# each cost about 2^-8.
FP8_REL_TOL = 2e-2
# small flux model, card vs CPU: ‖a − b‖ / ‖b‖ over the prediction. The two sides
# round to bf16 in different places, and where that moves an activation across an
# e5m2 rounding boundary (2 mantissa bits) the element differs by up to 25%, so the
# check is on the norm, not the worst element.
MODEL_REL_TOL = 5e-2
# int8/int4 linear, card vs plain: the same exact integer product and the same fp32
# epilogue, so what is left is a fused multiply-add in the epilogue and the final bf16
# rounding: |out − plain| ≤ 2^-8·|plain| + 1e-6.
INT_RTOL, INT_ATOL = 2**-8, 1e-6
# weight-only linear, card (bf16 weights, bf16 output, cuBLAS fp32 accumulation) vs an
# fp32 product of the dequantized weight: max|out − plain| / max|plain|.
WO_REL_TOL = 2e-2


def fail(phase: str, msg: str) -> None:
    print(f"chip_smoke: phase {phase} FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn`` over ``iters`` back-to-back calls after a warm one.
    The card sleeps first while the host enqueues the calls, so a call shorter than its
    own host overhead is still timed on the device (CUDA events), not at the host's
    launch rate."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention import SLEEP_CYCLES_PER_CALL

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take for work of
    ``flops`` operations that must move ``nbytes``, against its published peaks."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def attention_bound(h: int, l: int, d: int = 128):
    """K1's and K2's bound at Lq = Lkv = l: 4·H·L²·D bf16 tensor-core operations; q, k,
    v read and the output written once, bf16."""
    return bound(4 * h * l * l * d, 4 * h * l * d * 2)


def rope_bound(h: int, l: int, d: int = 128):
    """The rope pass's bound at Lq = Lkv = l: 3 fp32 operations per element (two
    products, one sum); q and k read and written once in bf16, and the one pair of fp32
    tables they share."""
    return bound(3 * h * d * 2 * l, 2 * 2 * h * d * 2 * l + 2 * 4 * d * l, PEAK_F32_FLOPS)


def library_attention(card: str, q, k, v, scale: float, ref):
    """The yardstick: one ``F.scaled_dot_product_attention`` call on the same rotated
    (1, H, L, D) inputs under each backend that runs here. Prints each backend's time
    and its max|lib − plain| / max|plain|; → the fastest time, or None. The port never
    calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = q[None], k[None], v[None]
    r = ref.float()
    best = None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        call = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale)  # noqa: E731
        with sdpa_kernel(backend):
            try:
                out = call()[0].float()
            except RuntimeError as e:  # a backend that does not take these inputs here
                print(f"[{card}]   library {backend.name}: does not run ({str(e).splitlines()[0][:120]})", flush=True)
                continue
            ms = cuda_time_ms(call, 20)
        rel = float((out - r).abs().max() / r.abs().max())
        print(f"[{card}]   library {backend.name}: {ms:.4f} ms, max|lib - plain| / max|plain| {rel:.3e}", flush=True)
        best = ms if best is None else min(best, ms)
    return best


def phase_kernel(card: str):
    """The rope pass and K1 against their plain versions at the three serving lengths,
    each timed beside its plain version, its bound and (K1) the library call."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import (
        qknorm_attention, qknorm_attention_ref, rope_rotate, rope_rotate_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    heads, d = 24, 128
    scale = d**-0.5

    def normed(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)

    worst = 0.0
    k1, rope = {}, {}  # L → {"ms", "plain_ms", "bound_ms", "bound_by", ...}

    def check(name, q, k, v, sm_scale, **tables):
        nonlocal worst
        out = qknorm_attention(q, k, v, sm_scale, **tables)
        ref = qknorm_attention_ref(q, k, v, sm_scale, **tables)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        if not torch.isfinite(o).all():
            fail("kernel", f"{name}: non-finite output")
        err = float((o - r).abs().max())
        used = (o - r).abs() / (K1_ATOL + K1_RTOL * r.abs())
        bad = used > 1
        print(f"[{card}] K1 {name}: shape {tuple(q.shape)}x{tuple(k.shape)} max_abs_err {err:.3e} "
              f"(tol {K1_ATOL} + {K1_RTOL}*|plain|; the worst element uses {float(used.max()):.3f} of its "
              f"tolerance) max|plain| {float(r.abs().max()):.3e}", flush=True)
        if bool(bad.any()):
            fail("kernel", f"{name}: {int(bad.sum())} elements outside tolerance, max_abs_err {err}")
        worst = max(worst, err)
        return out, ref

    for h_img, w_img in ((1024, 1024), (720, 1024), (512, 512)):
        l = 512 + (h_img // 16) * (w_img // 16)
        q, k, v = normed(heads, l, d), normed(heads, l, d), torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
        cos, sin = rope_tables(h_img, w_img)

        qr, kr = rope_rotate(q, k, cos, sin)
        qp, kp = rope_rotate_ref(q, cos, sin), rope_rotate_ref(k, cos, sin)
        rope_err = max(float((qr.float() - qp.float()).abs().max()), float((kr.float() - kp.float()).abs().max()))
        if not (torch.equal(qr, qp) and torch.equal(kr, kp)):
            fail("kernel", f"L={l}: the rope pass differs from its plain version (max_abs_err {rope_err})")
        b_ms, b_by = rope_bound(heads, l)
        rope[l] = {"max_abs_err": rope_err, "ms": cuda_time_ms(lambda: rope_rotate(q, k, cos, sin), 50),
                   "plain_ms": cuda_time_ms(lambda: (rope_rotate_ref(q, cos, sin), rope_rotate_ref(k, cos, sin)), 10),
                   "bound_ms": b_ms, "bound_by": b_by}
        print(f"[{card}] rope pass L={l}: bit-identical to its plain version (max_abs_err {rope_err}); {rope[l]['ms']:.4f} ms "
              f"({100 * b_ms / rope[l]['ms']:.1f}% of its {b_ms:.4f} ms bound, {b_by}), plain "
              f"{rope[l]['plain_ms']:.4f} ms", flush=True)

        check(f"L={l} rope", q, k, v, scale, cos=cos, sin=sin)
        _, ref = check(f"L={l} pre-rotated", qr, kr, v, scale)
        b_ms, b_by = attention_bound(heads, l)
        k1[l] = {"ms": cuda_time_ms(lambda: qknorm_attention(qr, kr, v, scale), 20),
                 "with_rope_ms": cuda_time_ms(lambda: qknorm_attention(q, k, v, scale, cos=cos, sin=sin), 20),
                 "plain_ms": cuda_time_ms(lambda: qknorm_attention_ref(qr, kr, v, scale), 5),
                 "bound_ms": b_ms, "bound_by": b_by}
        k1[l]["library_ms"] = library_attention(card, qr, kr, v, scale, ref)
        t = k1[l]
        lib = "none ran" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"[{card}] K1 L={l}: kernel {t['ms']:.4f} ms on rotated q/k ({4 * heads * l * l * d / t['ms'] / 1e9:.1f} "
              f"TFLOP/s, {100 * b_ms / t['ms']:.1f}% of its {b_ms:.4f} ms bound, {b_by}); rope pass + kernel "
              f"{t['with_rope_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; library {lib}", flush=True)
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
    out, _ = check("all-underflow", q, k, v, 1.0)
    if bool(out.float().abs().max() != 0):
        fail("kernel", "all-underflow rows must be exactly 0")
    return worst, k1, rope


def phase_guard_ablation(card: str):
    """The stats and ablate builds and the bare two-dot against their plain versions,
    then the guard-rail and ablation path with the launch counts at 0."""
    import torch

    from flux_fp8_api_tpu_torch import ablate_attention
    from flux_fp8_api_tpu_torch.ablate_attention import bare_two_dot, bare_two_dot_ref
    from flux_fp8_api_tpu_torch.ops.attention_kernel import (
        LAUNCHES, qknorm_attention, qknorm_attention_checked, qknorm_attention_ref, rope_rotate,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    heads, d = 24, 128
    scale = d**-0.5
    results = {}  # build → L → {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by"}

    def normed(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)

    def record(build, l, err, ms, plain_ms, what):
        b_ms, b_by = attention_bound(heads, l)
        print(f"[{card}] {build} L={l}: {what}; kernel {ms:.4f} ms ({100 * b_ms / ms:.1f}% of its "
              f"{b_ms:.4f} ms bound, {b_by}), plain {plain_ms:.4f} ms", flush=True)
        results.setdefault(build, {})[l] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                            "bound_ms": b_ms, "bound_by": b_by}

    for h_img, w_img in ((1024, 1024), (720, 1024), (512, 512)):
        l = 512 + (h_img // 16) * (w_img // 16)
        q, k = normed(heads, l, d), normed(heads, l, d)
        v = torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
        cos, sin = rope_tables(h_img, w_img)
        rope = dict(cos=cos, sin=sin)
        qr, kr = rope_rotate(q, k, cos, sin)  # the builds are timed on rotated q/k, as K1 is

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
               cuda_time_ms(lambda: qknorm_attention(qr, kr, v, scale, return_max_logit=True), 20),
               cuda_time_ms(lambda: qknorm_attention_ref(qr, kr, v, scale, return_max_logit=True), 5),
               f"output bit-identical to the serving build; max|logit| {float(m):.6f} vs plain "
               f"{float(ref_m):.6f} (rel {m_rel:.2e}, tol {K1S_MAX_RTOL}); max_abs_err {err:.3e}")

        out = qknorm_attention(q, k, v, scale, ablate_exp=True, **rope)
        ref = qknorm_attention_ref(q, k, v, scale, ablate_exp=True, **rope)
        o, r = out.double(), ref.double()
        rel = float((o - r).norm() / r.norm())
        if not (bool(torch.isfinite(o).all()) and rel <= K1A_REL_TOL):
            fail("guard", f"L={l}: ablate build relative error {rel}")
        record("qknorm_attention_ablate_exp", l, float((o - r).abs().max()),
               cuda_time_ms(lambda: qknorm_attention(qr, kr, v, scale, ablate_exp=True), 20),
               cuda_time_ms(lambda: qknorm_attention_ref(qr, kr, v, scale, ablate_exp=True), 5),
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
        if l == 4608:
            # the yardstick: two library calls, the bf16 S through device memory between them
            kt = kb.transpose(1, 2)
            bmm_ms = cuda_time_ms(lambda: torch.bmm(torch.bmm(qb, kt), vb), 10)
            print(f"[{card}] bare_two_dot L={l}: library yardstick torch.bmm(q, k^T) -> bf16, then "
                  f"torch.bmm(., v): {bmm_ms:.4f} ms (the port never calls it)", flush=True)

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
        if not r["attained_vs_bare_pct"] < 100:
            fail("guard", f"L={r['L']}: the bare two-dot is no ceiling for the attention call: {r}")
        print(f"[{card}] L={r['L']}: bare two-dot {r['bare_two_dot_ms']} ms = "
              f"{r['bare_two_dot_ms'] / r['ms']['matmul_only']:.3f} x K1's matmul_only build "
              f"({r['ms']['matmul_only']} ms)", flush=True)
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

    requests = [  # (body, expected (width, height), steps); the last is served again in phase 10
        ({"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
          "num_steps": 28, "seed": 11}, (1024, 1024), 28),
        ({"prompt": "a beautiful cat in the sun", "seed": 12}, (720, 1024), 24),
        ({"prompt": "a blue sky", "width": 512, "height": 512, "num_steps": 20, "seed": 13},
         (512, 512), 20),
    ]
    for key in LAUNCHES:  # the main path's run starts here
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    pipe = FluxPipeline.load_pipeline_from_config_path(str(CONFIG))  # compile() runs here
    load_s = time.perf_counter() - t0
    cfg = pipe.model_cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    warm_evals = pipe.config.num_scale_trials + (pipe.config.warmup_steps or 24)
    check_path_launches("server", "compile()", dict(LAUNCHES), blocks * warm_evals)
    print(f"[{card}] pipeline from {CONFIG.name}: hidden {cfg.hidden_size}, {cfg.depth}+"
          f"{cfg.depth_single_blocks} blocks, fp8; load + calibrate + warm {load_s:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)

    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    evals = warm_evals
    last = None
    try:
        for body, (w, h), steps in requests:
            before = dict(LAUNCHES)
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
            launched = {key: n - before[key] for key, n in LAUNCHES.items()}
            check_path_launches("server", str(body), launched, blocks * steps)
            its = pipe.timings["denoise_it_per_s"]
            print(f"[{card}] POST /generate {w}x{h} {steps} steps: {dt:.3f} s/request, "
                  f"denoise {its:.3f} it/s, decode {pipe.timings['decode_seconds']:.3f} s, "
                  f"{launched['qknorm_attention']} K1 and {launched['rope_rotate']} rope-pass launches", flush=True)
            last = (body, lat.clone())
    finally:
        server.shutdown()
    launches = dict(LAUNCHES)  # read just after the main path's run
    check_path_launches("server", "the run", launches, blocks * evals)
    return launches, pipe, last


def check_path_launches(phase: str, what: str, launched: dict, expected: int) -> None:
    """The serving path launches K1 and the rope pass once per block and model
    evaluation each, and no other kernel build."""
    want = {"qknorm_attention": expected, "rope_rotate": expected}
    got = {key: n for key, n in launched.items() if n}
    if got != want:
        fail(phase, f"{what}: launches {got}, expected {want}")


def release() -> None:
    """Return the device memory of the pipelines a phase has dropped."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_int_linears(card: str):
    """int8/int4 and weight-only Linears on the card against their plain versions at
    M = 1, 17 and 4608 rows; int8/int4 and ``_scaled_mm`` fp8 timed at M = 4608."""
    import torch

    from flux_fp8_api_tpu_torch.ops import quant

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)

    def weight(n, k):
        w = ((torch.rand(n, k, generator=gen, device=dev) * 2 - 1) * (3 / k) ** 0.5).to(torch.bfloat16)
        return w, ((torch.rand(n, generator=gen, device=dev) * 2 - 1) / k**0.5).to(torch.bfloat16)

    cases = [(kind, 9216, 3072) for kind in ("int8", "int4", "wo_int8", "wo_int4", "wo_int2")]
    cases.append(("int8", 3072, 15360))
    quantizers = {"wo_int8": quant.quantize_linear_wo_int8, "wo_int4": quant.quantize_linear_wo_int4,
                  "wo_int2": quant.quantize_linear_wo_int2, **quant.FLOW_QUANTIZERS}
    times = {}
    for kind, n, k in cases:
        w, b = weight(n, k)
        lin = quantizers[kind](w, b)
        for m in (1, 17, 4608):
            x = torch.randn(1, m, k, generator=gen, device=dev).to(torch.bfloat16)
            quant.with_input_scale(lin, x.abs().max().float())
            out, _ = quant.linear_apply(lin, x, torch.bfloat16)
            torch.cuda.synchronize()
            if out.shape != (1, m, n) or out.dtype != torch.bfloat16 or not bool(torch.isfinite(out.float()).all()):
                fail("int", f"{kind} {n}x{k} M={m}: got {tuple(out.shape)} {out.dtype}")
            if kind in ("int8", "int4"):
                x8 = quant.quantize_activation_int8(x, lin.in_scale).reshape(m, k)
                q = quant._unpack_int4(lin.q) if kind == "int4" else lin.q
                acc = quant.int_mm(x8, q)
                exact = torch.matmul(x8.double(), q.double().t())  # exact: |sum| < 2^53
                if acc.dtype != torch.int32 or not torch.equal(acc.long(), exact.long()):
                    fail("int", f"{kind} {n}x{k} M={m}: the int32 product differs from the exact one")
                ref = acc.float() * ((1.0 / lin.in_scale.to(torch.bfloat16).float()) * lin.w_scale_inv) + b.float()
                err = (out.float()[0] - ref).abs()
                bad = int((err > INT_ATOL + INT_RTOL * ref.abs()).sum())
                what = f"int32 product exact; max_abs_err {float(err.max()):.3e} (tol {INT_ATOL} + 2^-8*|plain|)"
            else:
                ref = x.float()[0] @ quant.dequantize_kernel(lin).t() + b.float()
                rel = float((out.float()[0] - ref).abs().max() / ref.abs().max())
                bad = int(not rel <= WO_REL_TOL)
                what = f"max_rel_err {rel:.3e} (tol {WO_REL_TOL})"
            print(f"[{card}] {kind} W({n},{k}) M={m}: {what}", flush=True)
            if bad:
                fail("int", f"{kind} {n}x{k} M={m}: {bad} elements outside tolerance")
            if m == 4608 and kind in ("int8", "int4") and n == 9216:
                times[kind] = cuda_time_ms(lambda: quant.linear_apply(lin, x, torch.bfloat16), 20)
                if kind == "int8":
                    times["_int_mm alone"] = cuda_time_ms(lambda: quant.int_mm(x8, lin.q), 20)
    w, b = weight(9216, 3072)
    x = torch.randn(1, 4608, 3072, generator=gen, device=dev).to(torch.bfloat16)
    fp8 = quant.with_input_scale(quant.quantize_linear_fp8(w, b), x.abs().max().float())
    times["fp8 (_scaled_mm)"] = cuda_time_ms(lambda: quant.linear_apply(fp8, x, torch.bfloat16), 20)
    print(f"[{card}] linear x(4608,3072) W(9216,3072), ms incl. the activation quantization: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    print(f"[{card}] phase int linears: {time.perf_counter() - t_phase:.1f} s", flush=True)


def serve_one(card: str, pipe, body: dict, size):
    """POST /generate once through PipelineServer; → (seconds, attention launches)."""
    from PIL import Image

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.server import PipelineServer

    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    try:
        before = dict(LAUNCHES)
        t = time.perf_counter()
        status, _, payload = post(f"http://127.0.0.1:{server.port}/generate", body)
        dt = time.perf_counter() - t
    finally:
        server.shutdown()
    im = Image.open(io.BytesIO(payload))
    im.load()
    if status != 200 or im.format != "JPEG" or im.size != size:
        fail("serve", f"{body}: status {status}, {im.format} {im.size}, expected JPEG {size}")
    return dt, {key: n - before[key] for key, n in LAUNCHES.items()}


def phase_tiers(card: str):
    """config-dev-int8 and config-dev-gigaquant at full width and depth, random weights."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    for name, flow_kind, encoder_kind in (("config-dev-int8.json", "int8", "wo_fp8"),
                                          ("config-dev-gigaquant.json", "int4", "wo_int4")):
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()  # phase 7's pipeline, kept for phase 10
        for key in LAUNCHES:
            LAUNCHES[key] = 0
        pipe = FluxPipeline.load_pipeline_from_config_path(str(ROOT / "configs" / name))  # compile() runs here
        setup_s = time.perf_counter() - t_phase
        model, cfg = pipe.model_params, pipe.model_cfg
        kinds = {
            "linear1": model["single_blocks"][0]["linear1"].kind,
            "img_mod_lin": model["double_blocks"][0]["img_mod_lin"].kind,
            "img_in": model["img_in"].kind,
            "t5": pipe.t5.params["blocks"][0]["wo"].kind,
            "clip": pipe.clip.params["blocks"][0]["fc1"].kind if pipe.config.clip_quantization_dtype else "float",
            "ae": str(pipe.ae_params["decoder"]["conv_in"]["weight"].dtype),
        }
        if kinds["linear1"] != flow_kind or kinds["t5"] != encoder_kind:
            fail("tiers", f"{name}: leaf kinds {kinds}")
        blocks = cfg.depth + cfg.depth_single_blocks
        warm = pipe.config.num_scale_trials + (pipe.config.warmup_steps or 24)
        check_path_launches("tiers", f"{name}: compile()", dict(LAUNCHES), blocks * warm)
        body = {"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
                "num_steps": 28, "seed": 21}
        dt, launched = serve_one(card, pipe, body, (1024, 1024))
        lat = pipe.last_latents
        if lat is None or not bool(torch.isfinite(lat.float()).all()):
            fail("tiers", f"{name}: non-finite latents")
        check_path_launches("tiers", f"{name}: POST /generate", launched, blocks * 28)
        print(f"[{card}] {name}: leaf kinds {kinds}; set-up (load + 12-step calibration + "
              f"{pipe.config.warmup_steps or 24}-step warm) {setup_s:.1f} s, peak device memory "
              f"{(torch.cuda.max_memory_allocated() - resident) / 2**30:.1f} GiB above the "
              f"{resident / 2**30:.1f} GiB already resident; POST /generate 1024x1024 28 steps: "
              f"{dt:.3f} s/request, denoise {pipe.timings['denoise_it_per_s']:.3f} it/s, "
              f"{launched['qknorm_attention']} K1 and {launched['rope_rotate']} rope-pass launches = {blocks} x 28 "
              f"each; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
        del pipe, model
        release()


def _spec(**overrides):
    """configs/config-dev.json with fields replaced (validated, as flux_from_pretrained does)."""
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec, load_config_from_path

    return ModelSpec.model_validate({**load_config_from_path(str(CONFIG)).model_dump(), **overrides})


def phase_checkpoints(card: str, held: dict):
    """(a) full-size prequant round trip of phase 7's pipeline (``held`` gives it up
    once saved); (b) a BFL float file and (c) reference-prequantized files at full
    width, 2 double + 2 single blocks."""
    import torch

    from flux_fp8_api_tpu_torch.models.flux import FluxStatic, flux_apply, init_flux_params, max_logit_bound
    from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
    from flux_fp8_api_tpu_torch.ops.quant import Linear, quantize_linear_fp8
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.loader import flux_from_pretrained, load_models_from_config
    from tests.torch_parity import write_bfl_checkpoint

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        print(f"[{card}] checkpoints in {tmp}: {shutil.disk_usage(tmp).free / 2**30:.1f} GiB free", flush=True)
        # (a) save phase 7's calibrated pipeline, reload it from a prequantized config
        t_phase = time.perf_counter()
        path = tmp / "flux-dev-prequant.safetensors"
        t = time.perf_counter()
        held["pipe"].save_prequantized(str(path))
        write_s = time.perf_counter() - t
        body, ref_latents = held.pop("request")
        del held["pipe"]
        release()
        spec = json.loads((ROOT / "configs" / "config-dev-prequant.json").read_text())
        spec["ckpt_path"] = str(path)
        cfg_path = tmp / "config-dev-prequant.json"
        cfg_path.write_text(json.dumps(spec))
        from flux_fp8_api_tpu_torch.utils.config import load_config_from_path

        config = load_config_from_path(str(cfg_path))
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        models = load_models_from_config(config)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        if not models.flow_prequantized:
            fail("checkpoints", "a prequant-v1 file did not load as prequantized")
        pipe = FluxPipeline(name=str(config.version), clip=models.clip, t5=models.t5, model=models.flow,
                            model_cfg=models.flow_cfg, ae=models.ae, config=config,
                            prequantized=models.flow_prequantized)  # compile(): warm only
        del models
        if pipe._needs_calibration or pipe._trials_done:
            fail("checkpoints", f"calibration ran after a prequantized load ({pipe._trials_done} trials)")
        dt, _ = serve_one(card, pipe, body, (body["width"], body["height"]))
        if pipe._trials_done or not torch.equal(pipe.last_latents, ref_latents):
            diff = float((pipe.last_latents.float() - ref_latents.float()).abs().max())
            fail("checkpoints", f"reloaded pipeline: latents differ from phase 7's (max {diff}), "
                                f"{pipe._trials_done} calibration trials")
        print(f"[{card}] (a) prequant round trip: {path.stat().st_size} bytes, write {write_s:.1f} s, "
              f"read (load_models_from_config) {read_s:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; 0 calibration trials; "
              f"{body['width']}x{body['height']} {body['num_steps']} steps seed {body['seed']} "
              f"in {dt:.3f} s, latents bit-identical to phase 7's; {time.perf_counter() - t_phase:.1f} s", flush=True)
        del pipe
        release()
        path.unlink()

        # (b) BFL float file, full width, 2 double + 2 single blocks
        t_phase = time.perf_counter()
        params = {**_spec().params.model_dump(), "depth": 2, "depth_single_blocks": 2}
        spec = _spec(params=params)
        cfg = FluxStatic.from_params(spec.params)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        src = init_flux_params(cfg, gen, torch.bfloat16)
        for blk in (*src["double_blocks"], *src["single_blocks"]):
            for name, value in list(blk.items()):
                if not isinstance(value, Linear):  # qk-norm scales that the permutation moves
                    noise = torch.randn(value.shape, generator=gen, device="cuda")
                    setattr(blk, name, (1 + 0.1 * noise).to(torch.bfloat16))
        bfl = tmp / "flux-2x2.safetensors"
        t = time.perf_counter()
        write_bfl_checkpoint(bfl, src, cfg)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded, _, prequant = flux_from_pretrained(str(CONFIG), ckpt_path=str(bfl), params=params,
                                                    flow_quantization_dtype="bfloat16")
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t
        a, b = dict(src.named_buffers()), dict(loaded.named_buffers())
        if sorted(a) != sorted(b) or prequant:
            fail("checkpoints", f"BFL load: {len(a)} vs {len(b)} tensors, prequantized {prequant}")
        for key in a:
            if a[key].dtype != b[key].dtype or not torch.equal(a[key], b[key]):
                fail("checkpoints", f"BFL load: {key} differs from the source")
        x = dict(img=torch.randn(1, 1024, 64, generator=gen, device="cuda"),
                 img_ids=make_img_ids(64, 64, 1, "cuda"),
                 txt=torch.randn(1, 512, 4096, generator=gen, device="cuda"),
                 txt_ids=make_txt_ids(512, 1, "cuda"), timesteps=torch.full((1,), 0.6, device="cuda"),
                 y=torch.randn(1, 768, generator=gen, device="cuda"), guidance=torch.full((1,), 3.5, device="cuda"))
        out_src, out_loaded = flux_apply(src, cfg, **x), flux_apply(loaded, cfg, **x)
        if not (torch.equal(out_src, out_loaded) and bool(torch.isfinite(out_src.float()).all())):
            fail("checkpoints", "BFL load: the forward differs from the source tree's")
        print(f"[{card}] (b) BFL float file, hidden {cfg.hidden_size}, 2+2 blocks: {bfl.stat().st_size} bytes, "
              f"write {write_s:.1f} s, read {read_s:.1f} s; {len(a)} tensors and the forward at 512x512 "
              f"bit-identical to the source; attention |logit| bound {max_logit_bound(loaded, cfg):.2f}; "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        del loaded
        bfl.unlink()

        # (c) reference-prequantized files, with and without tuned input scales
        t_phase = time.perf_counter()
        for in_scale in (None, 57344.0 / 3.0):
            ref = tmp / "flux-2x2-reference-fp8.safetensors"
            write_bfl_checkpoint(ref, src, cfg, reference_fp8=True, input_scale=in_scale)
            models = load_models_from_config(_spec(params=params, ckpt_path=str(ref), prequantized_flow=True))
            if models.flow_prequantized != (in_scale is not None):
                fail("checkpoints", f"reference fp8 file, input_scale {in_scale}: flow_prequantized "
                                    f"{models.flow_prequantized}")
            n = 0
            for stack in ("double_blocks", "single_blocks"):
                for i, blk in enumerate(models.flow[stack]):
                    for name, lin in blk.items():
                        if not isinstance(lin, Linear):
                            continue
                        want = quantize_linear_fp8(src[stack][i][name].weight, None)
                        ok = (lin.kind == "fp8" and torch.equal(lin.q.view(torch.uint8), want.q.view(torch.uint8))
                              and torch.equal(lin.w_scale, want.w_scale)
                              and float(lin.in_scale) == float(torch.tensor(in_scale or 1.0)))
                        if not ok:
                            fail("checkpoints", f"reference fp8 file: {stack}.{i}.{name} differs from quantize_linear_fp8")
                        n += 1
            if models.flow["img_in"].kind != "float" or not torch.equal(models.flow["img_in"].weight, src["img_in"].weight):
                fail("checkpoints", "reference fp8 file: img_in should load as the float source")
            print(f"[{card}] (c) reference-prequantized file, input_scale {in_scale}: {n} fp8 leaves equal to "
                  f"quantize_linear_fp8 of the source; flow_prequantized {models.flow_prequantized}", flush=True)
            del models
            ref.unlink()
        print(f"[{card}] (c) {time.perf_counter() - t_phase:.1f} s", flush=True)
        del src
        release()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_high_bound(card: str):
    """Weights whose logit bound the max-free kernel cannot take, served at full width
    through ``use_pallas=False``: the rope pass, then F.scaled_dot_product_attention."""
    import logging

    import torch

    from flux_fp8_api_tpu_torch.models.flux import flux_apply, max_logit_bound
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES, MAX_SAFE_LOGIT
    from flux_fp8_api_tpu_torch.ops.packing import make_img_ids, make_txt_ids
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.loader import load_models_from_config

    t_phase = time.perf_counter()
    params = {**_spec().params.model_dump(), "depth": 2, "depth_single_blocks": 2}
    # a bf16 flow: the path under test is the attention, and e5m2 activations would put
    # card and CPU apart by more than the attention does (on an H100 the fp8 tier's
    # forward differs from the CPU's by 0.043-0.046 relative in norm at this size)
    config = _spec(params=params, compile_blocks=False, compile_extras=False, flow_quantization_dtype=None)
    models = load_models_from_config(config)  # flow from a seed, 2-layer text towers, the VAE
    flow, cfg = models.flow, models.flow_cfg
    # One channel of the last block's k-norm scale raised: the bound follows the largest
    # scale of any block. Raising every scale makes the softmax nearly an argmax, where
    # the two sides' roundings pick other keys (0.20 relative in norm on an H100 at fp8).
    factor = 1.5 * MAX_SAFE_LOGIT / max_logit_bound(flow, cfg)
    last = flow["single_blocks"][-1]
    last.knorm = last.knorm.clone()
    last.knorm[0] *= factor
    bound = max_logit_bound(flow, cfg)

    warned = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage())
    log = logging.getLogger("flux_fp8_api_tpu_torch.pipeline")
    log.addHandler(handler)
    try:
        pipe = FluxPipeline(name=str(config.version), clip=models.clip, t5=models.t5, model=flow,
                            model_cfg=cfg, ae=models.ae, config=config)
    finally:
        log.removeHandler(handler)
    del models, flow
    if not (cfg.use_pallas and pipe.model_cfg.use_pallas is False and any("use_pallas=False" in w for w in warned)):
        fail("high-bound", f"bound {bound:.1f}: use_pallas {pipe.model_cfg.use_pallas}, warnings {warned}")
    print(f"[{card}] high-bound pipeline: hidden {cfg.hidden_size}, 2+2 blocks, bf16; channel 0 of the last "
          f"block's k-norm scale x{factor:.2f} gives max_logit_bound {bound:.1f} > {MAX_SAFE_LOGIT}; logged: "
          f"{warned[0]}", flush=True)

    steps = 28
    body = {"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
            "num_steps": steps, "seed": 31}
    for key in LAUNCHES:  # the high-bound path's run starts here
        LAUNCHES[key] = 0
    dt, launched = serve_one(card, pipe, body, (1024, 1024))
    launched = {key: n for key, n in launched.items() if n}
    lat = pipe.last_latents
    if lat is None or not bool(torch.isfinite(lat.float()).all()):
        fail("high-bound", "non-finite latents")
    blocks = cfg.depth + cfg.depth_single_blocks
    if launched != {"rope_rotate": blocks * steps}:
        fail("high-bound", f"launches {launched}, expected {{'rope_rotate': {blocks * steps}}} and no K1 build")
    print(f"[{card}] high-bound POST /generate 1024x1024 {steps} steps: {dt:.3f} s/request, "
          f"denoise {pipe.timings['denoise_it_per_s']:.3f} it/s, launches {launched} "
          f"({blocks} rope-pass launches per evaluation, 0 K1)", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    x = dict(img=torch.randn(1, 1024, 64, generator=gen, device="cuda").to(torch.bfloat16),
             img_ids=make_img_ids(64, 64, 1, "cuda"),
             txt=torch.randn(1, 512, 4096, generator=gen, device="cuda").to(torch.bfloat16),
             txt_ids=make_txt_ids(512, 1, "cuda"), timesteps=torch.full((1,), 0.6, device="cuda"),
             y=torch.randn(1, 768, generator=gen, device="cuda").to(torch.bfloat16),
             guidance=torch.full((1,), 3.5, device="cuda"))
    model, run_cfg = pipe.model_params, pipe.model_cfg
    del pipe
    out = flux_apply(model, run_cfg, **x).float().cpu()
    model.to("cpu", torch.float32)  # in place: the same weights in fp32, every op on its plain version
    ref = flux_apply(model, dataclasses.replace(run_cfg, compute_dtype="float32"),
                     **{k: v.cpu().float() for k, v in x.items()}).float()
    rel = float((out - ref).norm() / ref.norm())
    print(f"[{card}] high-bound 512x512 forward (L=1536), card (bf16) vs CPU (fp32): norm_rel_err {rel:.3e} "
          f"(tol {MODEL_REL_TOL}); phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    if not (bool(torch.isfinite(out).all()) and rel <= MODEL_REL_TOL):
        fail("high-bound", f"card vs CPU relative error {rel}")
    del model
    release()


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

    max_err, k1, rope = phase_kernel(card_line)
    builds, path_launches = phase_guard_ablation(card_line)
    phase_fp8_linear(card_line)
    phase_model(card_line)
    launches, pipe7, request = phase_server(card_line)
    held = {"pipe": pipe7, "request": request}
    del pipe7
    phase_int_linears(card_line)
    phase_tiers(card_line)
    phase_checkpoints(card_line, held)
    phase_high_bound(card_line)

    def row(name, source, replaces, n, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": n,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t.get("library_ms")}

    k1_source = "flux_fp8_api_tpu_torch/csrc/qknorm_attention.cu"
    kernels = [
        row("qknorm_attention", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:183",
            launches["qknorm_attention"], max_err, k1[4608]),
        row("rope_rotate", "flux_fp8_api_tpu_torch/csrc/rope_rotate.cu",
            "flux_fp8_api_tpu/ops/attention_kernel.py:51", launches["rope_rotate"],
            rope[4608]["max_abs_err"], rope[4608]),
    ]
    for build, source, replaces in (
        ("qknorm_attention_stats", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:109"),
        ("qknorm_attention_ablate_exp", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:115"),
        ("bare_two_dot", k1_source, "ablate_attention.py:75"),
    ):
        t = builds[build][4608]
        kernels.append(row(build, source, replaces, path_launches[build], t["max_abs_err"], t))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
