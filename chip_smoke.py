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
    of the same weights on the card against the CPU in fp32;
12. request surface, on phase 10(a)'s reloaded fp8 pipeline (calibrated, so no trial
    is paid again), every launch count set to 0 just before and read just after:
    (a) img2img: a 1024×1024, 28-step request through ``PipelineServer``, then the same
    with its JPEG as a base64 ``init_image`` at strength 0.6: 17 evaluations of 57 K1
    and 57 rope-pass launches, a 1024×1024 JPEG, finite latents; ``ae_encode`` on the
    card (bf16) against the CPU (fp32) at 512×512 on the same weights;
    (b) LoRA: a diffusers-format rank-16 LoRA drawn from a seed over every block's
    attention and MLP linears, written to a file and fused by POST /lora: the fused
    fp8 weights of ``double_blocks.0.img_attn_qkv`` and ``single_blocks.37.linear1``
    within e4m3 rounding of dequant(W) + delta computed in fp64 on the CPU; a request
    (57 K1 launches per evaluation, latents other than the unfused request's); a reload
    at the same scale leaves the weights as they were; a new scale rescales; an unload
    empties /health's list and the same request comes back near the unfused latents;
    (c) FastAPI: ``api.app`` under uvicorn in a thread on a free port: GET /health and
    GET /, one 512×512, 20-step POST /generate (JPEG and ``x-seed``), and POST /lora
    load and unload;
13. step cache, on the same pipeline, 1024×1024, 28 steps, one seed, through one
    ``PipelineServer``, every launch count set to 0 just before each request and read
    just after: (a) uncached, ``{"mode": "dynamic", "threshold": 0}`` and ``{"mode":
    "interval", "interval": 1}``: 28 evaluations each, latents bit for bit equal; then
    the cost of the dynamic mode's indicator and host sync per unforced step, from
    eight ABBA groups of 4-step uncached and dynamic-0 denoise runs (mean and standard
    error), beside the indicator's device time; (b) interval 3: 11 evaluations (steps 0, 1, 27 forced;
    3, 6, …, 24), 627 K1 and 627 rope-pass launches; (c) interval 3 with ``"order": 1``:
    11 evaluations, latents other than (b)'s; (d) ``{"mode": "dynamic", "threshold":
    0.4}``: 3 to 28 evaluations of 57 K1 launches each; every request a 1024×1024 JPEG
    and finite latents; then ``bench_cache.run`` on that pipeline's model at 1024×1024,
    28 steps, whose rows are printed (57 K1 launches per evaluation);
14. fidelity gate, once every earlier pipeline is freed: ``bench_fidelity.run`` at
    flux-dev's full width and depth, 1024×1024, 28 steps (the bf16 ground truth
    resident, then fp8, fp8_fast_accum, int8 and int4 each drawn again from the same
    seed, calibrated and compared by SSIM and PSNR of the latent image), its JSON line
    printed; the phase fails if the fp8_fast_accum SSIM is below 0.95;
15. offload: ``configs/config-dev-offload.json`` (fp8 flow, T5 wo_int4, all three
    offloads) at full width and depth from a seed, the flow and the VAE in page-locked
    host memory; (a) ``compile()`` (calibration over the whole tree's round trip, the
    warm-up streamed; 57 K1 and rope-pass launches per evaluation) and one streamed
    1024x1024/28 request through ``PipelineServer``, with memory before, at peak and
    after; between requests no flow block, VAE or encoder weight on the card (every
    tree pinned on the host, the card holding only the top-level params, the LRU and
    the latents within ``RESIDENT_SLACK``); (b) fixed inputs through the resident loop
    and ``offload.streamed_denoise`` at 1024x1024/28 (every block retained) and
    512x512/4 (retain 0, half the blocks, and retain 0 at ``sync_every`` 2): latents
    equal to the resident ones bit for bit (or within the resident loop's own
    run-to-run difference, printed), each run's it/s and peak memory, the copy rates
    of single blocks and of the whole tree both ways, step 1 against a steady step;
    the phase fails unless step 1 is shorter than the whole tree's copy plus a
    resident step by half the smaller of the two (the copies overlap the compute);
    then ``sync_every`` against the compute: each single block's compute padded by a
    sleep longer than its copy, 512x512/2 at retain 0 and 512x512/4 at half the blocks
    retained: the memory the allocator reserves (from an empty cache) at ``sync_every``
    2 within the resident loop's plus the retained blocks' plus 5 block slices, and at
    least 4 slices under the reservation at ``sync_every`` 0;
    (c) the same prompt again: an LRU hit that moves no encoder; then a 512x512/20
    request at ``stream_flow_offload=False``, its latents the streamed request's and
    the params back on the host; (d) POST /lora load and unload of a LoRA over two
    blocks, fused on the host: the stream state dropped and rebuilt, the host tree
    pinned again, a request after each.

16. training: (a) the rope pass's backward build against its plain version bit for bit
    at L = 4608, 3392 and 1536 (a contiguous and a head-folded strided gradient),
    timed beside its plain version and its bound, and the autograd Function's grads
    against autograd through ``rope_rotate_ref`` on the card; (b) QLoRA at full size:
    ``configs/config-dev-int8.json``'s pipeline (calibrated and warmed by
    ``compile()``, one 512x512/20 request served first), rank-16 adapters on
    ``DEFAULT_ADAPTER_TARGETS``, ``make_lora_train_step`` (AdamW, clip 1.0, remat) at
    512x512, batch 1: one warm step, then, every launch count set to 0 just before and
    read just after, ``TRAIN_STEPS`` timed steps (s/step, steps/s, peak memory, finite
    losses; no K1 launch, 114 rope-pass forwards and 57 backwards per step); every base
    tensor byte-equal before and after; the adapters exported and fused by POST /lora
    into the same pipeline, a 512x512/20 request (57 K1 launches per evaluation,
    latents finite and other than the base's), and the fused serving forward against
    the merged dequantize forward within ``LORA_FUSE_REL_TOL`` in norm, three fused
    int8 weights within half a step of dequant(W) + B·A; fp8 and int4 bases
    drawn from a seed, 2 steps each with finite losses; (e) ``train_lora`` on
    ``config-dev-int8.json`` with 4 PNGs at 512x512 (4 steps, a checkpoint and a
    validation every 2, a train-state directory), resumed to 6 steps, its file loaded
    by POST /lora into (b)'s pipeline; (c) remat on against off at full width with 2 + 4
    blocks at 1024x1024: loss and adapter grads within ``REMAT_REL_TOL``, both peaks;
    (d) full-parameter steps at full width, 2 + 4 blocks, bf16, 1024x1024:
    ``make_train_step`` (SGD) and ``make_optimizer_train_step`` (AdamW, clip 1.0), 2
    steps each, finite losses and params moved.

17. mesh: (a) the rope pass (bit for bit) and K1 (its tolerance) against their plain
    versions at a mesh rank's local shapes of 1024x1024 and 720x1024: tp 2 (12 heads),
    tp 4 (6), sp 2 (24 heads, Lq = L/2 against Lkv = L, both halves of the q tables)
    and tp 2 x sp 2, each timed beside its bound and ``F.scaled_dot_product_attention``;
    then one-rank references of ``configs/config-dev-tp4.json`` (int8) and
    ``configs/config-dev.json`` (fp8), each calibrated, saved prequantized and run at
    1024x1024 for ``MESH_STEPS`` steps from ``MESH_SEED``; (d) a world of one over
    NCCL (``{"dp": 1, "tp": 1}``), its latents bit for bit the fp8 reference's; (b)
    worlds of ranks sharing the one card over gloo, each rank loading its slice from
    the prequantized file: config-dev-tp4.json as 4 ranks, config-dev.json at
    ``{"tp": 2, "sp": 2}`` and at ``{"dp": 2}`` with two images: latents against one
    rank's (int8 bit for bit, fp8 within ``MESH_FP8_REL_TOL``), 57 K1 and rope-pass
    launches per evaluation on every rank at its local shape, each rank's block
    weights at most 1/tp of one rank's, the collectives of the request equal to the
    pinned budget; (c) on the tp 4 world, rank 0's server: POST /generate, POST /lora
    load, POST /generate, /health naming the mesh. Ranks sharing one card time nothing
    of multi-GPU.

18. pp, training and bands on the mesh (phase 17's files and references, or its own):
    (c) the rope pass's backward build at a tp rank's 12 and 6 heads, L = 1536 and
    4608, bit for bit its plain version, timed beside its bound; one rank's QLoRA step
    (int8 file, 512², batch 2, rank 16) and whole 1024² VAE decode and encode; then
    worlds sharing the card over gloo, each rank loading its slice: (a) pp 2 and
    dp 2 x pp 2 (two images; T5 and CLIP offloaded), the fp8 file at full depth, a
    ``MESH_STEPS``-step 1024² request from one rank's conditioning: latents bit for bit
    one rank's at M = 1, dp 2 x pp 2 included (within ``MESH_FP8_REL_TOL`` at M > 1), 19 + 38/S K1 and
    rope-pass launches per rank per evaluation, K1 on, the handoffs equal to the pinned
    budget (``pp_flux_budget``); on pp 2 POST /generate through the first rank and a
    cached request answering 400; (d) on pp 2, full-parameter SGD and AdamW steps at
    2 + 4 blocks, full width, 512², under SDPA's memory-efficient backend, against one
    rank's computed on each rank first, which must repeat itself bit for bit: the loss
    and the block gradients bit for bit, each tensor around the stacks within
    ``PP_TRAIN_REL_TOL`` and, with ∂vec_silu left unsummed over pp (planted), outside
    it, the AdamW step bit for bit AdamW on the pp gradients; (b) tp 2 and dp 2 x tp 2: the QLoRA loss and adapter
    gradients against one rank's within ``QLORA_MESH_LOSS_TOL`` / ``QLORA_MESH_GRAD_TOL``,
    rope-pass forwards and backwards launched, no K1; (e) the 1024² decode in bands over
    tp 4 and dp 2 x tp 2 (pixels' mean |Δ| within ``BAND_PIXEL_MEAN_TOL``), the 1024²
    encode in bands over tp 2 (within ``BAND_REL_TOL``), and on tp 2 a 512² request with
    the three offload flags bit for bit the resident pipeline's.

The last lines are the card line, one JSON object describing each kernel build (its
launches counted in the path of phase 7, 4 or 16; its time, plain time, bound, library
time and error at L = 4608 from phase 3, 4 or 16; K1 and the rope pass also at phase
17's local shapes, the rope pass's backward at phase 18's, under ``mesh_shapes``),
and ``{"ok": true, "device": {...}}``. Phases 7-13 free their pipelines before the
next (phase 7's lives until phase 10 has saved it, and phase 10(a)'s reload until
phase 13 has served it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
# VAE encode, card (bf16 activations and weights, fp32 GroupNorm) vs CPU (fp32):
# ‖a − b‖ / ‖b‖ over the latent. Each bf16 rounding costs up to 2^-8 relative, and the
# encoder chains about 30 convolutions, norms and adds.
AE_ENCODE_REL_TOL = 3e-2
# LoRA fuse of an fp8 Linear vs dequant(W) + delta in fp64: requantization to e4m3
# rounds each element to the nearest step of its binade, at most 2^-4 of its scaled
# magnitude, or half e4m3's subnormal spacing (2^-10) below 2^-6, times the fresh
# weight scale's reciprocal; 2^-20 more covers the fp32 delta, sum and scale products.
E4M3_HALF_STEP_REL, E4M3_HALF_SUBNORMAL = 2**-4 + 2**-20, 2**-10
# diffusers LoRA of phase 12: rank 16, A ~ N(0, 1/in), B ~ N(0, LORA_B_STD²), so that
# B·A has about LORA_B_STD·√16 = 0.25 of a weight's RMS (1/√in for the random init)
LORA_RANK, LORA_B_STD = 16, 0.0625
# phase 14: the North star's gate, fp8 (fast accumulation, the serving default) against
# bf16 by the SSIM of the latent image
FIDELITY_GATE = 0.95
# phase 16(b): the fused serving forward (int8 activations, requantized weights) against
# the merged dequantize forward, ‖a − b‖ / ‖b‖. The JAX package's test of the same
# comparison (tests/test_lora_train.py::test_export_into_quantized_base) holds 2 + 2
# blocks to 0.05 in max|a − b| / max|b|. Over flux-dev's 57 random-weight blocks each of
# the two int8 roundings moves the output by about that much on its own (both printed:
# the int8 activations 3.9% in norm, requantizing W + B·A to a fresh scale 5.1%; NVIDIA
# H100 80GB HBM3, 700 W), so the bound is twice the JAX one, in norm. What the fuse must
# get right, the exported rows in their layout, is checked per weight, to half a step:
LORA_FUSE_REL_TOL = 0.1
# a fused int8 row against dequant(W) + B·A in fp64 (the adapters in the runtime's
# layout): requantization rounds each element to the nearest step of its row's fresh
# scale, at most amax/254, with 1e-3 of that for the fp32 delta and sum
INT8_HALF_STEP = 1.0 / 254 * (1 + 1e-3)
# phase 16(c): remat on against off, ‖a − b‖ / ‖b‖ over the loss and over all adapter
# grads. The two runs do the same bf16 work, but SDPA's backward accumulates dq over
# key tiles with atomics in an order that changes from run to run, and each bf16
# rounding that moves passes through the blocks' backward.
REMAT_REL_TOL = 2e-2
TRAIN_STEPS = 6
TRAIN_CONFIG = ROOT / "configs" / "config-dev-int8.json"


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


def post_any(url: str, body: dict):
    """:func:`post`, with an HTTP error's status, headers and body returned, not raised."""
    import urllib.error

    try:
        return post(url, body)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


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
    once saved, and takes the reloaded pipeline in its place); (b) a BFL float file
    and (c) reference-prequantized files at full width, 2 double + 2 single blocks."""
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
        held["pipe"] = pipe  # served again by phase 12
        del pipe
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


def lora_state_dict(hidden: int, mlp_hidden: int, depth: int, depth_single: int, seed: int):
    """A diffusers-format LoRA over every block's attention and MLP linears, drawn on
    the card from ``seed`` and returned on the host in bf16."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    sd = {}

    def add(stub, in_f, out_f):
        a = torch.randn(LORA_RANK, in_f, generator=gen, device="cuda") * in_f**-0.5
        b = torch.randn(out_f, LORA_RANK, generator=gen, device="cuda") * LORA_B_STD
        sd[f"transformer.{stub}.lora_A.weight"] = a.to(torch.bfloat16).cpu()
        sd[f"transformer.{stub}.lora_B.weight"] = b.to(torch.bfloat16).cpu()

    for i in range(depth):
        bp = f"transformer_blocks.{i}"
        for m in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj", "to_out.0", "to_add_out"):
            add(f"{bp}.attn.{m}", hidden, hidden)
        for ff in ("ff", "ff_context"):
            add(f"{bp}.{ff}.net.0.proj", hidden, mlp_hidden)
            add(f"{bp}.{ff}.net.2", mlp_hidden, hidden)
    for i in range(depth_single):
        bp = f"single_transformer_blocks.{i}"
        for m in ("attn.to_q", "attn.to_k", "attn.to_v"):
            add(f"{bp}.{m}", hidden, hidden)
        add(f"{bp}.proj_mlp", hidden, mlp_hidden)
        add(f"{bp}.proj_out", hidden + mlp_hidden, hidden)
    return sd


def fused_reference(sd, members, before, perm):
    """dequant(W) + delta in fp64 on the host, for a fused layer whose diffusers
    members are ``members``: the factors concatenated, the uneven-rank chunk products
    summed (B @ Σ chunks of A), the rows put into the runtime's rope layout."""
    import torch

    a = torch.cat([sd[f"transformer.{m}.lora_A.weight"] for m in members]).double()
    b = torch.cat([sd[f"transformer.{m}.lora_B.weight"] for m in members]).double()
    delta = b @ a.reshape(len(members), LORA_RANK, -1).sum(0)
    return before + delta[torch.as_tensor(perm)]


def check_fp8_fuse(name: str, lin, ref):
    """The fused fp8 Linear's dequantized weight against the fp64 reference, within
    e4m3 rounding at its fresh scale; → (max |err|, the share of the bound it uses)."""
    import torch

    from flux_fp8_api_tpu_torch.ops.quant import dequantize_kernel

    if lin.kind != "fp8":
        fail("surface", f"{name}: fused into kind {lin.kind}")
    got = dequantize_kernel(lin).double().cpu()
    s_inv = float(lin.w_scale_inv)
    err = (got - ref).abs()
    used = err / (E4M3_HALF_STEP_REL * ref.abs() + E4M3_HALF_SUBNORMAL * s_inv + 1e-12)
    if bool((used > 1).any()):
        fail("surface", f"{name}: {int((used > 1).sum())} fused elements outside e4m3 rounding, "
                        f"max_abs_err {float(err.max())}")
    return float(err.max()), float(used.max())


def phase_request_surface(card: str, pipe):
    """img2img, LoRA hot-load and the FastAPI app on a calibrated full-width pipeline."""
    import base64
    import copy
    import socket
    import threading
    import urllib.request

    import torch
    from PIL import Image

    from flux_fp8_api_tpu_torch.models.autoencoder import ae_encode
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.ops.quant import dequantize_kernel
    from flux_fp8_api_tpu_torch.server import PipelineServer
    from flux_fp8_api_tpu_torch.utils.checkpoint import qkv_out_permutation
    from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors

    t_phase = time.perf_counter()
    cfg = pipe.model_cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    if pipe._needs_calibration:
        fail("surface", "the pipeline is not calibrated")
    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_"))

    def generate(what, body, size, steps):
        before = dict(LAUNCHES)
        t = time.perf_counter()
        status, headers, payload = post(f"{base}/generate", body)
        dt = time.perf_counter() - t
        im = Image.open(io.BytesIO(payload))
        im.load()
        if status != 200 or im.format != "JPEG" or im.size != size or headers.get("x-seed") != str(body["seed"]):
            fail("surface", f"{what}: status {status}, {im.format} {im.size}, x-seed {headers.get('x-seed')}")
        lat = pipe.last_latents
        if lat is None or not bool(torch.isfinite(lat.float()).all()):
            fail("surface", f"{what}: non-finite latents")
        check_path_launches("surface", what, {k: n - before[k] for k, n in LAUNCHES.items()}, blocks * steps)
        return dt, payload, lat.clone()

    def lora(body):
        t = time.perf_counter()
        status, _, payload = post(f"{base}/lora", body)
        if status != 200:
            fail("surface", f"POST /lora {body}: status {status} {payload!r}")
        return time.perf_counter() - t

    def health(url):
        with urllib.request.urlopen(f"{url}/health", timeout=60) as resp:
            return json.loads(resp.read())

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    try:
        for key in LAUNCHES:  # the request surface's run starts here
            LAUNCHES[key] = 0
        body = {"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
                "num_steps": 28, "seed": 41}
        dt, jpeg, unfused = generate("unfused 1024x1024/28", body, (1024, 1024), 28)
        its_unfused = pipe.timings["denoise_it_per_s"]
        print(f"[{card}] (surface) unfused POST /generate 1024x1024 28 steps: {dt:.3f} s/request, "
              f"denoise {its_unfused:.3f} it/s", flush=True)

        # (a) img2img: the JPEG just served, as base64, at strength 0.6
        steps = 28 - int((1 - 0.6) * 28)
        img_body = {"prompt": "a watercolour of a red house", "width": 1024, "height": 1024, "num_steps": 28,
                    "seed": 42, "strength": 0.6, "init_image": base64.b64encode(jpeg).decode()}
        dt, _, _ = generate("img2img 1024x1024 strength 0.6", img_body, (1024, 1024), steps)
        print(f"[{card}] (a) img2img POST /generate 1024x1024, 28 steps at strength 0.6 = {steps} evaluations: "
              f"{dt:.3f} s/request, encode {pipe.timings['encode_seconds']:.3f} s, denoise "
              f"{pipe.timings['denoise_it_per_s']:.3f} it/s, decode {pipe.timings['decode_seconds']:.3f} s", flush=True)
        gen = torch.Generator().manual_seed(43)
        x = torch.rand(1, 512, 512, 3, generator=gen) * 2 - 1
        card_z = ae_encode(pipe.ae_params, pipe.config.ae_params, x.cuda().to(pipe.ae_dtype)).float().cpu()
        cpu_ae = copy.deepcopy(pipe.ae_params).to("cpu", torch.float32)
        cpu_z = ae_encode(cpu_ae, pipe.config.ae_params, x)
        del cpu_ae
        enc_rel = rel(card_z, cpu_z)
        print(f"[{card}] (a) ae_encode 512x512, card ({pipe.ae_dtype}) vs CPU (fp32): latent {tuple(cpu_z.shape)}, "
              f"norm_rel_err {enc_rel:.3e} (tol {AE_ENCODE_REL_TOL})", flush=True)
        if not (bool(torch.isfinite(card_z).all()) and enc_rel <= AE_ENCODE_REL_TOL):
            fail("surface", f"ae_encode card vs CPU relative error {enc_rel}")

        # (b) LoRA
        model = pipe.model_params
        sd = lora_state_dict(cfg.hidden_size, cfg.mlp_hidden, cfg.depth, cfg.depth_single_blocks, seed=44)
        path = tmp / "smoke-lora.safetensors"
        save_safetensors(path, sd)
        leaves = {"double_blocks.0.img_attn_qkv": (model["double_blocks"][0], "img_attn_qkv",
                                                   [f"transformer_blocks.0.attn.{m}" for m in ("to_q", "to_k", "to_v")],
                                                   qkv_out_permutation(cfg.hidden_size, cfg.head_dim)),
                  "single_blocks.37.linear1": (model["single_blocks"][37], "linear1",
                                               [f"single_transformer_blocks.37.{m}" for m in
                                                ("attn.to_q", "attn.to_k", "attn.to_v", "proj_mlp")],
                                               qkv_out_permutation(cfg.hidden_size, cfg.head_dim, extra=cfg.mlp_hidden))}
        before = {k: dequantize_kernel(parent[name]).double().cpu() for k, (parent, name, _, _) in leaves.items()}
        in_scales = {k: parent[name].in_scale.clone() for k, (parent, name, _, _) in leaves.items()}
        load_s = lora({"action": "load", "path": str(path), "scale": 1.0, "name": "smoke"})
        if health(base)["loras"] != ["smoke"]:
            fail("surface", f"/health after the load: {health(base)}")
        for k, (parent, name, members, perm) in leaves.items():
            lin = parent[name]
            if not torch.equal(lin.in_scale, in_scales[k]):
                fail("surface", f"{k}: the fuse changed the calibrated input scale")
            err, used = check_fp8_fuse(k, lin, fused_reference(sd, members, before[k], perm))
            print(f"[{card}] (b) {k} fused: max_abs_err {err:.3e} vs dequant(W) + delta in fp64 (the worst "
                  f"element uses {used:.3f} of its e4m3 rounding)", flush=True)
        dt, _, fused = generate("LoRA-fused 1024x1024/28", body, (1024, 1024), 28)
        its_fused = pipe.timings["denoise_it_per_s"]
        fused_rel = rel(fused, unfused)
        if not fused_rel > 1e-2:
            fail("surface", f"the fused request's latents are the unfused ones (rel {fused_rel})")
        q_before = {k: parent[name].q.clone() for k, (parent, name, _, _) in leaves.items()}
        same_s = lora({"action": "load", "path": str(path), "scale": 1.0})
        for k, (parent, name, _, _) in leaves.items():
            if not torch.equal(parent[name].q.view(torch.uint8), q_before[k].view(torch.uint8)):
                fail("surface", f"{k}: a reload at the same scale changed the weights")
        rescale_s = lora({"action": "load", "path": str(path), "scale": 0.5})
        if [e.scale for e in pipe.loras] != [0.5] or all(
                torch.equal(parent[name].q.view(torch.uint8), q_before[k].view(torch.uint8))
                for k, (parent, name, _, _) in leaves.items()):
            fail("surface", f"the rescale did not rescale: {[(e.name, e.scale) for e in pipe.loras]}")
        unload_s = lora({"action": "unload", "name": "smoke"})
        if health(base)["loras"] != []:
            fail("surface", f"/health after the unload: {health(base)}")
        _, _, restored = generate("unloaded 1024x1024/28", body, (1024, 1024), 28)
        restored_rel = rel(restored, unfused)
        print(f"[{card}] (b) LoRA rank {LORA_RANK} on every block's attention and MLP linears "
              f"({len(sd) // 2} factor pairs, {path.stat().st_size} bytes): POST /lora load {load_s:.3f} s, "
              f"reload at the same scale {same_s:.3f} s (weights unchanged), rescale {rescale_s:.3f} s, unload "
              f"{unload_s:.3f} s; fused 1024x1024/28 {dt:.3f} s/request, denoise {its_fused:.3f} it/s (unfused "
              f"{its_unfused:.3f}); latents vs unfused: fused {fused_rel:.3e}, after load/rescale/unload "
              f"{restored_rel:.3e} (must be under half the fused one)", flush=True)
        if not restored_rel < 0.5 * fused_rel:
            fail("surface", f"unloading did not bring the latents back: {restored_rel} vs fused {fused_rel}")
    finally:
        server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) the FastAPI app under uvicorn; a missing fastapi or uvicorn fails the phase
    import uvicorn

    from flux_fp8_api_tpu_torch import api

    api.app.state.model = pipe
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    uv = uvicorn.Server(uvicorn.Config(api.app, host="127.0.0.1", port=port, log_level="warning"))
    thread = threading.Thread(target=uv.run, daemon=True)
    thread.start()
    try:
        deadline = time.perf_counter() + 60
        while not uv.started:
            if time.perf_counter() > deadline or not thread.is_alive():
                fail("surface", "uvicorn did not start")
            time.sleep(0.1)
        url = f"http://127.0.0.1:{port}"
        if health(url) != {"status": "ok", "model": pipe.name, "loras": []}:
            fail("surface", f"FastAPI /health: {health(url)}")
        with urllib.request.urlopen(f"{url}/", timeout=60) as resp:
            page = resp.read().decode()
            if resp.status != 200 or not page.startswith("<!doctype html>"):
                fail("surface", f"FastAPI GET /: {resp.status}")
        base = url
        small = {"prompt": "a blue sky", "width": 512, "height": 512, "num_steps": 20, "seed": 45}
        dt, _, _ = generate("FastAPI 512x512/20", small, (512, 512), 20)
        lora_path = Path(tempfile.mkdtemp(prefix="chip_smoke_lora_")) / "api-lora.safetensors"
        try:
            save_safetensors(lora_path, lora_state_dict(cfg.hidden_size, cfg.mlp_hidden, 1, 0, seed=46))
            lora({"action": "load", "path": str(lora_path), "scale": 1.0})
            names = health(url)["loras"]
            lora({"action": "unload", "name": "api-lora.safetensors"})
        finally:
            shutil.rmtree(lora_path.parent, ignore_errors=True)
        if names != ["api-lora.safetensors"] or health(url)["loras"] != []:
            fail("surface", f"FastAPI /lora: loaded {names}, then {health(url)['loras']}")
        print(f"[{card}] (c) FastAPI app under uvicorn {uvicorn.__version__}: GET /health, GET / ({len(page)} bytes), "
              f"POST /generate 512x512 20 steps {dt:.3f} s/request (denoise {pipe.timings['denoise_it_per_s']:.3f} "
              f"it/s), POST /lora load and unload", flush=True)
    finally:
        uv.should_exit = True
        thread.join(timeout=30)
        api.app.state.model = api.app.state.server.pipeline = None  # the app holds no pipeline after
    if thread.is_alive():
        fail("surface", "uvicorn did not stop")
    launches = dict(LAUNCHES)  # read just after the request surface's run
    print(f"[{card}] request surface launches: {launches}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def phase_step_cache(card: str, pipe):
    """The step cache through POST /generate, each request's launches counted alone,
    then the bench_cache sweep on the pipeline's model."""
    import torch
    from PIL import Image

    from flux_fp8_api_tpu_torch import bench_cache
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.server import PipelineServer

    t_phase = time.perf_counter()
    cfg = pipe.model_cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    steps = 28
    body = {"prompt": "a photo of a red house on a hill", "width": 1024, "height": 1024,
            "num_steps": steps, "seed": 51}
    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()

    def request(name, cache):
        for key in LAUNCHES:  # this request's run starts here
            LAUNCHES[key] = 0
        t = time.perf_counter()
        status, _, payload = post(f"http://127.0.0.1:{server.port}/generate",
                                  body if cache is None else {**body, "cache": cache})
        dt = time.perf_counter() - t
        launched = dict(LAUNCHES)  # read just after
        im = Image.open(io.BytesIO(payload))
        im.load()
        if status != 200 or im.format != "JPEG" or im.size != (1024, 1024):
            fail("step cache", f"{name}: status {status}, {im.format} {im.size}")
        lat = pipe.last_latents
        if lat is None or not bool(torch.isfinite(lat.float()).all()):
            fail("step cache", f"{name}: non-finite latents")
        evals = pipe.timings.get("cache_model_evals")
        if (evals is None) != (cache is None):
            fail("step cache", f"{name}: timings cache_model_evals {evals}")
        evals = steps if evals is None else evals
        check_path_launches("step cache", name, launched, blocks * evals)
        its, denoise_s = pipe.timings["denoise_it_per_s"], pipe.timings["denoise_seconds"]
        print(f"[{card}] (step cache) {name}: {evals} evaluations, {launched['qknorm_attention']} K1 and "
              f"{launched['rope_rotate']} rope-pass launches; {dt:.3f} s/request, denoise {denoise_s:.3f} s "
              f"= {its:.3f} it/s effective", flush=True)
        return {"lat": lat.clone(), "evals": evals, "denoise_s": denoise_s}

    try:
        # (a) every step evaluated, three ways: the same latents bit for bit
        full = [("uncached", None), ("dynamic threshold 0", {"mode": "dynamic", "threshold": 0}),
                ("interval 1", {"mode": "interval", "interval": 1})]
        runs = [(name, request(name, cache)) for name, cache in full]
        for name, r in runs:
            if r["evals"] != steps or not torch.equal(r["lat"], runs[0][1]["lat"]):
                diff = float((r["lat"].float() - runs[0][1]["lat"].float()).abs().max())
                fail("step cache", f"{name}: {r['evals']} evaluations, latents differ from uncached by {diff}")
        print(f"[{card}] (a) uncached, dynamic threshold 0 and interval 1: {steps} evaluations each, latents bit "
              f"for bit equal", flush=True)

        # (b), (c) interval 3, order 0 and 1
        b = request("interval 3", {"mode": "interval", "interval": 3})
        c = request("interval 3 order 1", {"mode": "interval", "interval": 3, "order": 1})
        if b["evals"] != 11 or c["evals"] != 11:
            fail("step cache", f"interval 3: {b['evals']} and {c['evals']} evaluations, expected 11 (steps 0, 1, 27; "
                               f"3, 6, ..., 24)")
        if torch.equal(b["lat"], c["lat"]):
            fail("step cache", "order 1 gave the latents of order 0")
        rel = lambda x, y: float((x.float() - y.float()).norm() / y.float().norm())  # noqa: E731
        print(f"[{card}] (b, c) interval 3: 11 evaluations = {blocks * 11} K1 and rope-pass launches each; "
              f"latents vs uncached: order 0 {rel(b['lat'], runs[0][1]['lat']):.4e}, order 1 "
              f"{rel(c['lat'], runs[0][1]['lat']):.4e} (relative norm)", flush=True)

        # (d) dynamic at the web page's threshold
        d = request("dynamic threshold 0.4", {"mode": "dynamic", "threshold": 0.4})
        if not 3 <= d["evals"] <= steps:
            fail("step cache", f"dynamic 0.4: {d['evals']} evaluations")
    finally:
        server.shutdown()

    dynamic_sync_cost(card, pipe.model_params, cfg)

    for key in LAUNCHES:  # the sweep's run starts here
        LAUNCHES[key] = 0
    summary = bench_cache.run(pipe.model_params, cfg, 1024, 1024, steps)
    launches = dict(LAUNCHES)
    print(json.dumps(summary), flush=True)
    evals = 2 * steps + sum(r["evals"] for r in summary["detail"]["rows"])  # warm + timed uncached
    check_path_launches("step cache", "bench_cache.run", launches, blocks * evals)
    print(f"[{card}] (step cache) bench_cache.run: {evals} evaluations, {launches['qknorm_attention']} K1 launches; "
          f"phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def dynamic_sync_cost(card: str, model, cfg) -> None:
    """What one unforced step of the dynamic mode adds at 1024², 512 text tokens: the
    indicator, the drift bookkeeping and the host sync that reads the skip decision.
    Short uncached and dynamic-threshold-0 denoise runs (every step evaluated, so the
    model's work is the same) alternate in ABBA groups, which cancels the card's slow
    drift; the mean of the groups' differences per unforced step, with its standard
    error. The indicator and the drift arithmetic alone are timed on the device (CUDA
    events); the rest of the difference is the card waiting on the host after the sync."""
    import statistics

    import torch

    from flux_fp8_api_tpu_torch import bench_fidelity as bf
    from flux_fp8_api_tpu_torch.models.flux import flux_cache_indicator
    from flux_fp8_api_tpu_torch.sampling import CacheConfig

    steps, groups = 4, 8
    dynamic0 = CacheConfig(mode="dynamic", threshold=0.0, warmup=1, tail=0)  # steps 1-3 unforced
    unforced = steps - 1
    timesteps = bf.linear_schedule(steps)
    with torch.inference_mode():
        x, _, _ = bf.make_inputs(cfg, 1024, 1024, 512, torch.device("cuda"))
        if bf.run_denoise(model, cfg, x, timesteps, dynamic0)[2] != steps:  # also the warm run
            fail("step cache", "dynamic threshold 0 skipped a step")
        diffs = []
        for _ in range(groups):
            a1 = bf.run_denoise(model, cfg, x, timesteps)[1]
            b1 = bf.run_denoise(model, cfg, x, timesteps, dynamic0)[1]
            b2 = bf.run_denoise(model, cfg, x, timesteps, dynamic0)[1]
            a2 = bf.run_denoise(model, cfg, x, timesteps)[1]
            diffs.append(1e3 * (b1 + b2 - a1 - a2) / 2 / unforced)

        t_vec = torch.full((1,), 0.5, device=x["img"].device).to(cfg.dtype)
        g_vec = torch.full((1,), bf.GUIDANCE, device=x["img"].device).to(cfg.dtype) if cfg.guidance_embed else None
        prev = flux_cache_indicator(model, cfg, x["img"], t_vec, x["vec"], g_vec).float()

        def indicator():  # sampling._denoise_cached's work on an unforced dynamic step, before the sync
            ind = flux_cache_indicator(model, cfg, x["img"], t_vec, x["vec"], g_vec).float()
            return ((ind - prev).abs().mean() / (prev.abs().mean() + 1e-8)).abs()

        indicator_ms = cuda_time_ms(indicator, 20)
    mean, se = statistics.mean(diffs), statistics.stdev(diffs) / len(diffs) ** 0.5
    print(f"[{card}] (a) dynamic mode cost per unforced step, {groups} ABBA groups of {steps}-step runs: "
          f"{mean:+.4f} ms, standard error {se:.4f} ms (groups: {', '.join(f'{d:+.3f}' for d in diffs)}); "
          f"indicator and drift on the device {indicator_ms:.4f} ms", flush=True)


def phase_fidelity(card: str):
    """The fidelity gate at full size, from a seed; fails below FIDELITY_GATE."""
    import math

    import torch

    from flux_fp8_api_tpu_torch import bench_fidelity
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES

    t_phase = time.perf_counter()
    steps, params = 28, bench_fidelity.FLUX_DEV
    for key in LAUNCHES:  # the gate's run starts here
        LAUNCHES[key] = 0
    report = bench_fidelity.run(params, torch.device("cuda"), steps=steps)
    launches = dict(LAUNCHES)
    print(json.dumps(report), flush=True)
    tiers = bench_fidelity.TIERS
    # the ground truth's and each tier's steps, and each tier's calibration pass
    evals = steps * (1 + len(tiers)) + len(tiers)
    check_path_launches("fidelity", "bench_fidelity.run", launches,
                        (params.depth + params.depth_single_blocks) * evals)
    if sorted(report["detail"]) != sorted(tiers) or not all(math.isfinite(v) for v in report["detail"].values()):
        fail("fidelity", f"SSIM per tier {report['detail']}")
    value = report["detail"]["fp8_fast_accum"]
    print(f"[{card}] fidelity gate: fp8_fast_accum SSIM {value:.6f} (gate >= {FIDELITY_GATE}); "
          + ", ".join(f"{t} {report['detail'][t]:.6f} / {report['psnr'][t]:.2f} dB" for t in tiers)
          + f"; peak memory {report['peak_memory_gib']:.1f} GiB; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not value >= FIDELITY_GATE:
        fail("fidelity", f"fp8_fast_accum SSIM {value} is below the gate {FIDELITY_GATE}")


OFFLOAD_CONFIG = ROOT / "configs" / "config-dev-offload.json"
# phase 15: device bytes allowed between requests beyond the stream state's top-level
# params, the conditioning LRU and the last latents (allocator rounding, library
# workspaces): far under the smallest weight unit it guards, a single block (142 MB at
# fp8), a T5 block of the 2-layer tower (84 MB at wo_int4) or the VAE (168 MB)
RESIDENT_SLACK = 64 * 2**20
# phase 15's padding of a single block's compute: about 20 ms at the H100's 1.98 GHz,
# longer than a single block's copy (142 MB, about 3 ms at 47 GB/s)
OFFLOAD_PAD_CYCLES = 40_000_000


def host_resident(tree) -> bool:
    """Every buffer of the tree on the host, in page-locked memory."""
    return all(b.device.type == "cpu" and b.is_pinned() for b in tree.buffers())


def phase_offload(card: str):
    """configs/config-dev-offload.json at full width and depth: (a) compile() and a
    streamed 1024x1024/28 request; (b) the streamed loop against the resident one at
    every retain budget, with the copy rates; (c) an LRU hit and the whole-tree round
    trip; (d) POST /lora under offload."""
    import torch

    from flux_fp8_api_tpu_torch import offload as offload_mod
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.ops.schedule import get_schedule
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.sampling import denoise
    from flux_fp8_api_tpu_torch.server import PipelineServer
    from flux_fp8_api_tpu_torch.utils.config import load_config_from_path
    from flux_fp8_api_tpu_torch.utils.loader import load_models_from_config
    from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors
    from flux_fp8_api_tpu_torch.utils.tree import copy_tree_, tree_nbytes, tree_to

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gib, prompt = 2**30, "a photo of a red house on a hill"
    # the GEMM libraries' workspaces on the compute stream exist before the baseline
    a = torch.ones(64, 64, device=dev)
    torch.mm(a.bfloat16(), a.bfloat16())
    torch._scaled_mm(a.to(torch.float8_e4m3fn), a.to(torch.float8_e4m3fn).t(), scale_a=a[0, 0], scale_b=a[0, 0],
                     out_dtype=torch.bfloat16)
    del a
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def zero_launches():
        for key in LAUNCHES:
            LAUNCHES[key] = 0

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    # set-up: the flow drawn on the card, copied into page-locked host memory by the
    # pipeline, then compile(): calibration over the whole tree's round trip, the
    # serving bucket's warm-up streamed
    spec = load_config_from_path(str(OFFLOAD_CONFIG))
    spec.compile_extras = spec.compile_blocks = False  # compile() runs below, timed alone
    zero_launches()
    t = time.perf_counter()
    models = load_models_from_config(spec)
    draw_s = time.perf_counter() - t
    t = time.perf_counter()
    pipe = FluxPipeline(str(spec.version), clip=models.clip, t5=models.t5, model=models.flow,
                        model_cfg=models.flow_cfg, ae=models.ae, config=spec,
                        prequantized=models.flow_prequantized)
    to_host_s = time.perf_counter() - t
    del models
    release()
    cfg = pipe.model_cfg
    blocks = cfg.depth + cfg.depth_single_blocks
    flow_bytes = tree_nbytes(pipe.model_params)
    trees = {"flow": pipe.model_params, "VAE": pipe.ae_params, "T5": pipe.t5.params, "CLIP": pipe.clip.params}
    if not all(host_resident(tree) for tree in trees.values()) or not pipe.t5.stream:
        fail("offload", f"after load: host-resident {[k for k, v in trees.items() if host_resident(v)]}, "
                        f"T5 streamed {pipe.t5.stream}")
    spec.compile_extras = spec.compile_blocks = True
    t = time.perf_counter()
    pipe.compile()
    compile_s = time.perf_counter() - t
    warm = spec.num_scale_trials + (spec.warmup_steps or 24)
    check_path_launches("offload", "compile()", dict(LAUNCHES), blocks * warm)
    host_stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    print(f"[{card}] (offload) {OFFLOAD_CONFIG.name}: flow {flow_bytes / 1e9:.3f} GB on the host; set-up: draw "
          f"(text encoders to pinned memory inside) {draw_s:.3f} s, flow and VAE to pinned host memory "
          f"{to_host_s:.3f} s, compile() (12-step 768x768 calibration over the whole-tree round trip, "
          f"{spec.warmup_steps or 24}-step 720x1024 warm-up streamed) {compile_s:.3f} s; pinned host bytes "
          f"{host_stats.get('allocated_bytes.current', host_stats.get('allocated_bytes', 'not read'))}", flush=True)

    def check_between(what: str):
        """Nothing of a block, the VAE or an encoder on the card between requests."""
        off = [k for k, tree in trees.items() if not host_resident(tree)]
        tops = pipe._stream_state[0] if pipe._stream_state is not None else {}
        expected = (sum(tree_nbytes(v) for v in tops.values() if v is not None)
                    + sum(vec.nbytes + txt.nbytes for vec, txt in pipe._cond_cache.values())
                    + (pipe.last_latents.nbytes if pipe.last_latents is not None else 0))
        held = torch.cuda.memory_allocated() - base
        if off or held - expected > RESIDENT_SLACK:
            live = sorted((b["size"], seg["stream"]) for seg in torch.cuda.memory_snapshot()
                          for b in seg["blocks"] if b["state"] == "active_allocated")[-12:]
            fail("offload", f"{what}: not on the host {off}; the card holds {held} B, expected {expected} B; "
                            f"largest live blocks (bytes, stream) {live}")
        return held, expected

    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    tmp = Path(tempfile.mkdtemp())
    url = f"http://127.0.0.1:{server.port}"

    def generate(what, body, steps):
        from PIL import Image

        zero_launches()
        t = time.perf_counter()
        status, _, payload = post(f"{url}/generate", body)
        dt = time.perf_counter() - t
        launched = dict(LAUNCHES)
        im = Image.open(io.BytesIO(payload))
        im.load()
        lat = pipe.last_latents
        if status != 200 or im.size != (body["width"], body["height"]) or not bool(torch.isfinite(lat.float()).all()):
            fail("offload", f"{what}: status {status}, {im.format} {im.size}, or non-finite latents")
        check_path_launches("offload", what, launched, blocks * steps)
        return dt, lat.clone()

    try:
        # (a) one streamed 1024x1024/28 request, every block retained after step 1
        body = {"prompt": prompt, "width": 1024, "height": 1024, "num_steps": 28, "seed": 61}
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dt, _ = generate("(a) streamed POST /generate 1024x1024/28", body, 28)
        peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        held, expected = check_between("(a)")
        print(f"[{card}] (a) streamed POST /generate 1024x1024 28 steps: {dt:.3f} s/request, denoise "
              f"{pipe.timings['denoise_it_per_s']:.3f} it/s ({pipe.timings['denoise_seconds']:.3f} s), prepare "
              f"{pipe.timings['prepare_seconds']:.3f} s (LRU miss: CLIP moved, T5 streamed), decode (VAE moved) "
              f"{pipe.timings['decode_seconds']:.3f} s, {blocks * 28} K1 and rope-pass launches; memory_allocated "
              f"before {before / gib:.3f} GiB, peak {peak / gib:.3f}, after {after / gib:.3f} (beyond the phase's "
              f"start {held / 2**20:.1f} MiB: top-level params, LRU and latents {expected / 2**20:.1f} MiB)", flush=True)

        # (b) the streamed loop against the resident one on fixed inputs
        with torch.inference_mode():
            tops, dbl, sgl = pipe._ensure_stream_state()
            host = pipe.model_params
            gen = torch.Generator(device=dev)
            gen.manual_seed(62)

            def inputs(size, steps):
                noise = pipe.get_noise(1, size, size, gen)
                ts = get_schedule(steps, noise.shape[-1] * noise.shape[-2] // 4, shift=True)
                img, img_ids, vec, txt, txt_ids = pipe.prepare(noise, prompt)
                return (img, img_ids, txt, txt_ids, vec), ts

            def timed(what, steps, fn, reserved=False):
                """→ (output, seconds, peak bytes above the start: allocated, or with
                ``reserved`` what the allocator reserved from an empty cache, which also
                counts freed blocks that a stream has yet to pass)."""
                torch.cuda.synchronize()
                if reserved:
                    torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_reserved() if reserved else torch.cuda.memory_allocated()
                zero_launches()
                t = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                check_path_launches("offload", what, dict(LAUNCHES), blocks * steps)
                peak = torch.cuda.max_memory_reserved() if reserved else torch.cuda.max_memory_allocated()
                return out, dt, peak - m0

            def streamed(x, ts, retain=None, sync_every=8, reserved=False):
                return timed(f"streamed, retain {retain}, sync_every {sync_every}", len(ts) - 1, lambda: (
                    offload_mod.streamed_denoise(tops, dbl, sgl, dev, *x, ts, 3.5, cfg,
                                                 retain_bytes=retain, sync_every=sync_every)), reserved)

            def resident(tree, x, ts, reserved=False):
                return timed("resident", len(ts) - 1, lambda: denoise(tree, cfg, *x, ts, 3.5), reserved)

            rates = []
            for blk in (dbl[0], dbl[1], sgl[0], sgl[1]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                d = tree_to(blk, dev, non_blocking=True)
                torch.cuda.synchronize()
                rates.append(tree_nbytes(blk) / (time.perf_counter() - t) / 1e9)
                del d
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev_tree = tree_to(host, dev, non_blocking=True)
            torch.cuda.synchronize()
            h2d_s = time.perf_counter() - t
            x, ts28 = inputs(1024, 28)
            r1, r1_s, _ = resident(dev_tree, x, ts28[:2])
            r28, r28_s, r28_peak = resident(dev_tree, x, ts28)
            t = time.perf_counter()
            copy_tree_(host, dev_tree)  # the round trip's way back (the same values)
            d2h_s = time.perf_counter() - t
            del dev_tree, r1
            release()
            x512, ts4 = inputs(512, 4)
            dev_tree = tree_to(host, dev)
            ra, ra_s, ra_peak = resident(dev_tree, x512, ts4)
            rb, _, _ = resident(dev_tree, x512, ts4)
            ra2, _, ra2_reserved = resident(dev_tree, x512, ts4[:3], reserved=True)
            _, _, ra_reserved = resident(dev_tree, x512, ts4, reserved=True)
            del dev_tree
            release()
            floor = float((ra.float() - rb.float()).abs().max())
            # step 1 first with the side stream's allocator pool empty (each block's
            # tensors cudaMalloc'd), then as a server meets it, the pool holding the
            # last request's blocks
            _, s1_cold_s, _ = streamed(x, ts28[:2])
            s1, s1_s, s1_peak = streamed(x, ts28[:2])
            s28, s28_s, s28_peak = streamed(x, ts28)
            mid = sum(tree_nbytes(b) for b in list(dbl) + list(sgl)) // 2
            runs = {"retain 0": streamed(x512, ts4, 0), f"retain {mid / gib:.2f} GiB (mid)": streamed(x512, ts4, mid),
                    "retain 0, sync_every 2": streamed(x512, ts4, 0, 2)}
            # sync_every waits on the compute, as JAX's does: each single block's compute
            # padded by a sleep longer than its copy, so that the copies outrun it
            real_single = offload_mod._single_block
            offload_mod._single_block = lambda *a: (torch.cuda._sleep(OFFLOAD_PAD_CYCLES), real_single(*a))[1]
            try:
                padded = {s: streamed(x512, ts4[:3], 0, s, reserved=True) for s in (0, 2)}
                padded_mid = {s: streamed(x512, ts4, mid, s, reserved=True) for s in (0, 2)}
            finally:
                offload_mod._single_block = real_single
            slice_ = max(offload_mod.slice_nbytes(dbl), offload_mod.slice_nbytes(sgl))
            kept = offload_mod.retained_blocks(dbl, sgl, mid)
            kept_bytes = sum(tree_nbytes(b) for b, k in zip(list(dbl) + list(sgl), kept) if k)
        resident_step, step1, steady = (r28_s - r1_s) / 27, s1_s, (s28_s - s1_s) / 27
        diffs = {"1024x1024/28, retain all": float((s28.float() - r28.float()).abs().max())}
        diffs.update({f"512x512/4, {k}": float((v[0].float() - ra.float()).abs().max()) for k, v in runs.items()})
        print(f"[{card}] (b) host -> card copy of one block (pinned, non_blocking): "
              + ", ".join(f"{r:.2f}" for r in rates) + f" GB/s (double, double, single, single); the whole flow "
              f"{flow_bytes / 1e9:.3f} GB host -> card {h2d_s:.3f} s ({flow_bytes / h2d_s / 1e9:.2f} GB/s), card -> "
              f"host in place {d2h_s:.3f} s ({flow_bytes / d2h_s / 1e9:.2f} GB/s)", flush=True)
        print(f"[{card}] (b) 1024x1024: resident step {resident_step * 1e3:.1f} ms (28 steps {r28_s:.3f} s, "
              f"{28 / r28_s:.3f} it/s, peak {r28_peak / gib:.3f} GiB above the tree); streamed, every block "
              f"retained: step 1 {step1 * 1e3:.1f} ms ({s1_cold_s * 1e3:.1f} ms with the allocator's pool "
              f"empty), steady step {steady * 1e3:.1f} ms (28 steps {s28_s:.3f} s, "
              f"{28 / s28_s:.3f} it/s, peak {s28_peak / gib:.3f} GiB, step 1 alone {s1_peak / gib:.3f} GiB)", flush=True)
        print(f"[{card}] (b) 512x512/4: resident {4 / ra_s:.3f} it/s (peak {ra_peak / gib:.3f} GiB above the tree); "
              + "; ".join(f"streamed {k}: {4 / v[1]:.3f} it/s, peak {v[2] / gib:.3f} GiB" for k, v in runs.items())
              + f"; resident run-to-run max |diff| {floor}", flush=True)
        print(f"[{card}] (b) compute slower than the copies (each single block padded by "
              f"{OFFLOAD_PAD_CYCLES} cycles), 512x512/2, retain 0, reserved peaks from an empty cache: "
              f"{padded[0][2] / gib:.3f} GiB at sync_every 0 ({padded[0][1]:.2f} s), {padded[2][2] / gib:.3f} GiB at "
              f"sync_every 2 ({padded[2][1]:.2f} s) = the resident loop's {ra2_reserved / gib:.3f} GiB + "
              f"{(padded[2][2] - ra2_reserved) / slice_:.2f} block slices of {slice_ / gib:.3f} GiB (bound 5)",
              flush=True)
        print(f"[{card}] (b) the same padding, 512x512/4, retain {mid / gib:.2f} GiB ({sum(kept)} of {len(kept)} "
              f"blocks, {kept_bytes / gib:.3f} GiB): {padded_mid[0][2] / gib:.3f} GiB at sync_every 0 "
              f"({padded_mid[0][1]:.2f} s), {padded_mid[2][2] / gib:.3f} GiB at sync_every 2 ({padded_mid[2][1]:.2f} s) "
              f"= the resident loop's {ra_reserved / gib:.3f} GiB + the retained blocks + "
              f"{(padded_mid[2][2] - ra_reserved - kept_bytes) / slice_:.2f} block slices (bound 5)", flush=True)
        for label, pad, base in (("retain 0", padded, ra2_reserved), ("mid retain", padded_mid, ra_reserved + kept_bytes)):
            if not (pad[2][2] <= base + 5 * slice_ and pad[0][2] >= pad[2][2] + 4 * slice_):
                fail("offload", f"{label}: sync_every 2 does not bound the host's lead over the compute: reserved "
                                f"peaks {pad[0][2]} (sync_every 0) and {pad[2][2]} (sync_every 2), the resident "
                                f"loop's (and the retained blocks') {base}, slice {slice_}")
        diffs.update({f"512x512/2 padded, sync_every {k}": float((v[0].float() - ra2.float()).abs().max())
                      for k, v in padded.items()})
        diffs.update({f"512x512/4 padded, mid retain, sync_every {k}": float((v[0].float() - ra.float()).abs().max())
                      for k, v in padded_mid.items()})
        print(f"[{card}] (b) streamed vs resident latents, max |diff| (must be <= {floor}): {diffs}", flush=True)
        if any(d > floor for d in diffs.values()):
            fail("offload", f"streamed latents differ from the resident ones: {diffs}")
        overlap_bound = h2d_s + resident_step - 0.5 * min(h2d_s, resident_step)
        if not step1 <= overlap_bound:
            fail("offload", f"step 1 {step1:.3f} s: the copies do not overlap the compute (bound {overlap_bound:.3f} s "
                            f"= copy {h2d_s:.3f} + step {resident_step:.3f} - half the smaller)")
        del s1, s28, r28, ra, rb, ra2, runs, padded, padded_mid, x, x512, tops, dbl, sgl  # (d) rebuilds the stream state

        # (c) the same prompt again: the LRU hits and no encoder moves; then the
        # whole-tree round trip (stream_flow_offload=False)
        moves = {"clip": 0, "t5": 0}
        for name in moves:
            enc = getattr(pipe, name)

            def spy(enc=enc, name=name, move=enc.to_device):
                moves[name] += 1
                move()

            enc.to_device = spy
        body = {"prompt": prompt, "width": 512, "height": 512, "num_steps": 20, "seed": 63}
        hit_s, hit_lat = generate("(c) LRU hit 512x512/20", body, 20)
        if moves != {"clip": 0, "t5": 0} or pipe.timings["cond_cache_hits"] != 1:
            fail("offload", f"(c) LRU hit: encoder moves {moves}, timings {pipe.timings}")
        check_between("(c) LRU hit")
        pipe.config.stream_flow_offload = False
        try:
            rt_s, rt_lat = generate("(c) round trip 512x512/20", body, 20)
        finally:
            pipe.config.stream_flow_offload = True
        check_between("(c) round trip")
        if not torch.equal(rt_lat, hit_lat):
            fail("offload", "(c) the round trip's latents differ from the streamed request's")
        print(f"[{card}] (c) LRU hit 512x512/20 (same prompt, no encoder moved: {moves}): {hit_s:.3f} s/request, "
              f"prepare {pipe.timings['prepare_seconds']:.4f} s; stream_flow_offload=False (the whole tree to the "
              f"card and back): {rt_s:.3f} s/request, denoise {pipe.timings['denoise_it_per_s']:.3f} it/s, latents "
              f"equal to the streamed request's, params back on the host", flush=True)

        # (d) POST /lora under offload: the fuse runs on the host tree
        sd = {k: v for k, v in lora_state_dict(cfg.hidden_size, cfg.mlp_hidden, cfg.depth,
                                               cfg.depth_single_blocks, seed=64).items()
              if k.startswith(("transformer.transformer_blocks.0.", "transformer.single_transformer_blocks.37."))}
        path = tmp / "offload-lora.safetensors"
        save_safetensors(path, sd)

        def lora(body):
            t = time.perf_counter()
            status, _, payload = post(f"{url}/lora", body)
            if status != 200:
                fail("offload", f"POST /lora {body}: {status} {payload[:200]!r}")
            return time.perf_counter() - t

        load_s = lora({"action": "load", "path": str(path), "scale": 1.0, "name": "offload"})
        unpinned = sum(1 for b in pipe.model_params.buffers() if not b.is_pinned())
        if pipe._stream_state is not None:
            fail("offload", "(d) the fuse left the stream state in place")
        fused_s, fused_lat = generate("(d) LoRA-fused 512x512/20", body, 20)
        if pipe._stream_state is None or not host_resident(pipe.model_params):
            fail("offload", "(d) the stream state was not rebuilt, or the host tree not pinned again")
        unload_s = lora({"action": "unload", "name": "offload"})
        restored_s, restored_lat = generate("(d) unfused 512x512/20", body, 20)
        check_between("(d)")
        fused_rel = rel(fused_lat, hit_lat)
        restored_rel = rel(restored_lat, hit_lat)
        print(f"[{card}] (d) POST /lora rank {LORA_RANK} over double block 0 and single block 37 "
              f"({len(sd) // 2} factor pairs), fused on the host: load {load_s:.3f} s ({unpinned} host tensors "
              f"left unpinned, pinned again when the stream state was rebuilt), request {fused_s:.3f} s, unload "
              f"{unload_s:.3f} s, request {restored_s:.3f} s; latents vs unfused: fused {fused_rel:.3e}, unloaded "
              f"{restored_rel:.3e}", flush=True)
        if not (fused_rel > 1e-3 and restored_rel < 0.5 * fused_rel):
            fail("offload", f"(d) fused {fused_rel}, unloaded {restored_rel}")
    finally:
        server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{card}] phase offload: {time.perf_counter() - t_phase:.1f} s", flush=True)
    del pipe, trees
    release()


def phase_training(card: str):
    """Phase 16: the rope pass's backward build, QLoRA at flux-dev's full size, the
    train_lora CLI, remat on against off, and full-parameter steps (module docstring)."""
    import logging
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from flux_fp8_api_tpu_torch import train_lora
    from flux_fp8_api_tpu_torch.lora import (
        adapter_tensors, init_lora_adapters, merge_lora_adapters, save_lora_adapters,
    )
    from flux_fp8_api_tpu_torch.models.flux import FluxStatic, flux_apply, init_flux_params, quant_tier
    from flux_fp8_api_tpu_torch.ops.attention import fold_heads
    from flux_fp8_api_tpu_torch.ops.attention_kernel import (
        LAUNCHES, rope_rotate, rope_rotate_backward, rope_rotate_ref, rope_rotate_ref_backward,
    )
    from flux_fp8_api_tpu_torch.ops.quant import dequantize_kernel
    from flux_fp8_api_tpu_torch.parallel.train import (
        adamw, flow_matching_loss, make_dummy_batch, make_lora_train_step, make_optimizer_train_step,
        make_train_step, train_cfg, trainable_tensors,
    )
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.server import PipelineServer
    from flux_fp8_api_tpu_torch.utils.config import FluxParams

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def zero_launches():
        for key in LAUNCHES:
            LAUNCHES[key] = 0

    def finite(x):
        return bool(torch.isfinite(x.float()).all())

    # (a) the backward build at the three serving lengths
    bwd = {}
    for h_img, w_img in ((1024, 1024), (1024, 720), (512, 512)):
        cos, sin = rope_tables(h_img, w_img)
        l = cos.shape[0]
        g = gen(l)
        gq = torch.randn((24, l, 128), generator=g, device=dev).to(torch.bfloat16)
        # k's gradient as a head-folded view of a (1, L, 24, 128) tensor, as B = 1 hands it over
        gk = fold_heads(torch.randn((1, l, 24, 128), generator=g, device=dev).to(torch.bfloat16))
        dq, dk = rope_rotate_backward(gq, gk, cos, sin)
        rq, rk = rope_rotate_ref_backward(gq, cos, sin), rope_rotate_ref_backward(gk, cos, sin)
        torch.cuda.synchronize()
        if not (torch.equal(dq, rq) and torch.equal(dk, rk)):
            err = max(float((dq.float() - rq.float()).abs().max()), float((dk.float() - rk.float()).abs().max()))
            fail("training", f"L={l}: the backward build differs from its plain version (max {err})")
        q = torch.randn((24, l, 128), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
        k = torch.randn((24, l, 128), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
        oq, ok = rope_rotate(q, k, cos, sin)
        got = torch.autograd.grad((oq, ok), (q, k), (gq, gk))
        want = torch.autograd.grad((rope_rotate_ref(q, cos, sin), rope_rotate_ref(k, cos, sin)), (q, k), (gq, gk))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail("training", f"L={l}: the Function's grads differ from autograd through rope_rotate_ref")
        ms = cuda_time_ms(lambda: rope_rotate_backward(gq, gk, cos, sin), 50)
        plain_ms = cuda_time_ms(lambda: (rope_rotate_ref_backward(gq, cos, sin),
                                         rope_rotate_ref_backward(gk, cos, sin)), 5)
        bound_ms, bound_by = rope_bound(24, l)
        bwd[l] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0}
        print(f"[{card}] (a) rope pass backward L={l}: bit for bit its plain version (contiguous gq, "
              f"head-folded strided gk) and the Function's grads autograd's; {ms:.4f} ms (plain {plain_ms:.3f}, "
              f"bound {bound_ms:.4f} ms by {bound_by}, {100 * bound_ms / ms:.0f}% of it)", flush=True)

    # (b) QLoRA at full size on a pipeline that has calibrated and served
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    t = time.perf_counter()
    pipe = FluxPipeline.load_pipeline_from_config_path(str(TRAIN_CONFIG))  # compile() runs here
    cfg, base = pipe.model_cfg, pipe.model_params
    blocks = cfg.depth + cfg.depth_single_blocks
    print(f"[{card}] (b) pipeline from {TRAIN_CONFIG.name}: hidden {cfg.hidden_size}, {cfg.depth}+"
          f"{cfg.depth_single_blocks} blocks, {base['single_blocks'][0]['linear1'].kind}; load + calibrate + warm "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    server = PipelineServer(pipe, host="127.0.0.1", port=0)
    server.start_background()
    url = f"http://127.0.0.1:{server.port}"

    def request(what):
        body = {"prompt": "a photo of a red house on a hill", "width": 512, "height": 512, "num_steps": 20,
                "seed": 51}
        before = dict(LAUNCHES)
        status, _, payload = post(f"{url}/generate", body)
        im = Image.open(io.BytesIO(payload))
        im.load()
        lat = pipe.last_latents
        if status != 200 or im.size != (512, 512) or lat is None or not finite(lat):
            fail("training", f"{what}: status {status}, {im.size}, latents finite {lat is not None and finite(lat)}")
        check_path_launches("training", what, {k: n - before[k] for k, n in LAUNCHES.items()}, blocks * 20)
        return lat.clone()

    def load_lora(path, name):
        status, _, payload = post(f"{url}/lora", {"action": "load", "path": str(path), "scale": 1.0, "name": name})
        with urllib.request.urlopen(f"{url}/health", timeout=60) as resp:
            loaded = json.loads(resp.read())["loras"]
        if status != 200 or name not in loaded:
            fail("training", f"POST /lora {path}: status {status} {payload!r}, /health {loaded}")

    try:
        base_latents = request("base 512x512/20")
        snapshot = {n: b.clone() for n, b in base.named_buffers()}
        adapters = init_lora_adapters(base, 16, gen(160))
        n_adapter = sum(p.numel() for p in adapter_tensors(adapters))
        init, step = make_lora_train_step(cfg, adamw(1e-4), max_grad_norm=1.0)
        opt = init(adapters)
        data = make_dummy_batch(cfg, 1, 64, 64, 512, gen(161))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        adapters, opt, loss = step(adapters, opt, base, data, gen(162))
        first_s, losses = time.perf_counter() - t, [float(loss)]
        zero_launches()  # the training path's run starts here
        t = time.perf_counter()
        for i in range(TRAIN_STEPS):
            adapters, opt, loss = step(adapters, opt, base, data, gen(163 + i))
            losses.append(float(loss))
        dt = (time.perf_counter() - t) / TRAIN_STEPS
        train_launches = dict(LAUNCHES)  # read just after it
        peak = torch.cuda.max_memory_allocated()
        want = {"rope_rotate": 2 * blocks * TRAIN_STEPS, "rope_rotate_backward": blocks * TRAIN_STEPS}
        if {k: n for k, n in train_launches.items() if n} != want:
            fail("training", f"launches over {TRAIN_STEPS} steps {train_launches}, expected {want}")
        if not all(np.isfinite(losses)):
            fail("training", f"non-finite loss: {losses}")
        changed = [n for n, b in base.named_buffers() if not torch.equal(
            b.view(torch.uint8) if b.element_size() == 1 else b,
            snapshot[n].view(torch.uint8) if b.element_size() == 1 else snapshot[n])]
        if changed or sorted(snapshot) != sorted(n for n, _ in base.named_buffers()):
            fail("training", f"the frozen base changed: {changed[:5]}")
        del snapshot
        print(f"[{card}] (b) QLoRA flux-dev int8 base, rank 16 on the default targets ({n_adapter} adapter "
              f"params, {n_adapter * 2 / 1e6:.1f} MB bf16), 512x512 (L = 1536) batch 1, remat, AdamW lr 1e-4 "
              f"+ clip 1.0: first step {first_s:.3f} s, then {dt:.4f} s/step = {1 / dt:.3f} steps/s over "
              f"{TRAIN_STEPS} steps; peak memory {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
              f"before); losses {', '.join(f'{x:.4f}' for x in losses)}; launches {train_launches} = 0 K1, "
              f"{2 * blocks} rope-pass forwards and {blocks} backwards per step; every base tensor "
              f"byte-equal after", flush=True)

        # the trained adapters exported and served: fused by POST /lora into this pipeline
        x = make_dummy_batch(cfg, 1, 64, 64, 512, gen(164))
        half = torch.full((1,), 0.5, device=dev)
        args = (x["latents"], x["img_ids"], x["txt"], x["txt_ids"], half, x["y"], torch.full((1,), 3.5, device=dev))
        with torch.inference_mode():
            merged = flux_apply(merge_lora_adapters(base, adapters), train_cfg(cfg, False, dequant=True), *args)
            # the same adapters as a side branch on the serving path: what only requantization moves
            merged_serving = flux_apply(merge_lora_adapters(base, adapters), cfg, *args)
        path = tmp / "trained.safetensors"
        save_lora_adapters(str(path), adapters, cfg)
        leaves = (("double_blocks", 0, "img_attn_qkv"), ("double_blocks", cfg.depth - 1, "txt_mlp_2"),
                  ("single_blocks", cfg.depth_single_blocks - 1, "linear1"))
        expected = {}
        for stack, i, name in leaves:
            ab = adapters[stack][i][name]
            delta = ab["b"].detach().double() @ ab["a"].detach().double()  # runtime layout
            expected[(stack, i, name)] = (dequantize_kernel(base[stack][i][name]).double() + delta).cpu()
        t = time.perf_counter()
        load_lora(path, "trained")
        load_s = time.perf_counter() - t
        for (stack, i, name), ref in expected.items():
            got = dequantize_kernel(pipe.model_params[stack][i][name]).double().cpu()
            step = ref.abs().amax(dim=1, keepdim=True) * INT8_HALF_STEP
            used = float(((got - ref).abs() / step).max())
            print(f"[{card}] (b) fused {stack}.{i}.{name}: dequant vs dequant(W) + B·A in fp64, the worst "
                  f"element at {used:.3f} of its int8 half step", flush=True)
            if not used <= 1.0:
                fail("training", f"{stack}.{i}.{name}: fused weights off dequant(W) + B·A ({used} half steps)")
        lat = request("the trained LoRA 512x512/20")
        if torch.equal(lat, base_latents):
            fail("training", "the trained LoRA left the served latents as they were")
        with torch.inference_mode():
            fused = flux_apply(pipe.model_params, cfg, *args)
        def max_rel(a, b):
            return float((a.float() - b.float()).abs().max() / b.float().abs().max())

        def norm_rel(a, b):
            return float((a.float() - b.float()).norm() / b.float().norm())

        fuse_rel = norm_rel(fused, merged)
        print(f"[{card}] (b) exported ({path.stat().st_size} bytes) and fused by POST /lora in {load_s:.3f} s; "
              f"512x512/20 served through K1 ({blocks} launches per evaluation), latents vs the base's "
              f"{float((lat - base_latents).float().norm() / base_latents.float().norm()):.3e}; fused serving "
              f"forward vs merged dequantize forward ‖a - b‖/‖b‖ {fuse_rel:.3e} (tol {LORA_FUSE_REL_TOL}), "
              f"max|a - b|/max|b| {max_rel(fused, merged):.3e}; of it, the int8 activations (merged serving vs "
              f"merged dequantize) {norm_rel(merged_serving, merged):.3e} / {max_rel(merged_serving, merged):.3e}, "
              f"the requantization (fused vs merged serving) {norm_rel(fused, merged_serving):.3e} / "
              f"{max_rel(fused, merged_serving):.3e}", flush=True)
        if not fuse_rel < LORA_FUSE_REL_TOL:
            fail("training", f"fused serving forward vs merged forward {fuse_rel}")
        del adapters, opt, merged, merged_serving, fused

        # (e) the CLI end to end, its file loaded into the same pipeline
        data_dir = tmp / "data"
        data_dir.mkdir()
        rng = np.random.default_rng(165)
        for i in range(4):
            Image.fromarray(rng.integers(0, 255, (512, 512, 3), dtype=np.uint8)).save(data_dir / f"item_{i}.png")
        (data_dir / "item_0.txt").write_text("a (red:1.2) house on a hill")
        out, state = tmp / "cli.safetensors", tmp / "state"
        common = ["--config-path", str(TRAIN_CONFIG), "--data-dir", str(data_dir), "--output", str(out),
                  "--rank", "16", "--width", "512", "--height", "512", "--save-every", "2",
                  "--val-every", "2", "--state-dir", str(state)]
        records = []
        handler = logging.Handler()
        handler.emit = lambda r: records.append(r.getMessage())
        cli_log = logging.getLogger(train_lora.__name__)
        cli_log.addHandler(handler)
        cli_log.setLevel(logging.INFO)
        try:
            t = time.perf_counter()
            train_lora.train(common + ["--steps", "4"])
            first_run = time.perf_counter() - t
            written = out.read_bytes()
            t = time.perf_counter()
            train_lora.train(common + ["--steps", "6"])
            resumed_run = time.perf_counter() - t
        finally:
            cli_log.removeHandler(handler)
        vals = [m for m in records if "val loss" in m]
        if len(vals) != 3 or not any("@ step 4" in m for m in records) or out.read_bytes() == written:
            fail("training", f"CLI: validations {vals}, log {records}")
        load_lora(out, "cli")
        print(f"[{card}] (e) train_lora on {TRAIN_CONFIG.name}, 4 PNGs at 512x512 (one held out): 4 steps "
              f"{first_run:.1f} s with load, resumed to 6 {resumed_run:.1f} s; {'; '.join(vals)}; "
              f"{out.stat().st_size} bytes loaded by POST /lora", flush=True)
    finally:
        server.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    del pipe, base
    release()

    # (b) the fp8 and int4 bases, drawn from a seed
    for kind in ("fp8", "int4"):
        model = init_flux_params(cfg, gen(170), leaf_fn=quant_tier(kind))
        adapters = init_lora_adapters(model, 16, gen(171))
        init, step = make_lora_train_step(cfg, adamw(1e-4), max_grad_norm=1.0)
        opt = init(adapters)
        data = make_dummy_batch(cfg, 1, 64, 64, 512, gen(172))
        losses, t = [], time.perf_counter()
        for i in range(2):
            adapters, opt, loss = step(adapters, opt, model, data, gen(173 + i))
            losses.append(float(loss))
        if not all(np.isfinite(losses)):
            fail("training", f"{kind} base: losses {losses}")
        print(f"[{card}] (b) {kind} base ({model['single_blocks'][0]['linear1'].kind}): 2 steps "
              f"{time.perf_counter() - t:.2f} s, losses {losses}", flush=True)
        del model, adapters, opt
        release()

    # (c) remat on against off, and (d) full-parameter steps: flux-dev width, 2 + 4 blocks, 1024x1024
    cut = FluxParams(in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0,
                     num_heads=24, depth=2, depth_single_blocks=4, axes_dim=[16, 56, 56], theta=10_000,
                     qkv_bias=True, guidance_embed=True)
    small = FluxStatic.from_params(cut, use_pallas=False)
    data = make_dummy_batch(small, 1, 128, 128, 512, gen(180))
    model = init_flux_params(small, gen(181), leaf_fn=quant_tier("int8"))
    adapters = init_lora_adapters(model, 16, gen(182))
    with torch.no_grad():
        for entry in (e for stack in adapters.values() for e in stack):
            for ab in entry.values():  # B ≠ 0, so that A gets gradients too
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=gen(183), device=dev) * 1e-2)
    runs = {}
    for remat in (True, False):
        release()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        g = gen(184)
        loss = flow_matching_loss(merge_lora_adapters(model, adapters), train_cfg(small, remat, dequant=True), data, g)
        grads = torch.autograd.grad(loss, adapter_tensors(adapters))
        flat = torch.cat([gr.float().flatten() for gr in grads])
        torch.cuda.synchronize()
        runs[remat] = (float(loss.detach()), flat, (torch.cuda.max_memory_allocated() - base_mem) / 2**30)
        del grads, loss
    (l_on, g_on, p_on), (l_off, g_off, p_off) = runs[True], runs[False]
    loss_rel = abs(l_on - l_off) / abs(l_off)
    grad_rel = float((g_on - g_off).norm() / g_off.norm())
    print(f"[{card}] (c) remat on vs off, int8 QLoRA step, {cut.depth}+{cut.depth_single_blocks} blocks at "
          f"1024x1024 (L = 4608): loss {l_on:.6f} / {l_off:.6f} (rel {loss_rel:.2e}{', bit for bit' if l_on == l_off else ''}), "
          f"adapter grads rel {grad_rel:.2e} (tol {REMAT_REL_TOL}); peak above the weights {p_on:.2f} GiB on, "
          f"{p_off:.2f} GiB off", flush=True)
    if not (loss_rel <= REMAT_REL_TOL and grad_rel <= REMAT_REL_TOL and np.isfinite(l_on)):
        fail("training", f"remat on vs off: loss rel {loss_rel}, grad rel {grad_rel}")
    del model, adapters, runs, g_on, g_off
    release()

    for name in ("sgd", "adamw"):
        model = init_flux_params(small, gen(190), dtype=torch.bfloat16)
        before = [p.detach().clone() for p in trainable_tensors(model)]
        if name == "sgd":
            sgd = make_train_step(small, lr=1e-3)
            run_step = lambda m, i: sgd(m, data, gen(191 + i))[1]  # noqa: E731
        else:
            init, opt_step = make_optimizer_train_step(small, adamw(1e-4), max_grad_norm=1.0)
            opt = init(model)
            run_step = lambda m, i: opt_step(m, opt, data, gen(191 + i))[2]  # noqa: E731
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        losses = [float(run_step(model, i)) for i in range(2)]
        dt = time.perf_counter() - t
        after = trainable_tensors(model)
        moved = sum(int((a != b).sum()) for a, b in zip(after, before))
        total = sum(b.numel() for b in before)
        print(f"[{card}] (d) full-parameter {name} ({'lr 1e-3' if name == 'sgd' else 'AdamW lr 1e-4, clip 1.0'}), "
              f"bf16, {cut.depth}+{cut.depth_single_blocks} blocks ({total} params) at 1024x1024: 2 steps "
              f"{dt:.2f} s, losses {losses}, {moved} of {total} params moved, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        if not (all(np.isfinite(losses)) and moved > 0):
            fail("training", f"full-parameter {name}: losses {losses}, {moved} params moved")
        del model, before, after
        release()
    print(f"[{card}] phase training: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return train_launches, bwd


# ----------------------------------------------------------------------- phase 17: mesh

MESH_STEPS = 2
MESH_SEED = 23
MESH_PROMPT = "a photo of a red house on a hill"
MESH_FP8_SEEDS = (24, 25)  # noise seeds read besides MESH_SEED in the fp8 tp 2 x sp 2 world
TP4_CONFIG = ROOT / "configs" / "config-dev-tp4.json"
# fp8 on a mesh against one rank, ‖a − b‖ / ‖b‖ over the latents after MESH_STEPS steps
# from the same conditioning. A row-parallel fp8 linear reduces _scaled_mm's fp32
# partials over tp and adds the bias once, where one rank adds it inside _scaled_mm;
# wherever the two land one bf16 ulp apart and the next layer's e5m2 cast (2 mantissa
# bits) crosses a boundary, the element moves by up to 25%, and the 57 blocks spread it.
# The reading is a floor that does not depend on the size of the first differences:
# 5.72–5.74e-2 at MESH_SEED and MESH_FP8_SEEDS, 5.70e-2 with fp32 accumulation on both
# sides (NVIDIA H100 80GB HBM3, 700 W; PERF.md). The limit was set after the first
# reading, not predicted. It sees the sp rows gathered out of order (0.138) but not a
# bias added on every tp rank (6.03e-2): the layer check (MESH_LAYER_REL_TOL) does.
MESH_FP8_REL_TOL = 0.1
# the sharded text encoders' (vec, txt) against one rank's, ‖a − b‖ / ‖b‖: a
# row-parallel product sums the ranks' fp32 partials in another order than one rank's
# GEMM sums its products, and where the two fp32 sums straddle a bf16 rounding boundary
# the output lands one ulp (2^-8 relative) apart; the later layers carry that on.
# Measured 3.6e-3 (vec) and 8.9e-3 (txt) (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
MESH_COND_REL_TOL = 2e-2
MESH_E2E_REL_TOL = 0.05
# one sharded Linear against the whole one on the same card and input: each side rounds
# its fp32 result to bf16 once, so no element is more than one bf16 ulp (2^-7 relative
# at most) apart, and the norm of the difference no more than 2^-7 of the output's
MESH_LAYER_REL_TOL = 2**-7
def mesh_flux_budget(shape: dict, quant: str, batch: int = 1, l_txt: int = 512, l_img: int = 4096,
                     hs: int = 3072, heads: int = 24, d: int = 19, s: int = 38) -> dict:
    """The collectives of one evaluation of flux-dev on a rank of ``shape`` (the port's
    pinned budget, tests/test_torch_mesh.py): under tp two bf16 modulation gathers per
    double block and one per single block, and one row-parallel all-reduce per
    proj/mlp_2 (4 per double block) and linear2 (int32 on the int tiers, fp32 on fp8);
    under sp one bf16 gather of the attention's rows per block."""
    tp, sp = shape.get("tp", 1), shape.get("sp", 1)
    out = {}
    if tp > 1:
        red = "int32" if quant in ("int8", "int4") else "float32"
        out[("all_gather", "bfloat16", (batch, 6 * hs // tp))] = 2 * d
        out[("all_gather", "bfloat16", (batch, 3 * hs // tp))] = s
        out[("all_reduce_sum", red, (batch * l_txt, hs))] = 2 * d
        out[("all_reduce_sum", red, (batch * l_img, hs))] = 2 * d
        out[("all_reduce_sum", red, (batch * (l_txt + l_img), hs))] = s
    if sp > 1:
        out[("all_gather", "bfloat16", (batch * heads // tp, (l_txt + l_img) // sp, hs // heads))] = d + s
    return out


def _mesh_spec(config: Path, **overrides):
    """A config file's ModelSpec with fields replaced; compile and warm-up off (the
    worlds time nothing, and calibration runs once, on one rank)."""
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec, load_config_from_path

    fields = {**load_config_from_path(str(config)).model_dump(), "compile_blocks": False,
              "compile_extras": False, "warmup_resolutions": None, **overrides}
    return ModelSpec.model_validate(fields)


def _attention_spy(shapes: list):
    """Record each K1 call's (q shape, k shape) on this rank; → the restore function."""
    from flux_fp8_api_tpu_torch.ops import attention as attention_mod

    real = attention_mod.qknorm_attention

    def spy(q, k, *a, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, *a, **kw)

    attention_mod.qknorm_attention = spy
    return lambda: setattr(attention_mod, "qknorm_attention", real)


def _mesh_rank(job: dict) -> None:
    """One rank of a phase-17 world (started by ``parallel.launch.run_ranks``): its
    pipeline from the prequantized file on the shared card; the prompt through its
    sharded text encoders, held against one rank's conditioning; one ``generate`` on
    every rank from one rank's conditioning, with its launches, K1 shapes, collectives,
    flow bytes and latents written to ``job["out"]``; then, in the serving world, the
    HTTP server on the first rank (a request, a POST /lora load, a request) with the
    others following."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.launch import follower_loop
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    mesh = pmesh.make_mesh(job["mesh"], backend="gloo")
    # gloo stages CUDA tensors through the host: probe each collective the path needs
    axis = next(a for a, n in mesh.shape.items() if n > 1)
    probe = {
        "all_reduce_sum int32": mesh.all_reduce_sum(torch.arange(3, dtype=torch.int32, device=mesh.device), None).tolist(),
        "all_reduce_max float32": mesh.all_reduce_max(torch.full((2,), float(mesh.global_rank), device=mesh.device),
                                                      None).tolist(),
        f"all_gather bf16 over {axis}": mesh.all_gather(
            torch.full((2,), float(mesh.global_rank), device=mesh.device, dtype=torch.bfloat16), axis, 0).float().tolist(),
        "broadcast_object": mesh.broadcast_object({"from": mesh.global_rank}),
    }
    t = time.perf_counter()
    spec = _mesh_spec(Path(job["config"]), ckpt_path=job["ckpt"], prequantized_flow=True, mesh=job["mesh"])
    pipe = FluxPipeline.load_pipeline_from_config(spec, mesh=mesh)
    load_s = time.perf_counter() - t
    one_vec, one_txt = (x.to(mesh.device) for x in torch.load(job["cond"]))
    with torch.inference_mode():
        pmesh.reset_collectives()
        vec, txt = pipe._encode_prompts([MESH_PROMPT])[MESH_PROMPT]
        enc_collectives = {repr(k): v for k, v in pmesh.COLLECTIVES.items()}
        cond_rel = [float((a.float() - b.float()).norm() / b.float().norm()) for a, b in ((vec, one_vec), (txt, one_txt))]
    encode = pipe._encode_prompts
    pipe._encode_prompts = lambda prompts: {p: (one_vec, one_txt) for p in prompts}
    shapes: list = []
    restore = _attention_spy(shapes)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    pmesh.reset_collectives()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.inference_mode():
        pipe.generate(MESH_PROMPT, width=1024, height=1024, num_steps=MESH_STEPS, seed=MESH_SEED,
                      num_images=job["num_images"], silent=True)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    restore()
    blocks = sum(pmesh.sharded_bytes(pipe.model_params[s]) for s in ("double_blocks", "single_blocks"))
    result = {
        "rank": mesh.global_rank, "coords": mesh.coords, "probe": probe, "load_s": load_s, "generate_s": gen_s,
        "launches": dict(LAUNCHES), "shapes": sorted(set(shapes)), "k1_calls": len(shapes),
        "collectives": {repr(k): v for k, v in pmesh.COLLECTIVES.items()}, "encode_collectives": enc_collectives,
        "cond_rel": cond_rel, "flow_bytes": pmesh.sharded_bytes(pipe.model_params), "block_bytes": blocks,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "cfg": {"layout": pipe.model_cfg.fused_layout, "seq": pipe.model_cfg.attn_seq_axis,
                "use_pallas": pipe.model_cfg.use_pallas},
    }
    if mesh.is_root:
        torch.save(pipe.last_latents.cpu(), Path(job["out"]) / "latents.pt")
    # more noise seeds and planted sharding faults from one rank's conditioning, then
    # the whole request through this world's own sharded text encoders
    extra, t = {}, time.perf_counter()
    with torch.inference_mode():
        for seed in job.get("seeds", ()):
            extra[f"seed {seed}"] = _mesh_latents(pipe, job, seed)
        for fault in job.get("faults", ()):
            with _planted(pipe, mesh, fault):
                extra[fault] = _mesh_latents(pipe, job, MESH_SEED)
        if job.get("exact_accum"):  # _scaled_mm's accumulation promoted to fp32
            fast = pipe.model_cfg
            pipe.model_cfg = dataclasses.replace(fast, fp8_fast_accum=False)
            extra["exact accum"] = _mesh_latents(pipe, job, MESH_SEED)
            pipe.model_cfg = fast
        if job.get("layer_check"):
            result["layers"] = _layer_check(pipe, mesh)
            result["layers, bias"] = _layer_check(pipe, mesh, "bias")
        pipe._encode_prompts = encode
        if job.get("end_to_end"):
            extra["end to end"] = _mesh_latents(pipe, job, MESH_SEED)
    result["extra_s"] = time.perf_counter() - t
    if mesh.is_root:
        torch.save(extra, Path(job["out"]) / "extra.pt")
    if job.get("serve"):
        if mesh.is_root:
            result["http"] = _mesh_http(pipe, job)
        else:
            follower_loop(pipe)
    (Path(job["out"]) / f"rank{mesh.global_rank}.json").write_text(json.dumps(result))
    import torch.distributed as dist

    dist.destroy_process_group()


def _mesh_latents(pipe, job: dict, seed: int):
    """One MESH_STEPS-step 1024² request's latents on the host."""
    pipe.generate(MESH_PROMPT, width=1024, height=1024, num_steps=MESH_STEPS, seed=seed,
                  num_images=job["num_images"], silent=True)
    return pipe.last_latents.cpu()


@contextlib.contextmanager
def _planted(pipe, mesh, fault: str):
    """A sharding fault planted on this rank while the block runs, to show that the
    world's comparison sees it: ``"bias"`` adds every row-parallel flow Linear's bias
    on each tp rank (tp times in the reduced sum, not once); ``"sp order"`` gathers the
    sp ranks' attention rows in reverse order."""
    import torch

    from flux_fp8_api_tpu_torch.ops.quant import Linear
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh

    if fault == "bias":
        rows = [m for stack in ("double_blocks", "single_blocks") for m in pipe.model_params[stack].modules()
                if isinstance(m, Linear) and m.shard is not None and m.shard.mode == "row" and m.bias is not None]
        if not rows:
            fail("mesh", "planted bias fault: no row-parallel Linear with a bias on this rank")
        saved = [m.bias.clone() for m in rows]
        for m in rows:
            m.bias.mul_(mesh.size("tp"))
        try:
            yield
        finally:
            for m, b in zip(rows, saved):
                m.bias.copy_(b)
    elif fault == "sp order":
        real = pmesh.Mesh.all_gather

        def reversed_rows(self, t, axis, dim, **kw):
            out = real(self, t, axis, dim, **kw)
            return torch.cat(out.chunk(self.size(axis), dim)[::-1], dim) if axis == "sp" else out

        pmesh.Mesh.all_gather = reversed_rows
        try:
            yield
        finally:
            pmesh.Mesh.all_gather = real
    else:
        raise ValueError(fault)


def _layer_check(pipe, mesh, fault=None) -> dict:
    """Each sharded Linear of the flow's first double and single block on this rank
    (its slice, its collective) against the whole Linear gathered from the tp ranks,
    on the same card and input (64 rows of N(0, 0.1²) in bf16); with ``fault``, the
    slices run with that fault planted and the whole Linears without it. → {leaf:
    ‖a − b‖ / ‖b‖ over this rank's part of the output}."""
    import torch

    from flux_fp8_api_tpu_torch.ops.quant import Linear, linear_apply
    from flux_fp8_api_tpu_torch.parallel.mesh import gather_linear
    from flux_fp8_api_tpu_torch.utils.tree import tree_to

    leaves = [(f"{stack}.0.{leaf}", lin) for stack in ("double_blocks", "single_blocks")
              for leaf, lin in pipe.model_params[stack][0].items() if isinstance(lin, Linear) and lin.shard is not None]
    gen = torch.Generator(device=mesh.device).manual_seed(31)
    fast = pipe.model_cfg.fp8_fast_accum
    wholes, xs, refs = {}, {}, {}
    for name, lin in leaves:
        wholes[name] = tree_to(gather_linear(lin), mesh.device)
        xs[name] = (0.1 * torch.randn(64, wholes[name].in_features, generator=gen, device=mesh.device)).to(torch.bfloat16)
        refs[name] = linear_apply(wholes[name], xs[name], fast_accum=fast)[0].float()
    out = {}
    with _planted(pipe, mesh, fault) if fault else contextlib.nullcontext():
        for name, lin in leaves:
            shard, b = lin.shard, refs[name]
            size, rank = mesh.size(shard.axis), mesh.rank(shard.axis)
            x = xs[name].chunk(size, -1)[rank] if shard.mode == "row" else xs[name]
            a = linear_apply(lin, x, fast_accum=fast)[0].float()
            if shard.mode == "col" and not shard.gather:
                b = b.chunk(size, -1)[rank]
            out[name] = float((a - b).norm() / b.norm())
    return out


def _mesh_http(pipe, job: dict) -> dict:
    """The first rank's server: one request, a POST /lora load, one more request;
    → the statuses and times. The followers are released at the end."""
    from PIL import Image

    from flux_fp8_api_tpu_torch.parallel.launch import MeshPipeline
    from flux_fp8_api_tpu_torch.server import PipelineServer

    front = MeshPipeline(pipe)
    server = PipelineServer(front, host="127.0.0.1", port=0)
    server.start_background()
    out = {}
    try:
        url = f"http://127.0.0.1:{server.port}"
        # another prompt than (b)'s: the LRU misses, and the sharded encoders run
        body = {"prompt": "a lighthouse at dusk", "width": 1024, "height": 1024, "num_steps": MESH_STEPS, "seed": 5}
        for name, path, req in (("generate", "/generate", body),
                                ("lora", "/lora", {"action": "load", "path": job["lora"], "scale": 1.0, "name": "m"}),
                                ("generate after the LoRA", "/generate", body)):
            t = time.perf_counter()
            status, _, payload = post(url + path, req)
            entry = {"status": status, "s": time.perf_counter() - t}
            if path == "/generate":
                im = Image.open(io.BytesIO(payload))
                entry.update(format=im.format, size=list(im.size))
            out[name] = entry
        out["health"] = json.loads(urllib_get(url + "/health"))
    finally:
        server.shutdown()
        front.stop()
    return out


def urllib_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read()


def mesh_kernels(card: str):
    """(a) K1 and the rope pass at the local shapes of tp 2, tp 4, sp 2 (both halves of
    the q tables) and tp 2 × sp 2, at 1024² and 720×1024, against their plain versions;
    each timed beside its bound and F.scaled_dot_product_attention."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import (
        qknorm_attention, qknorm_attention_ref, rope_rotate, rope_rotate_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    d = 128
    scale = d**-0.5

    def normed(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))).to(torch.bfloat16)

    rows = []
    for h_img, w_img in ((1024, 1024), (720, 1024)):
        l = 512 + (h_img // 16) * (w_img // 16)
        cos, sin = rope_tables(h_img, w_img)
        for world, heads, sp in (("tp2", 12, 1), ("tp4", 6, 1), ("sp2", 24, 2), ("tp2xsp2", 12, 2)):
            q, k = normed(heads, l, d), normed(heads, l, d)
            v = torch.randn(heads, l, d, generator=gen, device=dev).to(torch.bfloat16)
            lq = l // sp
            worst = 0.0
            for part in range(sp):  # every sp rank's rows and q tables
                sl = slice(part * lq, (part + 1) * lq)
                qs, cq, sq = q[:, sl], cos[sl].contiguous(), sin[sl].contiguous()
                qr, kr = rope_rotate(qs, k, cos, sin, cq, sq)
                if not (torch.equal(qr, rope_rotate_ref(qs, cq, sq)) and torch.equal(kr, rope_rotate_ref(k, cos, sin))):
                    fail("mesh", f"{world} L={l} rows {part}: the rope pass differs from its plain version")
                out = qknorm_attention(qs, k, v, scale, cos=cos, sin=sin, cos_q=cq, sin_q=sq)
                ref = qknorm_attention_ref(qs, k, v, scale, cos, sin, cq, sq)
                o, r = out.float(), ref.float()
                used = (o - r).abs() / (K1_ATOL + K1_RTOL * r.abs())
                if not bool(torch.isfinite(o).all()) or bool((used > 1).any()):
                    fail("mesh", f"{world} L={l} rows {part}: K1 outside tolerance (worst {float(used.max()):.3f})")
                worst = max(worst, float((o - r).abs().max()))
            flops = 4 * heads * lq * l * d
            nbytes = 2 * heads * d * (2 * lq + 2 * l)
            b_ms, b_by = bound(flops, nbytes)
            # q and k read and written once in bf16; one pair of fp32 tables, and under sp
            # the q rows' own pair
            tables = 2 * 4 * d * (l + (lq if sp > 1 else 0))
            r_ms, r_by = bound(3 * heads * d * (lq + l), 2 * 2 * heads * d * (lq + l) + tables, PEAK_F32_FLOPS)
            k1_ms = cuda_time_ms(lambda: qknorm_attention(qr, kr, v, scale), 20)
            rope_ms = cuda_time_ms(lambda: rope_rotate(qs, k, cos, sin, cq, sq), 50)
            with_rope = cuda_time_ms(lambda: qknorm_attention(qs, k, v, scale, cos=cos, sin=sin, cos_q=cq,
                                                              sin_q=sq), 20)
            lib = library_attention(card, qr, kr, v, scale, qknorm_attention_ref(qr, kr, v, scale))
            row = {"world": world, "heads": heads, "lq": lq, "lkv": l, "k1_ms": k1_ms, "k1_bound_ms": b_ms,
                   "k1_bound_by": b_by, "rope_ms": rope_ms, "rope_bound_ms": r_ms, "rope_bound_by": r_by,
                   "rope_and_k1_ms": with_rope, "sdpa_ms": lib, "k1_max_abs_err": worst}
            rows.append(row)
            lib_s = "none ran" if lib is None else f"{lib:.4f} ms"
            print(f"[{card}] (a) {world} {heads} heads Lq={lq} Lkv={l}: rope pass bit for bit, K1 max_abs_err "
                  f"{worst:.3e}; K1 {k1_ms:.4f} ms ({100 * b_ms / k1_ms:.1f}% of its {b_ms:.4f} ms bound, {b_by}); "
                  f"rope pass {rope_ms:.4f} ms ({100 * r_ms / rope_ms:.1f}% of its {r_ms:.4f} ms bound, {r_by}); "
                  f"rope + K1 {with_rope:.4f} ms; SDPA {lib_s}", flush=True)
    return rows


def mesh_references(card: str, tmp: Path):
    """The one-rank references of phases 17 and 18: the int8 (config-dev-tp4.json) and
    fp8 (config-dev.json) pipelines, each calibrated once and saved prequantized into
    ``tmp`` with one rank's conditioning of MESH_PROMPT, and their MESH_STEPS-step
    1024² latents → (refs, one_bytes)."""
    import torch

    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    refs, one_bytes = {}, {}
    # the one-rank references, each calibrated once and saved for the worlds
    for quant, config in (("int8", TP4_CONFIG), ("fp8", CONFIG)):
        t = time.perf_counter()
        pipe = FluxPipeline.load_pipeline_from_config(_mesh_spec(config, mesh=None))
        pipe.compile()
        pipe.save_prequantized(str(tmp / f"{quant}.safetensors"))
        one_bytes[quant] = (pmesh.sharded_bytes(pipe.model_params),
                            sum(pmesh.sharded_bytes(pipe.model_params[s]) for s in ("double_blocks", "single_blocks")))
        with torch.inference_mode():
            torch.save([x.cpu() for x in pipe._encode_prompts([MESH_PROMPT])[MESH_PROMPT]],
                       tmp / f"{quant}-cond.pt")
            runs = [(1, MESH_SEED)] + ([(2, MESH_SEED)] + [(1, s) for s in MESH_FP8_SEEDS] if quant == "fp8" else [])
            for n, seed in runs:
                pipe.generate(MESH_PROMPT, width=1024, height=1024, num_steps=MESH_STEPS, seed=seed,
                              num_images=n, silent=True)
                refs[(quant, n, seed)] = pipe.last_latents.cpu()
            if quant == "fp8":  # the same request with _scaled_mm's accumulation promoted to fp32
                pipe.model_cfg = dataclasses.replace(pipe.model_cfg, fp8_fast_accum=False)
                pipe.generate(MESH_PROMPT, width=1024, height=1024, num_steps=MESH_STEPS, seed=MESH_SEED,
                              silent=True)
                refs[(quant, 1, "exact accum")] = pipe.last_latents.cpu()
        print(f"[{card}] one rank {config.name} ({quant}): calibrated, saved and {MESH_STEPS}-step 1024x1024 "
              f"references in {time.perf_counter() - t:.1f} s; flow {one_bytes[quant][0] / 2**30:.3f} GiB",
              flush=True)
        del pipe
        release()
    return refs, one_bytes


def phase_mesh(card: str, hold: Optional[dict] = None):
    """(a) the kernels at the mesh's local shapes; the one-rank references of the
    int8 (config-dev-tp4.json) and fp8 (config-dev.json) pipelines, calibrated once and
    saved prequantized; (d) a world of one over NCCL against no mesh; (b) the worlds on
    the shared card over gloo; (c) HTTP through the tp 4 world's first rank. With
    ``hold`` (a dict) the temporary directory and the references are kept there for
    phase 18 (its caller removes the directory)."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.launch import free_port, run_ranks
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors

    t_phase = time.perf_counter()
    rows = mesh_kernels(card)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        refs, one_bytes = mesh_references(card, tmp)
        if hold is not None:
            hold.update(tmp=tmp, refs=refs)
        # (d) a world of one over NCCL, bit for bit against no mesh
        import torch.distributed as dist

        mesh = pmesh.make_mesh({"dp": 1, "tp": 1}, backend="nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                               rank=0, world_size=1)
        try:
            pipe = FluxPipeline.load_pipeline_from_config(
                _mesh_spec(CONFIG, ckpt_path=str(tmp / "fp8.safetensors"), prequantized_flow=True,
                           mesh={"dp": 1, "tp": 1}), mesh=mesh)
            with torch.inference_mode():
                pipe.generate(MESH_PROMPT, width=1024, height=1024, num_steps=MESH_STEPS, seed=MESH_SEED, silent=True)
            same = torch.equal(pipe.last_latents.cpu(), refs[("fp8", 1, MESH_SEED)])
            print(f"[{card}] (d) NCCL world of one ({dist.get_backend()}, mesh {mesh.shape}): latents bit for bit "
                  f"against no mesh: {same}", flush=True)
            if not same:
                fail("mesh", "(d) the NCCL world of one differs from the pipeline without a mesh")
            del pipe
        finally:
            dist.destroy_process_group()
            release()

        save_safetensors(str(tmp / "lora.safetensors"), lora_state_dict(3072, 12288, 1, 1, 29))
        # the tp 4 world also serves HTTP and runs the request through its own sharded
        # encoders; the tp 2 x sp 2 world reads more noise seeds and two planted faults
        worlds = (("config-dev-tp4.json (int8), tp 4", TP4_CONFIG, "int8", json.loads(TP4_CONFIG.read_text())["mesh"], 1,
                   {"serve": True, "end_to_end": True}),
                  ("config-dev.json (fp8), tp 2 x sp 2", CONFIG, "fp8", {"tp": 2, "sp": 2}, 1,
                   {"seeds": MESH_FP8_SEEDS, "faults": ("bias", "sp order"), "exact_accum": True,
                    "layer_check": True}),
                  ("config-dev.json (fp8), dp 2, two images", CONFIG, "fp8", {"dp": 2}, 2, {}))
        for what, config, quant, shape, n, extras in worlds:
            out = tmp / f"world{len(shape)}{quant}{n}"
            out.mkdir()
            job = {"config": str(config), "ckpt": str(tmp / f"{quant}.safetensors"), "mesh": shape,
                   "cond": str(tmp / f"{quant}-cond.pt"), "num_images": n, "out": str(out),
                   "lora": str(tmp / "lora.safetensors"), **extras}
            world = math.prod(shape.values())
            t = time.perf_counter()
            run_ranks(_mesh_rank, world, (job,))
            wall = time.perf_counter() - t
            ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
            check_mesh_world(card, what, shape, quant, n, ranks, torch.load(out / "latents.pt"),
                             torch.load(out / "extra.pt"), refs, one_bytes[quant], wall)
    finally:
        if hold is None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{card}] phase mesh: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def check_mesh_world(card, what, shape, quant, n, ranks, latents, extra, refs, one_bytes, wall):
    """A world's checks: the flow's latents from one rank's conditioning against one
    rank's at every seed read (int8 bit for bit, fp8 within MESH_FP8_REL_TOL); each
    planted fault outside that; the sharded text encoders' conditioning against one
    rank's within MESH_COND_REL_TOL, and the whole request through them within
    MESH_E2E_REL_TOL; 57 K1 launches per evaluation on every rank at its local shape;
    each rank's block weights at most 1/tp of one rank's; the collectives of the
    request and of the encode equal to the pinned budget."""
    tp, sp, dp = shape.get("tp", 1), shape.get("sp", 1), shape.get("dp", 1)
    heads, l = 24 // tp * (n // dp), 4608
    evals = MESH_STEPS
    from flux_fp8_api_tpu_torch.bench_fidelity import latent_image
    from flux_fp8_api_tpu_torch.utils.fidelity import ssim

    def rel_to(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    ref = refs[(quant, n, MESH_SEED)]
    rel = rel_to(latents, ref)
    exact = bool((latents == ref).all())
    seeds = {MESH_SEED: rel, **{int(k.split()[1]): rel_to(v, refs[(quant, n, int(k.split()[1]))])
                                for k, v in extra.items() if k.startswith("seed ")}}
    faults = {k: rel_to(v, ref) for k, v in extra.items() if k in ("bias", "sp order")}
    promoted = {k: rel_to(v, refs[(quant, n, "exact accum")]) for k, v in extra.items() if k.startswith("exact accum")}
    whole = rel_to(extra["end to end"], ref) if "end to end" in extra else None
    similarity = ssim(latent_image(latents, 128, 128), latent_image(ref, 128, 128))
    cond = max(max(r["cond_rel"]) for r in ranks)
    print(f"[{card}] (b) {what}: {len(ranks)} ranks on one card over gloo, wall {wall:.1f} s (load "
          f"{max(r['load_s'] for r in ranks):.1f} s, generate {max(r['generate_s'] for r in ranks):.1f} s; ranks "
          f"sharing one card time nothing of multi-GPU); from one rank's conditioning the latents are one rank's "
          f"bit for bit: {exact}, ‖a - b‖/‖b‖ {rel:.3e}, SSIM of the latent image {similarity:.6f}; the sharded text encoders' (vec, txt) against one rank's "
          f"{[r['cond_rel'] for r in ranks]}; collective probe {ranks[0]['probe']}", flush=True)
    if len(seeds) > 1 or faults or whole is not None:
        print(f"[{card}] (b) {what}: ‖a - b‖/‖b‖ from one rank's at seeds {seeds}; planted faults {faults} "
              f"(tol {MESH_FP8_REL_TOL}); the whole request through the sharded encoders "
              + ("not run" if whole is None else f"{whole:.3e} (tol {MESH_E2E_REL_TOL})"), flush=True)
    if promoted:
        print(f"[{card}] (b) {what}: with _scaled_mm's accumulation promoted to fp32 (fp8_fast_accum off) on both "
              f"sides, ‖a - b‖/‖b‖ from one rank's {promoted} (read, not checked)", flush=True)
    worst = ({k: {leaf: max(r[k][leaf] for r in ranks) for leaf in ranks[0][k]} for k in ("layers", "layers, bias")}
             if "layers" in ranks[0] else None)
    if worst:
        print(f"[{card}] (b) {what}: each sharded Linear of block 0 against the whole one gathered from the tp ranks, "
              f"‖a - b‖/‖b‖ (worst rank; tol {MESH_LAYER_REL_TOL}): {worst['layers']}; with the bias added on every "
              f"tp rank: {worst['layers, bias']}", flush=True)
    if quant == "int8" and not exact:
        fail("mesh", f"{what}: int8 latents differ from one rank's ({rel:.3e})")
    if quant != "int8" and not max(seeds.values()) <= MESH_FP8_REL_TOL:
        fail("mesh", f"{what}: fp8 latents {seeds} from one rank's (tol {MESH_FP8_REL_TOL})")
    if worst and not max(worst["layers"].values()) <= MESH_LAYER_REL_TOL:
        fail("mesh", f"{what}: a sharded Linear differs from the whole one: {worst['layers']}")
    if whole is not None and not whole <= MESH_E2E_REL_TOL:
        fail("mesh", f"{what}: the whole request through the sharded encoders is {whole:.3e} from one rank's")
    if not cond <= MESH_COND_REL_TOL:
        fail("mesh", f"{what}: the sharded text encoders' conditioning is {cond:.3e} from one rank's")
    want_shape = [[[heads, l // sp, 128], [heads, l, 128]]]
    budget = {repr(k): v * evals for k, v in mesh_flux_budget(shape, quant, batch=n // dp).items()}
    if dp > 1:  # the latents gathered over dp
        budget[repr(("all_gather", "bfloat16", (n // dp, 4096, 64)))] = 1
    # the prompt's encode under tp: T5 (2 layers, d_model 4096) and CLIP (2 layers, 768),
    # each block's o/out_proj and down-projection reduced in fp32
    enc_budget = {} if tp == 1 else {repr(("all_reduce_sum", "float32", (512, 4096))): 4,
                                     repr(("all_reduce_sum", "float32", (77, 768))): 4}
    for r in ranks:
        # the VAE's bands (phase 18(e)) are counted apart from the flow's budget
        r["collectives"] = {k: v for k, v in r["collectives"].items() if not k.startswith("('band_")}
        got = {k: v for k, v in r["launches"].items() if v}
        if got != {"qknorm_attention": 57 * evals, "rope_rotate": 57 * evals}:
            fail("mesh", f"{what} rank {r['rank']}: launches {got}, expected 57 x {evals} each")
        if [list(map(list, s)) for s in r["shapes"]] != want_shape:
            fail("mesh", f"{what} rank {r['rank']}: K1 shapes {r['shapes']}, expected {want_shape}")
        if r["collectives"] != budget or r["encode_collectives"] != enc_budget:
            fail("mesh", f"{what} rank {r['rank']}: collectives {r['collectives']} and {r['encode_collectives']}, "
                         f"the pinned budget {budget} and {enc_budget}")
        share = r["block_bytes"] / one_bytes[1]
        if not share <= 1 / tp + 0.01:
            fail("mesh", f"{what} rank {r['rank']}: block weights {share:.3f} of one rank's, expected 1/{tp}")
    print(f"[{card}] (b) {what}: every rank 57 K1 and rope-pass launches per evaluation at q {want_shape[0][0]} "
          f"x kv {want_shape[0][1]}; block weights per rank {ranks[0]['block_bytes'] / 2**30:.3f} GiB = "
          f"{ranks[0]['block_bytes'] / one_bytes[1]:.3f} of one rank's, flow {ranks[0]['flow_bytes'] / 2**30:.3f} GiB "
          f"(one rank {one_bytes[0] / 2**30:.3f}); peak {max(r['peak_gib'] for r in ranks):.2f} GiB per rank; "
          f"collectives per rank, request {ranks[0]['collectives']}, encode {ranks[0]['encode_collectives']}",
          flush=True)
    http = ranks[0].get("http")
    if http is not None:
        for name in ("generate", "lora", "generate after the LoRA"):
            e = http[name]
            if e["status"] != 200 or (name != "lora" and (e["format"] != "JPEG" or e["size"] != [1024, 1024])):
                fail("mesh", f"(c) {name} through the first rank: {e}")
        if http["health"].get("mesh", {}).get("shape") != shape or http["health"]["loras"] != ["m"]:
            fail("mesh", f"(c) /health: {http['health']}")
        print(f"[{card}] (c) HTTP on {what}: POST /generate 1024x1024 {http['generate']['s']:.1f} s, POST /lora "
              f"{http['lora']['s']:.1f} s, POST /generate {http['generate after the LoRA']['s']:.1f} s; /health "
              f"{http['health']}", flush=True)
    # each planted fault must read outside the comparison meant to see it: the sp rows
    # out of order in the latents; the bias added on every tp rank at every row-parallel
    # Linear of the layer check (in the latents it reads within MESH_FP8_REL_TOL, PERF.md)
    unseen = {}
    if "sp order" in faults and not faults["sp order"] > MESH_FP8_REL_TOL:
        unseen["sp order"] = faults["sp order"]
    if worst:
        rows = [leaf for leaf in worst["layers, bias"] if leaf.split(".")[-1] in ("img_attn_proj", "txt_attn_proj",
                                                                                  "img_mlp_2", "txt_mlp_2", "linear2")]
        unseen.update({f"bias at {leaf}": worst["layers, bias"][leaf] for leaf in rows
                       if not min(r["layers, bias"][leaf] for r in ranks) > MESH_LAYER_REL_TOL})
    if unseen:
        fail("mesh", f"{what}: planted faults read within their tolerance: {unseen}")


# ------------------------------------------------ phase 18: pp, training and bands on the mesh

# the 2 + 4-block flux-dev cut of phase 16(d): full width, depth cut (full depth needs
# ~24 GB of bf16 weights and ~96 GB with AdamW's moments and the gradients)
CUT_FLUX = dict(in_channels=64, vec_in_dim=768, context_in_dim=4096, hidden_size=3072, mlp_ratio=4.0, num_heads=24,
                depth=2, depth_single_blocks=4, axes_dim=[16, 56, 56], theta=10_000, qkv_bias=True,
                guidance_embed=True)
TRAIN_MESH_SIZE = 512  # the QLoRA and full-parameter steps of phase 18, as phase 16 trains
P18_SIZE = 1024  # the requests, the decode and the encode of phase 18
OFFLOAD_MESH_SIZE = 512  # the request with every offload flag
# QLoRA on a mesh against one rank, from the same batch, draws and adapters (bf16): a
# row-parallel product sums the ranks' fp32 partials where one rank's GEMM sums its
# products, and a dp rank runs one example where one rank runs the batch, so the two
# land an ulp apart here and there. Predicted in PERF.md before the first run: loss
# within 2e-3 relative, the adapter gradients within 3e-2 of one rank's in norm.
QLORA_MESH_LOSS_TOL = 1e-2
QLORA_MESH_GRAD_TOL = 0.1
# pp 2 full-parameter steps against one rank's (bf16, M = 1): a stage runs one rank's
# ops on one rank's shapes, so the blocks' gradients are one rank's bit for bit; the
# stages' ∂vec_silu is summed over pp where one rank accumulates it block by block, so
# the layers before the stacks (the embedders, and through vec every modulation's
# input) move by bf16 ulps. The limit holds each of those tensors on its own (in a
# norm over every gradient the blocks would swamp them); predicted in PERF.md before
# the run that first read it: each within 1e-2 of one rank's, the planted fault above 0.2.
PP_TRAIN_REL_TOL = 5e-2
# the VAE in bands against one rank's whole decode and encode (bf16 convs; a band's
# convs run on other shapes and may take other algorithms): predicted before the
# first run, the decode's mean |Δ| below 0.5 uint8 steps and the encoded latent
# within 1e-2 of one rank's in norm.
BAND_PIXEL_MEAN_TOL = 1.0
BAND_REL_TOL = 5e-2


def mesh_rope_backward(card: str):
    """(c) the rope pass's backward build at a tp rank's heads (12 at tp 2, 6 at tp 4),
    L = 1536 (512²) and 4608 (1024²): bit for bit its plain version, timed beside its
    bound."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention import fold_heads
    from flux_fp8_api_tpu_torch.ops.attention_kernel import rope_rotate_backward, rope_rotate_ref_backward

    dev = torch.device("cuda")
    rows = []
    for size in (512, 1024):
        cos, sin = rope_tables(size, size)
        l = cos.shape[0]
        for world, heads in (("tp2", 12), ("tp4", 6)):
            g = torch.Generator(device=dev).manual_seed(l + heads)
            gq = torch.randn((heads, l, 128), generator=g, device=dev).to(torch.bfloat16)
            gk = fold_heads(torch.randn((1, l, heads, 128), generator=g, device=dev).to(torch.bfloat16))
            dq, dk = rope_rotate_backward(gq, gk, cos, sin)
            if not (torch.equal(dq, rope_rotate_ref_backward(gq, cos, sin))
                    and torch.equal(dk, rope_rotate_ref_backward(gk, cos, sin))):
                fail("pp and training mesh", f"(c) {world} L={l}: the backward build differs from its plain version")
            ms = cuda_time_ms(lambda: rope_rotate_backward(gq, gk, cos, sin), 50)
            plain_ms = cuda_time_ms(lambda: (rope_rotate_ref_backward(gq, cos, sin),
                                             rope_rotate_ref_backward(gk, cos, sin)), 5)
            bound_ms, bound_by = rope_bound(heads, l)
            rows.append({"world": world, "heads": heads, "lq": l, "lkv": l, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0})
            print(f"[{card}] (c) rope pass backward at {world}'s {heads} heads, L={l}: bit for bit its plain "
                  f"version; {ms:.4f} ms (plain {plain_ms:.3f}, bound {bound_ms:.4f} ms by {bound_by}, "
                  f"{100 * bound_ms / ms:.0f}% of it)", flush=True)
    return rows


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _flat_rel(a: dict, b: dict) -> float:
    """‖a − b‖ / ‖b‖ over every tensor of two {name: tensor} maps with the same names."""
    if sorted(a) != sorted(b):
        fail("pp and training mesh", f"tensor names differ: {sorted(set(a) ^ set(b))[:5]}")
    diff = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    return (diff / sum(float(b[k].double().square().sum()) for k in b)) ** 0.5


def _qlora_inputs(cfg, dev):
    """The QLoRA step's batch and draws (512², batch 2, from seeds)."""
    import torch

    from flux_fp8_api_tpu_torch.parallel.train import draw, make_dummy_batch

    g = torch.Generator(device=dev).manual_seed(200)
    batch = make_dummy_batch(cfg, 2, TRAIN_MESH_SIZE // 8, TRAIN_MESH_SIZE // 8, 512, g)
    t, noise = draw(batch, g)
    return batch, t, noise


def mesh_train_references(card: str, tmp: Path) -> dict:
    """One rank's side of (b) and (e), written into ``tmp``: the int8 QLoRA loss and
    adapter gradients (rank 16, B ≠ 0) from the saved int8 file; the VAE's whole
    decode of seeded latents and encode of a seeded 1024² image."""
    import torch

    from flux_fp8_api_tpu_torch.lora import adapter_tensors, init_lora_adapters, merge_lora_adapters
    from flux_fp8_api_tpu_torch.models.autoencoder import ae_decode, ae_encode
    from flux_fp8_api_tpu_torch.parallel.train import flow_matching_loss, train_cfg, whole_tensors
    from flux_fp8_api_tpu_torch.utils.loader import load_autoencoder, load_flow_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    spec = _mesh_spec(TP4_CONFIG, ckpt_path=str(tmp / "int8.safetensors"), prequantized_flow=True, mesh=None)
    model, cfg, _ = load_flow_model(spec)
    adapters = init_lora_adapters(model, 16, torch.Generator(device=dev).manual_seed(201))
    with torch.no_grad():
        g = torch.Generator(device=dev).manual_seed(202)
        for entry in (e for stack in adapters.values() for e in stack):
            for ab in entry.values():  # B ≠ 0, so that A gets gradients too
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=g, device=dev) * 1e-2)
    batch, t, noise = _qlora_inputs(cfg, dev)
    loss = flow_matching_loss(merge_lora_adapters(model, adapters), train_cfg(cfg, True, dequant=True), batch,
                              t=t, noise=noise)
    tensors = adapter_tensors(adapters)
    grads = torch.autograd.grad(loss, tensors)
    names = [n for n, _ in _adapter_names(adapters)]
    ref = {"loss": float(loss.detach()), "grads": {n: gr.cpu() for n, gr in zip(names, grads)},
           "adapters": whole_tensors(adapters)}
    torch.save(ref, tmp / "qlora-ref.pt")
    del model, adapters, grads, loss
    release()

    ae_spec = _mesh_spec(CONFIG, mesh=None)
    ae = load_autoencoder(ae_spec)
    g = torch.Generator(device=dev).manual_seed(210)
    h, z = P18_SIZE // 8, ae_spec.ae_params.z_channels
    latents = torch.randn((1, h, h, z), generator=g, device=dev).to(torch.bfloat16)
    image = (torch.rand((1, P18_SIZE, P18_SIZE, 3), generator=g, device=dev) * 2 - 1).to(torch.bfloat16)
    with torch.inference_mode():
        decoded = ae_decode(ae, ae_spec.ae_params, latents).float()
        encoded = ae_encode(ae, ae_spec.ae_params, image, torch.Generator(device=dev).manual_seed(211)).float()
    torch.save({"latents": latents.cpu(), "image": image.cpu(), "decoded": decoded.cpu(), "encoded": encoded.cpu()},
               tmp / "vae-ref.pt")
    del ae
    release()
    print(f"[{card}] (b, e) one rank's QLoRA step (int8, {TRAIN_MESH_SIZE}², batch 2, loss {ref['loss']:.6f}) "
          f"and whole VAE decode and encode at {P18_SIZE}²: {time.perf_counter() - t0:.1f} s", flush=True)
    return ref


def _adapter_names(adapters):
    """(name, tensor) in ``adapter_tensors``' order."""
    return [(f"{stack}.{i}.{leaf}.{k}", ab[k]) for stack, blocks in adapters.items()
            for i, entry in enumerate(blocks) for leaf, ab in entry.items() for k in ("a", "b")]


def _p18_serve(mesh, job, out: dict) -> None:
    """(a) pp serving on this rank: the pipeline from the fp8 file, a MESH_STEPS-step
    1024² request from one rank's conditioning with its launches and collectives; with
    ``serve``, POST /generate through the first rank and a cached request (400)."""
    import torch

    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.launch import MeshPipeline, follower_loop
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.server import PipelineServer

    t = time.perf_counter()
    spec = _mesh_spec(CONFIG, ckpt_path=job["fp8"], prequantized_flow=True, mesh=job["mesh"],
                      offload_text_encoder=job.get("offload_te", False))
    pipe = FluxPipeline.load_pipeline_from_config(spec, mesh=mesh)
    out["load_s"] = time.perf_counter() - t
    one_vec, one_txt = (x.to(mesh.device) for x in torch.load(job["cond"]))
    encode = pipe._encode_prompts
    pipe._encode_prompts = lambda prompts: {p: (one_vec, one_txt) for p in prompts}
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    pmesh.reset_collectives()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with torch.inference_mode():
        pipe.generate(MESH_PROMPT, width=P18_SIZE, height=P18_SIZE, num_steps=MESH_STEPS, seed=MESH_SEED,
                      num_images=job["num_images"], silent=True)
    torch.cuda.synchronize()
    out.update(generate_s=time.perf_counter() - t, launches=dict(LAUNCHES),
               collectives={repr(k): v for k, v in pmesh.COLLECTIVES.items()},
               blocks={s: len(pipe.model_params[s]) for s in ("double_blocks", "single_blocks")},
               use_pallas=pipe.model_cfg.use_pallas, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if mesh.is_root:
        torch.save(pipe.last_latents.cpu(), Path(job["out"]) / "pp-latents.pt")
    pipe._encode_prompts = encode
    if job.get("serve"):
        if mesh.is_root:
            front = MeshPipeline(pipe)
            server = PipelineServer(front, host="127.0.0.1", port=0)
            server.start_background()
            try:
                from PIL import Image

                url = f"http://127.0.0.1:{server.port}"
                body = {"prompt": "a lighthouse at dusk", "width": P18_SIZE, "height": P18_SIZE,
                        "num_steps": MESH_STEPS, "seed": 5}
                t = time.perf_counter()
                status, _, payload = post(url + "/generate", body)
                im = Image.open(io.BytesIO(payload)) if status == 200 else None
                out["http"] = {"status": status, "s": time.perf_counter() - t,
                               "size": None if im is None else list(im.size)}
                status, _, payload = post_any(url + "/generate", {**body, "cache": {"mode": "interval"}})
                out["http_cached"] = {"status": status, "body": payload.decode(errors="replace")[:200]}
            finally:
                server.shutdown()
                front.stop()
        else:
            follower_loop(pipe)
    del pipe
    release()


def _p18_qlora(mesh, job, out: dict) -> None:
    """(b) one QLoRA step's loss and adapter gradients on this rank's int8 shard, from
    one rank's batch, draws and adapters; the first rank writes them whole."""
    import torch

    from flux_fp8_api_tpu_torch.lora import adapter_tensors, merge_lora_adapters
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.train import (
        dp_loss_and_grads, flow_matching_loss, local_adapters, train_cfg, whole_tensors,
    )
    from flux_fp8_api_tpu_torch.utils.loader import load_flow_model

    t = time.perf_counter()
    spec = _mesh_spec(TP4_CONFIG, ckpt_path=job["int8"], prequantized_flow=True, mesh=job["mesh"])
    model, cfg, _ = load_flow_model(spec, mesh)
    model, cfg = pmesh.setup_flux(model, cfg, mesh)
    ref = torch.load(job["qlora_ref"])
    adapters = local_adapters(ref["adapters"], cfg, mesh.device)
    batch, t_draw, noise = _qlora_inputs(cfg, mesh.device)
    tcfg = train_cfg(cfg, True, dequant=True)
    tensors = adapter_tensors(adapters)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    loss, grads = dp_loss_and_grads(
        lambda b, tt, nn: flow_matching_loss(merge_lora_adapters(model, adapters), tcfg, b, t=tt, noise=nn),
        tensors, mesh, batch, None, "uniform", t_draw, noise)
    torch.cuda.synchronize()
    out["qlora"] = {"s": time.perf_counter() - t, "launches": dict(LAUNCHES), "loss": float(loss)}
    by_id = {id(p): g for p, g in zip(tensors, grads)}
    grad_tree = {s: [{leaf: {k: by_id[id(ab[k])] for k in ("a", "b")} for leaf, ab in e.items()} for e in blocks]
                 for s, blocks in adapters.items()}
    whole = whole_tensors(grad_tree, cfg)
    if mesh.is_root:
        torch.save({"loss": float(loss), "grads": whole}, Path(job["out"]) / "qlora.pt")
    del model, adapters, grads, grad_tree
    release()


def _p18_pp_train(mesh, job, out: dict) -> None:
    """(d) the pp 2 full-parameter SGD and AdamW steps at 2 + 4 blocks, full width,
    against one rank's computed on this rank first (twice: one rank must repeat itself
    bit for bit), all under SDPA's memory-efficient backend, whose backward repeats
    itself (the default cuDNN and the flash backends' do not: PERF.md, PR 12): the
    gradients of this stage's blocks and of the layers around them; the same with
    ∂vec_silu left unsummed over pp (a planted fault); the tensors after one pp AdamW
    step against an AdamW step of the pp gradients."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from flux_fp8_api_tpu_torch.models.flux import FluxStatic, init_flux_params
    from flux_fp8_api_tpu_torch.ops.attention_kernel import LAUNCHES
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.pp import make_pp_runner, make_pp_train_step
    from flux_fp8_api_tpu_torch.parallel.train import (
        StateMap, adamw, dp_loss_and_grads, draw, flat_tensors, flow_matching_loss, make_dummy_batch, train_cfg,
        trainable_tensors,
    )
    from flux_fp8_api_tpu_torch.utils.config import FluxParams

    dev = mesh.device
    small = FluxStatic.from_params(FluxParams(**CUT_FLUX), use_pallas=False)
    g = torch.Generator(device=dev).manual_seed(220)
    batch = make_dummy_batch(small, 1, TRAIN_MESH_SIZE // 8, TRAIN_MESH_SIZE // 8, 512, g)
    t_draw, noise = draw(batch, g)
    keep = {"double_blocks": pmesh.stage_blocks(small.depth, mesh),
            "single_blocks": pmesh.stage_blocks(small.depth_single_blocks, mesh)}

    def init(stage_only: bool):
        return init_flux_params(small, torch.Generator(device=dev).manual_seed(221), torch.bfloat16,
                                keep=keep if stage_only else None)

    def named(model, values, cfg=None) -> dict:
        """{global name: value} of the tree's trainable tensors on this rank, on the card."""
        canon, tensors = StateMap(model, cfg), trainable_tensors(model)
        ids = {id(p): k for k, p in flat_tensors(model).items()}
        return {canon.own(ids[id(p)]): v.detach().clone() for p, v in zip(tensors, values)}

    t = time.perf_counter()
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        model = init(False)
        tensors = trainable_tensors(model)
        runs = []
        for _ in range(2):
            loss, grads = dp_loss_and_grads(
                lambda b, tt, nn: flow_matching_loss(model, train_cfg(small, True), b, t=tt, noise=nn),
                tensors, None, batch, None, "uniform", t_draw, noise)
            runs.append((float(loss), named(model, grads)))
        (ref_loss, ref_grads), (rerun_loss, rerun_grads) = runs
        del model, grads, tensors, runs
        release()

        # the pp stage's
        model, cfg = pmesh.setup_flux(init(True), small, mesh)
        tensors = trainable_tensors(model)
        before = named(model, tensors, cfg)
        runner = make_pp_runner(mesh, 1, remat=True)
        tcfg = dataclasses.replace(train_cfg(cfg, False), mesh=mesh)

        def pp_grads_now() -> tuple:
            for p in tensors:
                p.grad = None
            loss, grads = dp_loss_and_grads(
                lambda b, tt, nn: flow_matching_loss(model, tcfg, b, t=tt, noise=nn, stack_runner=runner),
                tensors, mesh, batch, None, "uniform", t_draw, noise, backward=True)
            out = float(loss), named(model, grads, cfg)  # this stage's and the replicated layers'
            for p in tensors:
                p.grad = None
            return out

        for key in LAUNCHES:
            LAUNCHES[key] = 0
        pp_loss, pp_grads = pp_grads_now()
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        summed = mesh.all_reduce_sum
        # planted fault: each stage keeps its own ∂vec_silu (the pp sum of PPRunner.backward skipped)
        mesh.all_reduce_sum = lambda x, axis: x if axis == "pp" else summed(x, axis)
        try:
            _, fault_grads = pp_grads_now()
        finally:
            del mesh.all_reduce_sum
        _, sgd_loss = make_pp_train_step(cfg, mesh, 1, lr=1e-3)(model, batch, None, t_draw, noise)
        del model, tensors
        release()
        model, cfg = pmesh.setup_flux(init(True), small, mesh)
        opt_init, step = make_pp_train_step(cfg, mesh, 1, adamw(1e-4))
        opt = opt_init(model)
        _, _, ad_loss = step(model, opt, batch, None, t_draw, noise)
        after = named(model, trainable_tensors(model), cfg)
    mine = sorted(pp_grads)
    blocks = [k for k in mine if k.startswith(("double_blocks", "single_blocks"))]
    around = [k for k in mine if k not in blocks]
    # the pp AdamW step against AdamW on the pp gradients, from the same tensors
    expect = [before[k].clone() for k in mine]
    local = adamw(1e-4)(expect)
    for x, k in zip(expect, mine):
        x.grad = pp_grads[k]
    local.step()

    def worst(grads) -> float:
        return max(_rel(grads[k], ref_grads[k]) for k in around if ref_grads[k].float().norm() > 0)

    out["pp_train"] = {
        "s": time.perf_counter() - t, "launches": launches, "loss": pp_loss, "ref_loss": ref_loss,
        "sgd_loss": float(sgd_loss), "adamw_loss": float(ad_loss), "tensors": len(mine), "around": len(around),
        "stage_blocks": {s: list(r) for s, r in keep.items()},
        "rerun_loss": rerun_loss, "rerun_exact": all(torch.equal(rerun_grads[k], ref_grads[k]) for k in ref_grads),
        "block_grads_exact": all(torch.equal(pp_grads[k], ref_grads[k]) for k in blocks),
        "grad_rel": _flat_rel(pp_grads, {k: ref_grads[k] for k in mine}),
        "around_worst_rel": worst(pp_grads), "fault_worst_rel": worst(fault_grads),
        "update_exact": all(torch.equal(after[k], x) for k, x in zip(mine, expect)),
    }
    del model, opt, ref_grads, rerun_grads, before, after, pp_grads, fault_grads, expect, local
    release()


def _p18_vae(mesh, job, out: dict) -> None:
    """(e) the VAE in bands through FluxPipeline: the decode of one rank's latents and,
    with ``encode``, the encode of its image, against one rank's whole ones."""
    import torch

    from flux_fp8_api_tpu_torch.models.autoencoder import ae_encode
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.loader import load_autoencoder

    t = time.perf_counter()
    spec = _mesh_spec(CONFIG, mesh=job["mesh"], ae_device=str(mesh.device))
    ref = torch.load(job["vae_ref"])
    pipe = FluxPipeline("flux-dev", ae=load_autoencoder(spec), config=spec, mesh=mesh)
    res = {}
    with torch.inference_mode():
        lat = ref["latents"].to(mesh.device)
        x = lat.permute(0, 3, 1, 2)  # NCHW
        from flux_fp8_api_tpu_torch.ops.packing import pack_latents

        pixels = pipe.vae_decode(pack_latents(x.float()), P18_SIZE, P18_SIZE)
        want = torch.floor(torch.clamp((torch.clamp(ref["decoded"], -1.0, 1.0) + 1.0) * 127.5, 0, 255)).to(torch.uint8)
        diff = (torch.from_numpy(pixels).short() - want.short()).abs()
        res["decode"] = {"axes": pipe.ae_band_axes(P18_SIZE // 8), "mean": float(diff.float().mean()), "max": int(diff.max())}
        if job.get("encode"):
            band = pipe._bands(P18_SIZE, 2 ** (len(spec.ae_params.ch_mult) - 1))
            img = ref["image"].to(mesh.device)
            z = ae_encode(pipe.ae_params, spec.ae_params, band.rows(img, 1),
                          torch.Generator(device=mesh.device).manual_seed(211), band)
            res["encode"] = {"axes": band.axes, "rel": _rel(z.cpu(), ref["encoded"])}
    res["s"] = time.perf_counter() - t
    out["vae"] = res
    del pipe
    release()


def _p18_offload(mesh, job, out: dict) -> None:
    """(e) a tp 2 request with the three offload flags against the same request on the
    resident tp 2 pipeline (the prompt through the sharded encoders), bit for bit;
    the offloaded flow's shard on the host between requests."""
    import torch

    from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

    t = time.perf_counter()
    spec = _mesh_spec(CONFIG, ckpt_path=job["fp8"], prequantized_flow=True, mesh=job["mesh"])
    pipe = FluxPipeline.load_pipeline_from_config(spec, mesh=mesh)
    body = dict(width=OFFLOAD_MESH_SIZE, height=OFFLOAD_MESH_SIZE, num_steps=MESH_STEPS, seed=7, silent=True)
    with torch.inference_mode():
        resident = pipe.generate(MESH_PROMPT, **body)
        lat = pipe.last_latents.cpu()
    off_spec = _mesh_spec(CONFIG, ckpt_path=job["fp8"], prequantized_flow=True, mesh=job["mesh"],
                          offload_flow=True, offload_vae=True, offload_text_encoder=True)

    def offloaded(enc):
        return TextEncoder(enc.kind, enc.params, enc.config, enc.tokenizer, enc.max_length, enc.dtype, enc.device,
                           offload=True)

    off = FluxPipeline("flux-dev", clip=offloaded(pipe.clip), t5=offloaded(pipe.t5), model=pipe.model_params,
                       model_cfg=pipe.model_cfg, ae=pipe.ae_params, config=off_spec, prequantized=True, mesh=mesh)
    del pipe
    release()
    held = torch.cuda.memory_allocated()
    with torch.inference_mode():
        got = off.generate(MESH_PROMPT, **body)
    host = all(b.device.type == "cpu" for b in off.model_params.buffers())
    out["offload"] = {"s": time.perf_counter() - t, "latents_equal": bool(torch.equal(off.last_latents.cpu(), lat)),
                      "jpeg_equal": (got is None and resident is None) or (got.getvalue() == resident.getvalue()),
                      "host": host, "card_gib_between": held / 2**30}
    del off
    release()


def _phase18_rank(job: dict) -> None:
    """One rank of a phase-18 world: its parts in order, its results in
    ``rank<r>.json``."""
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(job["mesh"], backend="gloo")
    out = {"rank": mesh.global_rank, "coords": mesh.coords}
    parts = {"serve": _p18_serve, "qlora": _p18_qlora, "pp_train": _p18_pp_train, "vae": _p18_vae,
             "offload": _p18_offload}
    out["part_s"] = {}
    for part in job["parts"]:
        t = time.perf_counter()
        parts[part](mesh, job, out)
        out["part_s"][part] = time.perf_counter() - t
    (Path(job["out"]) / f"rank{mesh.global_rank}.json").write_text(json.dumps(out))
    import torch.distributed as dist

    dist.destroy_process_group()


def pp_flux_budget(shape: dict, params, batch: int, l_txt: int, l_img: int) -> list:
    """The collectives of one evaluation of the flow (``params``: its FluxParams) on
    each stage of a pp ``shape``, M = 1 (the pinned budget): per pipelined stack the
    stage's handoff of the (B, L, hidden) bf16 activations to the next stage (send /
    recv: img then txt for the doubles, the joined x for the singles) and the last
    stage's result broadcast to every stage; a stack the stages do not divide runs
    whole on each with none. → [budget of stage 0, stage 1, …]."""
    s, hs = shape["pp"], params.hidden_size
    stacks = ((params.depth, [(batch, l_img, hs), (batch, l_txt, hs)]),
              (params.depth_single_blocks, [(batch, l_txt + l_img, hs)]))
    out = []
    for stage in range(s):
        b: dict = {}
        for depth, carry in stacks:
            if depth % s:
                continue
            for shp in carry:
                for kind, on in (("broadcast", True), ("send", stage < s - 1), ("recv", stage > 0)):
                    if on:
                        b[(kind, "bfloat16", shp)] = b.get((kind, "bfloat16", shp), 0) + 1
        out.append(b)
    return out


def phase_pp_and_training_mesh(card: str, held: Optional[dict] = None):
    """Phase 18 (module docstring): (c) the rope backward at tp-local heads; one rank's
    references; then worlds sharing the card over gloo: pp 2 (a: serving, HTTP and a
    cached request; d: full-parameter steps), dp 2 × pp 2 (a: two images), tp 2 (b:
    QLoRA; e: the img2img encode in bands and the request with every offload) and
    dp 2 × tp 2 (b; e: the decode in bands), tp 4 (e: the decode). ``held``: phase 17's
    temporary directory and references, else they are made here."""
    import torch

    from flux_fp8_api_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    rows = mesh_rope_backward(card)
    own = held is None
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pp_")) if own else held["tmp"]
    try:
        refs = mesh_references(card, tmp)[0] if own else held["refs"]
        qref = mesh_train_references(card, tmp)
        files = {"fp8": str(tmp / "fp8.safetensors"), "int8": str(tmp / "int8.safetensors"),
                 "cond": str(tmp / "fp8-cond.pt"), "qlora_ref": str(tmp / "qlora-ref.pt"),
                 "vae_ref": str(tmp / "vae-ref.pt")}
        worlds = (
            ("pp 2", {"pp": 2}, {"parts": ["serve", "pp_train"], "num_images": 1, "serve": True}),
            ("dp 2 x pp 2, two images", {"dp": 2, "pp": 2}, {"parts": ["serve"], "num_images": 2, "offload_te": True}),
            ("tp 2", {"tp": 2}, {"parts": ["qlora", "vae", "offload"], "encode": True}),
            ("dp 2 x tp 2", {"dp": 2, "tp": 2}, {"parts": ["qlora", "vae"]}),
            ("tp 4", {"tp": 4}, {"parts": ["vae"]}),
        )
        for what, shape, extra in worlds:
            out = tmp / ("p18-" + "-".join(f"{a}{n}" for a, n in shape.items()))
            out.mkdir()
            job = {"mesh": shape, "out": str(out), **files, **extra}
            world = math.prod(shape.values())
            t = time.perf_counter()
            run_ranks(_phase18_rank, world, (job,))
            ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
            check_phase18_world(card, what, shape, job, ranks, refs, qref, time.perf_counter() - t)
    finally:
        if own:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[{card}] phase pp and training mesh: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


def check_phase18_world(card, what, shape, job, ranks, refs, qref, wall):
    """Each part's checks on a phase-18 world (module docstring)."""
    import torch

    out = Path(job["out"])
    parts = {k: round(max(r["part_s"][k] for r in ranks), 1) for k in job["parts"]}
    print(f"[{card}] phase 18 world {what}: {len(ranks)} ranks on one card over gloo, wall {wall:.1f} s, "
          f"parts {parts} s (ranks sharing one card time nothing of multi-GPU)", flush=True)
    if "serve" in job["parts"]:
        n, dp, s = job["num_images"], shape.get("dp", 1), shape["pp"]
        spec = _mesh_spec(CONFIG)
        p, l_img = spec.params, (P18_SIZE // 16) ** 2
        latents = torch.load(out / "pp-latents.pt")
        ref = refs[("fp8", n, MESH_SEED)]
        exact, rel = bool(torch.equal(latents, ref)), _rel(latents, ref)
        budgets = pp_flux_budget(shape, p, n // dp, spec.text_enc_max_length, l_img)
        # each stage's blocks: a depth slice of a stack the stages divide, else all of it
        per_eval = sum(d if d % s else d // s for d in (p.depth, p.depth_single_blocks))
        for r in ranks:
            launches = {k: v for k, v in r["launches"].items() if v}
            if launches != {"qknorm_attention": per_eval * MESH_STEPS, "rope_rotate": per_eval * MESH_STEPS}:
                fail("pp and training mesh", f"(a) {what} rank {r['rank']}: launches {launches}, expected "
                                             f"{per_eval} x {MESH_STEPS} each")
            want = {repr((k, *rest)): v * MESH_STEPS for (k, *rest), v in budgets[r["coords"]["pp"]].items()}
            got = {k: v for k, v in r["collectives"].items() if k.split("'")[1] in ("send", "recv", "broadcast")}
            r["handoffs"] = got
            if got != want:
                fail("pp and training mesh", f"(a) {what} rank {r['rank']}: handoffs {got}, the pinned budget {want}")
            if dp > 1 and r["collectives"].get(repr(("all_gather", "bfloat16", (n // dp, l_img, p.in_channels)))) != 1:
                fail("pp and training mesh", f"(a) {what} rank {r['rank']}: the latents' dp gather {r['collectives']}")
            if not r["use_pallas"]:
                fail("pp and training mesh", f"(a) {what}: K1 is off on a pp stage")
        print(f"[{card}] (a) {what}: latents {'bit for bit' if exact else 'not bit for bit'} one rank's "
              f"(‖a - b‖/‖b‖ {rel:.3e}); every rank {per_eval} K1 and rope-pass launches per evaluation "
              f"({p.depth} + {p.depth_single_blocks}/{s}); "
              f"blocks per stage {ranks[0]['blocks']}; handoffs per rank {[r['handoffs'] for r in ranks]}; load "
              f"{max(r['load_s'] for r in ranks):.1f} s, generate {max(r['generate_s'] for r in ranks):.1f} s, peak "
              f"{max(r['peak_gib'] for r in ranks):.2f} GiB per rank", flush=True)
        if spec.pp_microbatches == 1:  # each stage runs one rank's ops on one rank's shapes
            if not exact:
                fail("pp and training mesh", f"(a) {what}: M = 1 latents differ from one rank's ({rel:.3e})")
        elif not rel <= MESH_FP8_REL_TOL:
            fail("pp and training mesh", f"(a) {what}: latents {rel:.3e} from one rank's (tol {MESH_FP8_REL_TOL})")
        http = ranks[0].get("http")
        if job.get("serve") and http is not None:
            cached = ranks[0]["http_cached"]
            if http["status"] != 200 or http["size"] != [P18_SIZE, P18_SIZE] or cached["status"] != 400 \
                    or "pp" not in cached["body"]:
                fail("pp and training mesh", f"(a) HTTP through the pp world's first rank: {http}, cached {cached}")
            print(f"[{card}] (a) HTTP on {what}: POST /generate {P18_SIZE}x{P18_SIZE} {http['s']:.1f} s; a cached request "
                  f"answers {cached['status']}: {cached['body']}", flush=True)
    if "pp_train" in job["parts"]:
        for r in ranks:
            p = r["pp_train"]
            ok = (p["rerun_exact"] and p["block_grads_exact"] and p["around_worst_rel"] <= PP_TRAIN_REL_TOL
                  and p["fault_worst_rel"] > PP_TRAIN_REL_TOL and p["update_exact"] and p["loss"] == p["ref_loss"]
                  and math.isfinite(p["adamw_loss"]) and math.isfinite(p["sgd_loss"]))
            rope = {k: v for k, v in p["launches"].items() if v}
            print(f"[{card}] (d) {what} stage {r['coords']['pp']} (blocks {p['stage_blocks']}): full-parameter "
                  f"SGD and AdamW steps at 2 + 4 blocks, {TRAIN_MESH_SIZE}², bf16, SDPA memory-efficient: loss "
                  f"{p['loss']:.6f} (one rank {p['ref_loss']:.6f}, again {p['rerun_loss']:.6f}, its gradients bit "
                  f"for bit its own: {p['rerun_exact']}); block gradients bit for bit one rank's: "
                  f"{p['block_grads_exact']}; the {p['around']} tensors around the stacks, worst "
                  f"‖a - b‖/‖b‖ {p['around_worst_rel']:.3e} (tol {PP_TRAIN_REL_TOL}), with ∂vec_silu unsummed over "
                  f"pp (planted) {p['fault_worst_rel']:.3e}; all gradients {p['grad_rel']:.3e}; the AdamW step bit "
                  f"for bit AdamW on the pp gradients: {p['update_exact']}; launches {rope}; {p['s']:.1f} s",
                  flush=True)
            if not ok or not (rope.get("rope_rotate") and rope.get("rope_rotate_backward")) or rope.get("qknorm_attention"):
                fail("pp and training mesh", f"(d) {what} stage {r['coords']['pp']}: {p}")
    if "qlora" in job["parts"]:
        got = torch.load(out / "qlora.pt")
        loss_rel = abs(got["loss"] - qref["loss"]) / abs(qref["loss"])
        grad_rel = _flat_rel(got["grads"], qref["grads"])
        launches = {k: v for k, v in ranks[0]["qlora"]["launches"].items() if v}
        print(f"[{card}] (b) {what}: QLoRA step on the int8 base at {TRAIN_MESH_SIZE}², batch 2, rank 16: loss "
              f"{got['loss']:.6f} vs one rank's {qref['loss']:.6f} (rel {loss_rel:.2e}, tol {QLORA_MESH_LOSS_TOL}); "
              f"adapter gradients ‖a - b‖/‖b‖ {grad_rel:.3e} (tol {QLORA_MESH_GRAD_TOL}); launches per rank "
              f"{launches}; {max(r['qlora']['s'] for r in ranks):.1f} s with the load", flush=True)
        if not (loss_rel <= QLORA_MESH_LOSS_TOL and grad_rel <= QLORA_MESH_GRAD_TOL):
            fail("pp and training mesh", f"(b) {what}: loss rel {loss_rel}, grads rel {grad_rel}")
        if not (launches.get("rope_rotate") and launches.get("rope_rotate_backward")) or launches.get("qknorm_attention"):
            fail("pp and training mesh", f"(b) {what}: launches {launches}")
    if "vae" in job["parts"]:
        for r in ranks:
            v = r["vae"]
            d = v["decode"]
            if d["axes"] is None or d["mean"] > BAND_PIXEL_MEAN_TOL:
                fail("pp and training mesh", f"(e) {what} rank {r['rank']}: band decode {v}")
            if "encode" in v and not v["encode"]["rel"] <= BAND_REL_TOL:
                fail("pp and training mesh", f"(e) {what} rank {r['rank']}: band encode {v}")
        v = ranks[0]["vae"]
        enc = f"; encode over {v['encode']['axes']} ‖a - b‖/‖b‖ {v['encode']['rel']:.3e}" if "encode" in v else ""
        print(f"[{card}] (e) {what}: {P18_SIZE}² decode in bands over {v['decode']['axes']}: pixels mean |Δ| "
              f"{v['decode']['mean']:.4f}, max {v['decode']['max']} from one rank's whole decode{enc}; "
              f"{max(r['vae']['s'] for r in ranks):.1f} s", flush=True)
    if "offload" in job["parts"]:
        for r in ranks:
            o = r["offload"]
            if not (o["latents_equal"] and o["jpeg_equal"] and o["host"]):
                fail("pp and training mesh", f"(e) {what} rank {r['rank']}: offload {o}")
        o = ranks[0]["offload"]
        print(f"[{card}] (e) {what}: a {OFFLOAD_MESH_SIZE}² request with the three offload flags is the resident world's bit for "
              f"bit (latents and JPEG); the flow's shard on the host between requests, "
              f"{o['card_gib_between']:.2f} GiB on the card; {o['s']:.1f} s", flush=True)


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
    pipe = held.pop("pipe")
    phase_request_surface(card_line, pipe)
    phase_step_cache(card_line, pipe)
    del pipe
    release()
    phase_fidelity(card_line)
    phase_offload(card_line)
    train_launches, bwd = phase_training(card_line)
    held: dict = {}
    try:
        mesh_rows = phase_mesh(card_line, held)
        bwd_rows = phase_pp_and_training_mesh(card_line, held)
    finally:
        if "tmp" in held:
            shutil.rmtree(held["tmp"], ignore_errors=True)

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
    # phase 17's local shapes of a mesh rank beside the one-rank row
    shape = ("world", "heads", "lq", "lkv")
    kernels[0]["mesh_shapes"] = [{**{k: m[k] for k in shape}, "ms": m["k1_ms"], "bound_ms": m["k1_bound_ms"],
                                  "bound_by": m["k1_bound_by"], "library_ms": m["sdpa_ms"],
                                  "max_abs_err": m["k1_max_abs_err"]} for m in mesh_rows]
    kernels[1]["mesh_shapes"] = [{**{k: m[k] for k in shape}, "ms": m["rope_ms"], "bound_ms": m["rope_bound_ms"],
                                  "bound_by": m["rope_bound_by"], "max_abs_err": 0.0} for m in mesh_rows]
    for build, source, replaces in (
        ("qknorm_attention_stats", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:109"),
        ("qknorm_attention_ablate_exp", k1_source, "flux_fp8_api_tpu/ops/attention_kernel.py:115"),
        ("bare_two_dot", k1_source, "ablate_attention.py:75"),
    ):
        t = builds[build][4608]
        kernels.append(row(build, source, replaces, path_launches[build], t["max_abs_err"], t))
    kernels.append(row("rope_rotate_backward", "flux_fp8_api_tpu_torch/csrc/rope_rotate.cu",
                       "flux_fp8_api_tpu/ops/rope.py:93", train_launches["rope_rotate_backward"],
                       bwd[4608]["max_abs_err"], bwd[4608]))
    # phase 18's tp-local heads
    kernels[-1]["mesh_shapes"] = [{k: m[k] for k in (*shape, "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
                                  for m in bwd_rows]
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
