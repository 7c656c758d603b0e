"""Host offload on the CPU: the streamed denoise loop (``offload.py``) and the streamed
T5 encode against the JAX package's and against the port's resident versions, the
offloaded text encoders' moves, and the pipeline's placement logic (the three
offloads, calibration over the whole tree, retain budgets, LoRA fuses, the whole-tree
round trip, the conditioning LRU). Tests marked ``cuda`` check on the card what the
CPU cannot show: page-locked host trees, the side stream and the allocator across
streams (``python -m pytest -m cuda --noconftest tests/test_torch_offload.py``).

JAX is imported inside the tests that compare with it, so that the card's tests run
where JAX is not installed.

Tolerances: against JAX in fp32 with ``use_pallas=False`` on both sides (XLA attention
there, the rope pass and SDPA here; neither rounds p to bf16), a relative norm of 1e-5:
fp32 summation order through five blocks and two steps, as in test_torch_flux.py. A
streamed loop runs the resident loop's functions on copies of the same tensors, so
against the port's resident loop it is bit for bit, at any retain budget and
``sync_every``; the streamed T5 likewise against ``t5_encode``.
"""

import sys

import numpy as np
import pytest
import torch

from flux_fp8_api_tpu_torch import offload as toffload
from flux_fp8_api_tpu_torch import sampling as tsampling
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.models import t5 as tt5
from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder
from flux_fp8_api_tpu_torch.ops import packing as tpacking
from flux_fp8_api_tpu_torch.ops.schedule import get_schedule
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils import config as tconfig
from flux_fp8_api_tpu_torch.utils.loader import ToyTokenizer
from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors
from flux_fp8_api_tpu_torch.utils.tree import tree_nbytes

torch.set_num_threads(1)

# the tiny flux and VAE of tests/helpers.py, on the port's schema (helpers imports JAX)
FLUX = dict(in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=64, mlp_ratio=4.0, num_heads=4,
            depth=2, depth_single_blocks=3, axes_dim=[4, 6, 6], theta=10_000, qkv_bias=True, guidance_embed=True)
AE = dict(resolution=64, in_channels=3, ch=32, out_ch=3, ch_mult=[1, 1, 2, 2], num_res_blocks=1, z_channels=4,
          scale_factor=0.3611, shift_factor=0.1159)
T5 = dict(vocab_size=64, d_model=48, d_ff=96, num_layers=3, num_heads=3, d_kv=16)


def spec(**overrides) -> tconfig.ModelSpec:
    fields = dict(version="flux-dev", params=FLUX, ae_params=AE, flux_device="cpu", ae_device="cpu",
                  text_enc_device="cpu", flow_dtype="float32", use_pallas=False)
    fields.update(overrides)
    return tconfig.ModelSpec(**fields)


def _rel(b, a):
    return float(np.linalg.norm(np.asarray(b, np.float64) - a) / np.linalg.norm(a))


def port_cfg(dtype="float32"):
    return tflux.FluxStatic.from_params(tconfig.FluxParams(**FLUX), compute_dtype=dtype, use_pallas=False)


def port_model(cfg, kind=None, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    leaf_fn = tflux.quant_tier(kind) if kind else None
    return tflux.init_flux_params(cfg, gen, torch.float32 if kind is None else torch.bfloat16, leaf_fn)


def inputs(cfg, seed=0, h=8, w=8, txt_len=6, device="cpu", steps=3):
    """(img, img_ids, txt, txt_ids, vec) from numpy, and a ``steps``-step schedule."""
    r = np.random.default_rng(seed)
    noise = torch.from_numpy(r.normal(size=(1, cfg.in_channels // 4, h, w)).astype(np.float32))
    x = (
        tpacking.pack_latents(noise),
        tpacking.make_img_ids(h, w, 1),
        torch.from_numpy(r.normal(size=(1, txt_len, cfg.context_in_dim)).astype(np.float32)),
        tpacking.make_txt_ids(txt_len, 1),
        torch.from_numpy(r.normal(size=(1, cfg.vec_in_dim)).astype(np.float32)),
    )
    return tuple(t.to(device) for t in x), get_schedule(steps, h * w // 4, shift=True)


def streamed(model, cfg, x, ts, device="cpu", **kw):
    tops, dbl, sgl = toffload.split_flow_params(model)
    return toffload.streamed_denoise(toffload.tops_to_device(tops, device), dbl, sgl, torch.device(device),
                                     *x, ts, 3.5, cfg, **kw)


# ----------------------------------------------------------------- the streamed loop


def test_streamed_denoise_matches_jax_stream_and_scan():
    """The port's streamed loop against JAX ``offload.streamed_denoise`` and the JAX
    fused scan (``sampling._denoise_scan``) on the same fp32 weights and inputs."""
    import jax
    import jax.numpy as jnp

    from flux_fp8_api_tpu import offload as joffload
    from flux_fp8_api_tpu import sampling as jsampling
    from flux_fp8_api_tpu.models import flux as jflux
    from flux_fp8_api_tpu.utils.config import FluxParams

    from .torch_parity import numpy_flux_params, to_torch

    jcfg = jflux.FluxStatic.from_params(FluxParams(**FLUX), compute_dtype="float32", use_pallas=False)
    params = numpy_flux_params(jcfg, seed=5)
    pcfg = port_cfg()
    x, ts = inputs(pcfg, seed=6)
    jx = [jnp.asarray(t.numpy()) for t in x]
    dev = jax.devices()[0]
    tops, dbl, sgl = joffload.split_flow_params(params)
    a_stream = np.asarray(joffload.streamed_denoise(
        joffload.make_stream_fns(jcfg), jax.device_put(tops, dev), dbl, sgl, dev, *jx, ts, 3.5, jcfg))
    a_scan = np.asarray(jsampling._denoise_scan(params, jcfg, jnp.array(jx[0], copy=True), *jx[1:],
                                                jnp.asarray(ts, jnp.float32), 3.5))
    b = streamed(to_torch(params), pcfg, x, ts).numpy()
    assert b.shape == a_stream.shape == (1, 16, FLUX["in_channels"])
    assert _rel(b, a_stream) < 1e-5
    assert _rel(b, a_scan) < 1e-5


TWO_DOUBLE_SLICES_PLUS_ONE = "2 slices + 1"


@pytest.mark.parametrize("retain,sync_every", [
    (None, 8), (0, 8), (TWO_DOUBLE_SLICES_PLUS_ONE, 8), (0, 2), (0, 0),
])
def test_streamed_equals_resident_bit_for_bit(retain, sync_every):
    """fp8 blocks in bf16: the streamed loop at every retain budget and sync_every gives
    the resident loop's latents bit for bit (sync_every 2 and 0 both equal it, so each
    other)."""
    cfg = port_cfg("bfloat16")
    model = port_model(cfg, "fp8", seed=1)
    x, ts = inputs(cfg, seed=2)
    ref = tsampling.denoise(model, cfg, *x, ts, 3.5)
    if retain == TWO_DOUBLE_SLICES_PLUS_ONE:
        retain = 2 * toffload.slice_nbytes(model["double_blocks"]) + 1
    out = streamed(model, cfg, x, ts, retain_bytes=retain, sync_every=sync_every)
    assert out.dtype == ref.dtype and torch.equal(out, ref)


def test_retain_budget_keeps_the_leading_blocks():
    cfg = port_cfg()
    model = port_model(cfg)
    dbl, sgl = model["double_blocks"], model["single_blocks"]
    d, s = toffload.slice_nbytes(dbl), toffload.slice_nbytes(sgl)
    assert d == tree_nbytes(dbl[0]) and s == tree_nbytes(sgl[0]) and d > s
    assert toffload.retained_blocks(dbl, sgl, None) == [True] * 5
    assert toffload.retained_blocks(dbl, sgl, 0) == [False] * 5
    assert toffload.retained_blocks(dbl, sgl, 2 * d + 1) == [True, True, False, False, False]
    assert toffload.retained_blocks(dbl, sgl, 2 * d + s) == [True, True, True, False, False]


def test_streamed_loop_leaves_the_host_tree_alone():
    """The device copies die with the loop: the blocks are the host tree's own modules
    and tensors before and after (on the CPU a copy shares the host tensors)."""
    cfg = port_cfg()
    model = port_model(cfg)
    before = [(id(b), b["img_attn_qkv"].weight.data_ptr()) for b in model["double_blocks"]]
    x, ts = inputs(cfg)
    streamed(model, cfg, x, ts, retain_bytes=0)
    assert [(id(b), b["img_attn_qkv"].weight.data_ptr()) for b in model["double_blocks"]] == before


# ---------------------------------------------------------------------------- T5


def t5_pair():
    import jax
    import jax.numpy as jnp

    from flux_fp8_api_tpu.models import t5 as jt5

    cfg = jt5.T5Config(**T5)
    return cfg, jt5.init_t5_params(jax.random.PRNGKey(11), cfg, jnp.float32)


@pytest.mark.parametrize("tier", [None, "qint4"])
def test_t5_encode_streamed_matches_jax_and_resident(tier):
    """fp32: against JAX ``t5_encode`` to 1e-5 (the weight-only int4 tier's dequantized
    weights are the same bytes on both sides), against the port's ``t5_encode`` bit
    for bit."""
    import jax.numpy as jnp

    from flux_fp8_api_tpu.models import t5 as jt5

    from .torch_parity import to_torch

    jcfg, params = t5_pair()
    if tier:
        params = jt5.quantize_t5_params(params, tier)
    ids = np.random.default_rng(0).integers(0, 64, size=(2, 20)).astype(np.int32)
    a = np.asarray(jt5.t5_encode(params, jcfg, jnp.asarray(ids), jnp.float32))
    pcfg, tids = tt5.T5Config(**T5), torch.from_numpy(ids).long()
    model = to_torch(params)
    ref = tt5.t5_encode(model, pcfg, tids, torch.float32)
    out = tt5.t5_encode_streamed(model, pcfg, tids, torch.device("cpu"), torch.float32)
    np.testing.assert_allclose(out.numpy(), a, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, ref)


def _t5_encoder(**kw):
    cfg = tt5.T5Config(**dict(T5, vocab_size=512))  # the toy tokenizer's ids
    params = tt5.init_t5_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    return TextEncoder("t5", params, cfg, ToyTokenizer("t5"), max_length=16, dtype=torch.float32,
                       device="cpu", **kw)


def test_streaming_text_encoder_moves_nothing():
    plain, enc = _t5_encoder(), _t5_encoder(offload=True, stream=True)
    assert enc.stream and enc.params is enc.host_params
    leaf = next(enc.params.buffers())
    enc.to_device()
    assert enc.params is enc.host_params and next(enc.params.buffers()) is leaf
    enc.to_host()
    assert enc.params is enc.host_params
    assert torch.equal(enc(["a photo of test"]), plain(["a photo of test"]))


def test_offloaded_text_encoder_moves_a_copy():
    """Offloaded without streaming: to_device puts a copy beside the host tree,
    to_host drops it; the host tree is never replaced."""
    enc = _t5_encoder(offload=True)
    host = enc.host_params
    enc.to_device()
    assert enc.params is not host and enc.host_params is host
    enc.to_host()
    assert enc.params is host


def test_stream_needs_offload_and_t5():
    from flux_fp8_api_tpu_torch.models.clip import CLIPConfig, init_clip_params

    assert _t5_encoder(stream=True).stream is False
    ccfg = CLIPConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                      max_position_embeddings=77, eos_token_id=2)
    clip = TextEncoder("clip", init_clip_params(ccfg, torch.Generator().manual_seed(2), torch.float32), ccfg,
                       ToyTokenizer("clip"), max_length=16, device="cpu", offload=True, stream=True)
    assert clip.offload and clip.stream is False


# ------------------------------------------------------------------------ pipeline


def fixed_inputs(pipe, noise, timesteps, vec, txt, to):
    """The pipeline draws ``noise`` and ``timesteps`` and encodes every prompt to
    (``vec``, ``txt``) (test_torch_pipeline.py:_fixed_inputs)."""
    pipe.preprocess_latent = lambda *a, **kw: (to(noise), timesteps)
    pipe._encode_prompts = lambda prompts: {p: (to(vec), to(txt)) for p in prompts}


def drawn(seed=21):
    r = np.random.default_rng(seed)
    return (r.normal(size=(1, FLUX["in_channels"] // 4, 8, 8)).astype(np.float32),
            get_schedule(2, 16, shift=True),
            r.normal(size=(1, FLUX["vec_in_dim"])).astype(np.float32),
            r.normal(size=(1, 6, FLUX["context_in_dim"])).astype(np.float32))


def test_offloaded_pipeline_matches_jax():
    """All three offloads on both sides, fp32, the same weights, noise and text: the
    JAX pipeline streams its flow (offload.py), the port's streams its own."""
    import jax.numpy as jnp

    from flux_fp8_api_tpu import pipeline as jpipeline
    from flux_fp8_api_tpu.models import flux as jflux

    from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
    from .torch_parity import numpy_ae_params, numpy_flux_params, to_torch

    flags = dict(offload_flow=True, offload_vae=True, offload_text_encoder=True)
    jcfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    params, ae = numpy_flux_params(jcfg, seed=7), numpy_ae_params(TINY_AE_PARAMS)
    jpipe = jpipeline.FluxPipeline("flux-dev", model=params, model_cfg=jcfg, ae=ae,
                                   config=tiny_spec(flow_dtype="float32", **flags))
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=port_cfg(), ae=to_torch(ae),
                        config=spec(**flags))
    noise, ts, vec, txt = drawn()
    fixed_inputs(jpipe, noise, ts, vec, txt, jnp.asarray)
    fixed_inputs(pipe, noise, ts, vec, txt, torch.from_numpy)
    seen = []
    decode = jpipe.vae_decode
    jpipe.vae_decode = lambda lat, h, w: (seen.append(np.asarray(lat)), decode(lat, h, w))[1]
    jpipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    out = pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert jpipe._stream_state is not None and pipe._stream_state is not None
    assert out.getvalue()[:2] == b"\xff\xd8"
    b = pipe.last_latents.numpy()
    assert b.shape == seen[0].shape and _rel(b, seen[0]) < 1e-5


def resident_and_offloaded(kind=None, **flags):
    """Two pipelines on one set of weights, resident and offloaded, each drawing the
    same noise and text."""
    cfg = port_cfg("bfloat16" if kind else "float32")
    dtype = "bfloat16" if kind else "float32"
    pipes = [FluxPipeline("flux-dev", model=port_model(cfg, kind), model_cfg=cfg,
                          ae=None, config=spec(flow_dtype=dtype, num_scale_trials=2, **f))
             for f in ({}, dict(offload_flow=True, **flags))]
    noise, ts, vec, txt = drawn()
    for p in pipes:
        fixed_inputs(p, noise, ts, vec, txt, torch.from_numpy)
        p.vae_decode = lambda lat, h, w: np.zeros((1, h, w, 3), np.uint8)
    return pipes


def test_quantized_calibrates_over_the_whole_tree_then_streams():
    """The first request calibrates on a device copy of the whole tree, whose input
    scales come back into the host tree; the next one streams. Both give the resident
    pipeline's latents bit for bit."""
    resident, pipe = resident_and_offloaded("fp8")
    host = pipe.model_params
    for i in range(2):
        resident.generate("a cat", 64, 64, 2, seed=1, silent=True)
        pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
        assert torch.equal(pipe.last_latents, resident.last_latents)
        assert pipe.model_params is host  # the host tree is never replaced
        assert (pipe._stream_state is not None) == (i == 1)
    scales = [b["img_attn_qkv"].in_scale for b in host["double_blocks"]]
    assert all(float(s) != 1.0 for s in scales)
    assert all(torch.equal(s, b["img_attn_qkv"].in_scale) for s, b in zip(scales, resident.model_params["double_blocks"]))


def test_offload_retain_gb_zero_serves():
    resident, pipe = resident_and_offloaded(offload_retain_gb=0.0)
    resident.generate("a cat", 64, 64, 2, seed=1, silent=True)
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert pipe._stream_state is not None and torch.equal(pipe.last_latents, resident.last_latents)


def test_stream_flow_offload_false_round_trips_and_leaves_params_on_the_host():
    resident, pipe = resident_and_offloaded(stream_flow_offload=False)
    host = pipe.model_params
    resident.generate("a cat", 64, 64, 2, seed=1, silent=True)
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert pipe._stream_state is None and pipe.model_params is host
    assert all(b.device.type == "cpu" for b in host.buffers())
    assert torch.equal(pipe.last_latents, resident.last_latents)


def test_step_cache_ignored_under_streamed_offload(caplog):
    _, pipe = resident_and_offloaded()
    with caplog.at_level("WARNING", logger="flux_fp8_api_tpu_torch.pipeline"):
        pipe.generate("a cat", 64, 64, 2, seed=1, silent=True, cache={"mode": "interval"})
    assert any("streamed offload" in r.getMessage() for r in caplog.records)
    assert "cache_model_evals" not in pipe.timings


def kohya_lora(rank=4, seed=0):
    """A kohya LoRA over two block linears of the tiny model."""
    r = np.random.default_rng(seed)
    hs = FLUX["hidden_size"]
    sd = {}
    for stub, i, o in (("double_blocks_0_img_attn_proj", hs, hs), ("single_blocks_0_linear2", 5 * hs, hs)):
        sd[f"lora_unet_{stub}.lora_down.weight"] = torch.from_numpy(r.normal(size=(rank, i)).astype(np.float32) * 0.3)
        sd[f"lora_unet_{stub}.lora_up.weight"] = torch.from_numpy(r.normal(size=(o, rank)).astype(np.float32) * 0.3)
    return sd


def test_lora_fuse_invalidates_the_stream_state(tmp_path):
    _, pipe = resident_and_offloaded()
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    unfused = pipe.last_latents.clone()
    assert pipe._stream_state is not None
    path = str(tmp_path / "l.safetensors")
    save_safetensors(path, kohya_lora())
    pipe.load_lora(path, scale=1.0)
    assert pipe._stream_state is None  # rebuilt, with the fused weights, at the next request
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert pipe._stream_state is not None and not torch.equal(pipe.last_latents, unfused)
    pipe.unload_lora(path)
    assert pipe._stream_state is None
    assert all(b.device.type == "cpu" for b in pipe.model_params.buffers())


def test_full_lru_hit_moves_no_encoder():
    pipe = FluxPipeline.load_pipeline_from_config_path(
        "configs/config-tiny-cpu.json", offload_text_encoder=True, offload_vae=True)
    assert pipe.clip.offload and pipe.t5.offload and pipe.t5.stream
    moves = []
    for enc in (pipe.clip, pipe.t5):
        move = enc.to_device
        enc.to_device = lambda move=move, kind=enc.kind: (moves.append(kind), move())[1]
    pipe.generate("a lighthouse at dusk", 64, 64, 2, seed=3)
    assert moves == ["clip", "t5"]
    pipe.generate("a lighthouse at dusk", 64, 64, 2, seed=4)
    assert moves == ["clip", "t5"] and pipe.timings["cond_cache_hits"] == 1
    assert pipe.clip.params is pipe.clip.host_params


# ------------------------------------------------------------------------ the card


@pytest.fixture
def card():
    """The card, or a skip: page-locked memory and streams need CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pinned(tree) -> bool:
    return all(b.device.type == "cpu" and b.is_pinned() for b in tree.buffers())


# the card's kernels take heads of 128: two of them, flux-dev's rope axes
CARD_FLUX = dict(FLUX, hidden_size=256, num_heads=2, axes_dim=[16, 56, 56])


@pytest.mark.cuda
def test_card_streamed_equals_resident_across_streams(card):
    """On the card the copies run on the side stream and the allocator reuses dropped
    blocks' memory for the next copies: at retain 0 (every block copied at every step)
    and sync_every 1 and 8, the latents are the resident loop's bit for bit, through
    the rope pass and K1. A missed ``record_stream`` would let a copy overwrite a
    block still being read."""
    cfg = tflux.FluxStatic.from_params(tconfig.FluxParams(**CARD_FLUX), compute_dtype="bfloat16")
    host = tflux.init_flux_params(cfg, torch.Generator(card).manual_seed(1), torch.bfloat16,
                                  tflux.quant_tier("fp8"))
    x, ts = inputs(cfg, seed=2, h=32, w=32, device=card)
    ref = tsampling.denoise(host, cfg, *x, ts, 3.5)
    pipe = FluxPipeline("flux-dev", model=host, model_cfg=cfg, config=spec(
        params=CARD_FLUX, flux_device="cuda:0", flow_dtype="bfloat16", offload_flow=True, num_scale_trials=0))
    assert _pinned(pipe.model_params)
    tops, dbl, sgl = pipe._ensure_stream_state()
    for retain, sync_every in ((None, 8), (0, 8), (0, 1)):
        out = toffload.streamed_denoise(tops, dbl, sgl, card, *x, ts, 3.5, cfg, retain_bytes=retain,
                                        sync_every=sync_every)
        assert torch.equal(out, ref), (retain, sync_every)


def _reserved_peak(fn) -> int:
    """Bytes the caching allocator reserves from the card at its peak while ``fn`` runs,
    above what it reserved before, from an empty cache. A freed block that a stream the
    compute has not yet passed still reads counts here (the allocator cannot hand it
    out again), not in ``max_memory_allocated``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_reserved()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_reserved() - before


@pytest.mark.cuda
@pytest.mark.parametrize("retain", ["0", "mid"])
def test_card_sync_every_bounds_the_hosts_lead_over_compute(card, monkeypatch, retain):
    """``sync_every`` waits on the compute, as JAX's does (JAX offload.py:254-259):
    with each single block's compute padded by a sleep, so that compute is slower
    than the copies, ``sync_every`` 0 lets the host enqueue copies far ahead of the
    compute and the allocator holds every dropped block that the compute has not
    passed; at ``sync_every`` 2 the reserved peak stays within the resident loop's,
    the retained blocks' and sync_every + 3 slices of the largest block that streams. At retain 0 waiting on the
    copies instead (which keep up) bounded nothing: both peaks came out equal. At a
    mid retain the retained blocks compute with no put at every step after the
    first, so a wait counted in computes falls behind the puts by that many blocks
    each step and bounds nothing after a few steps."""
    # blocks of 16 MB (hidden 1024, fp8): each copy 0.4 ms against 10 ms of padded compute
    flux = dict(CARD_FLUX, hidden_size=1024, num_heads=8, depth=1, depth_single_blocks=16)
    cfg = tflux.FluxStatic.from_params(tconfig.FluxParams(**flux), compute_dtype="bfloat16")
    host = tflux.init_flux_params(cfg, torch.Generator(card).manual_seed(1), torch.bfloat16,
                                  tflux.quant_tier("fp8"))
    steps = 2 if retain == "0" else 4
    x, ts = inputs(cfg, seed=2, h=32, w=32, device=card, steps=4)
    resident = _reserved_peak(lambda: tsampling.denoise(host, cfg, *x, ts[:steps + 1], 3.5))
    pipe = FluxPipeline("flux-dev", model=host, model_cfg=cfg, config=spec(
        params=flux, flux_device="cuda:0", flow_dtype="bfloat16", offload_flow=True, num_scale_trials=0))
    tops, dbl, sgl = pipe._ensure_stream_state()
    retain_bytes = 0 if retain == "0" else 8 * toffload.slice_nbytes(sgl)
    kept = toffload.retained_blocks(dbl, sgl, retain_bytes)
    blocks = list(dbl) + list(sgl)
    kept_bytes = sum(tree_nbytes(b) for b, k in zip(blocks, kept) if k)
    assert retain == "0" or 0 < sum(kept) < len(kept) - 4
    # the unit: the largest block that streams
    slice_ = max(tree_nbytes(b) for b, k in zip(blocks, kept) if not k)
    real = tflux._single_block  # the streamed loop's eager single block (Compiled.functions)
    monkeypatch.setattr(tflux, "_single_block", lambda *a: (torch.cuda._sleep(20_000_000), real(*a))[1])
    peaks = {s: _reserved_peak(lambda: toffload.streamed_denoise(tops, dbl, sgl, card, *x, ts[:steps + 1], 3.5, cfg,
                                                              retain_bytes=retain_bytes, sync_every=s))
             for s in (0, 2)}
    assert peaks[2] <= resident + kept_bytes + (2 + 3) * slice_, (peaks, resident, kept_bytes, slice_)
    assert peaks[0] >= peaks[2] + 4 * slice_, (peaks, resident, kept_bytes, slice_)


@pytest.mark.cuda
def test_card_t5_streamed_equals_resident(card):
    cfg = tt5.T5Config(**T5)
    params = tt5.init_t5_params(cfg, torch.Generator(card).manual_seed(3), torch.bfloat16)
    ids = torch.randint(0, 64, (2, 20), generator=torch.Generator(card).manual_seed(4), device=card)
    ref = tt5.t5_encode(params, cfg, ids)
    enc = TextEncoder("t5", params, cfg, ToyTokenizer("t5"), 16, device=card, offload=True, stream=True)
    assert _pinned(enc.host_params)
    assert torch.equal(tt5.t5_encode_streamed(enc.host_params, cfg, ids, card), ref)


@pytest.mark.cuda
def test_card_lora_fuse_leaves_every_host_leaf_pinned_again(card, tmp_path):
    """The fuse runs on the host tree and replaces the Linears it touches with
    unpinned tensors; the stream state's rebuild pins them again."""
    cfg = port_cfg("bfloat16")
    host = tflux.init_flux_params(cfg, torch.Generator(card).manual_seed(1), torch.bfloat16,
                                  tflux.quant_tier("fp8"))
    pipe = FluxPipeline("flux-dev", model=host, model_cfg=cfg, config=spec(
        flux_device="cuda:0", flow_dtype="bfloat16", offload_flow=True, num_scale_trials=0))
    path = str(tmp_path / "l.safetensors")
    save_safetensors(path, kohya_lora())
    for action in (lambda: pipe.load_lora(path, 1.0), lambda: pipe.unload_lora(path)):
        action()
        assert not _pinned(pipe.model_params) and pipe._stream_state is None
        pipe._ensure_stream_state()
        assert _pinned(pipe.model_params)


# ----------------------------------------------------------------------------- CLI


@pytest.mark.parametrize("argv", [
    [],
    ["-OF", "-OA", "-OT", "-nqfm"],
    ["--offload-flow", "--no-offload-ae", "--no-offload-text-enc", "--no-quantize-flow-modulation"],
    ["-qT", "qint4", "-qA"],
])
def test_cli_offload_flags_match_the_jax_cli(argv):
    """The reference's inverted switches (JAX tests/test_cli.py:12-40): flow offload
    opt-in, AE and text-encoder offload on unless -OA / -OT."""
    from flux_fp8_api_tpu.main import parse_args as jax_parse_args

    from flux_fp8_api_tpu_torch.main import parse_args

    keys = ("offload_flow", "offload_ae", "offload_text_enc", "quantize_modulation", "quant_text_enc", "quant_ae")
    a, b = jax_parse_args(argv), parse_args(argv)
    assert {k: getattr(b, k) for k in keys} == {k: getattr(a, k) for k in keys}
    if not argv:
        assert (b.offload_flow, b.offload_ae, b.offload_text_enc) == (False, True, True)


def test_cli_default_flags_build_and_serve(monkeypatch):
    """``main.main`` with no flags: the reference's defaults (AE and text-encoder
    offload on) build a pipeline and serve a request, with a tiny flux-dev in place of
    the full one and the server stubbed to one POST /generate."""
    from flux_fp8_api_tpu_torch import main as tmain
    from flux_fp8_api_tpu_torch import server as tserver

    real = tconfig.load_config
    specs, served = [], []

    def tiny(*a, **kw):
        s = real(*a, **kw).model_copy(update=dict(
            params=tconfig.FluxParams(**FLUX), ae_params=tconfig.AutoEncoderParams(**AE), flux_device="cpu",
            ae_device="cpu", text_enc_device="cpu", text_enc_max_length=32, num_scale_trials=2))
        specs.append(s)
        return s

    monkeypatch.setattr(tconfig, "load_config", tiny)
    monkeypatch.setitem(sys.modules, "uvicorn", None)  # the stdlib server
    monkeypatch.setattr(tserver, "serve", lambda pipe, host, port: served.append(
        tserver.PipelineServer(pipe).handle_generate(
            {"prompt": "a cat", "width": 64, "height": 64, "num_steps": 2, "seed": 1})))
    tmain.main([])
    (s,) = specs
    assert s.offload_vae and s.offload_text_encoder and not s.offload_flow
    (status, ctype, payload, headers), = served
    assert status == 200 and ctype == "image/jpeg" and payload[:2] == b"\xff\xd8"
