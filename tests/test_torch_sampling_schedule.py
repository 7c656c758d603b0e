"""The request's schedule on the device (``sampling.Schedule``): every step's timestep
vector and step size built once and moved to the device in one copy, against the
per-step formula it replaced, kept here as the reference (:func:`euler_ref`: a host
tensor and a blocking copy at every step).

On the CPU each served loop (the plain loop at flux-dev's shifted 28 steps and at
schnell's 4, the interval cache at order 0 and 1, a Kontext context, the streamed
offload loop) gives the latents of the same loop fed by the reference, bit for bit,
and hands its model and its update the reference's ``t_vec`` and ``dt`` at every step.
The benchmark's reader of the loop's counter (``portbench/metrics/denoise.ahead_pct.py``)
is checked on hand-made records. Tests marked ``cuda`` check on the card what the CPU
cannot show: no sync inside the loop, and the host enqueueing each step while the card
runs the one before (``python -m pytest -m cuda --noconftest
tests/test_torch_sampling_schedule.py``). Nothing here imports JAX.
"""

import time
from types import SimpleNamespace

import pytest
import torch

from flux_fp8_api_tpu_torch import offload as toffload
from flux_fp8_api_tpu_torch import sampling as tsampling
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import packing as tpacking
from flux_fp8_api_tpu_torch.ops.schedule import get_schedule
from flux_fp8_api_tpu_torch.utils.config import FluxParams

torch.set_num_threads(1)

FLUX = dict(in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=64, mlp_ratio=4.0, num_heads=4,
            depth=2, depth_single_blocks=3, axes_dim=[4, 6, 6], theta=10_000, qkv_bias=True, guidance_embed=True)
# the card's kernels take heads of 128: flux-dev's rope axes
CARD_FLUX = dict(FLUX, hidden_size=256, num_heads=2, axes_dim=[16, 56, 56])
DEV_TOKENS = 4096  # a 1024² image's tokens: flux-dev's shifted schedule at its size
PRE, UPDATE = tflux.flux_pre, tsampling._update


def euler_ref(cfg, img, t_curr: float, t_prev: float):
    """The step formula the loops ran before the schedule crossed once a request: the
    reference."""
    b = img.shape[0]
    t_vec = torch.full((b,), t_curr, dtype=torch.float32, device=img.device).to(cfg.dtype)
    dt = (torch.tensor(t_prev, dtype=torch.float32) - torch.tensor(t_curr, dtype=torch.float32)).to(img.dtype)
    return t_vec, dt.to(img.device)


class StepwiseSchedule:
    """``sampling.Schedule``'s interface over :func:`euler_ref`, one step at a time, and
    the cache's fp32 timesteps made as the cached loop made them."""

    def __init__(self, cfg, img, timesteps):
        self.cfg, self.img, self.timesteps = cfg, img, list(timesteps)
        self.ts = torch.tensor(timesteps, dtype=torch.float32, device=img.device)

    def __len__(self):
        return len(self.timesteps) - 1

    def step(self, i):
        return euler_ref(self.cfg, self.img, self.timesteps[i], self.timesteps[i + 1])


def port_cfg(dtype, flux=FLUX, **kw):
    return tflux.FluxStatic.from_params(FluxParams(**{**flux, **kw}), compute_dtype=dtype, use_pallas=False)


def inputs(cfg, dtype, seed=0, h=8, w=8, txt_len=6, device="cpu"):
    """(img, img_ids, txt, txt_ids, vec) in ``dtype``, as a request hands them to the loop."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn((1, cfg.in_channels // 4, h, w), generator=g)
    x = (tpacking.pack_latents(noise).to(dtype), tpacking.make_img_ids(h, w, 1),
         torch.randn((1, txt_len, cfg.context_in_dim), generator=g).to(dtype), tpacking.make_txt_ids(txt_len, 1),
         torch.randn((1, cfg.vec_in_dim), generator=g).to(dtype))
    return tuple(v.to(device) for v in x)


def _run_resident(model, cfg, x, ts, **kw):
    return tsampling.denoise(model, cfg, *x, ts, 3.5, **kw)


def _run_kontext(model, cfg, x, ts):
    g = torch.Generator().manual_seed(5)
    ctx = torch.randn((1, 12, cfg.in_channels), generator=g).to(x[0].dtype)
    return tsampling.denoise(model, cfg, *x, ts, 2.5, context=ctx,
                             context_ids=tpacking.make_img_ids(6, 8, 1, first=1))


def _run_streamed(model, cfg, x, ts):
    tops, dbl, sgl = toffload.split_flow_params(model)
    return toffload.streamed_denoise(toffload.tops_to_device(tops, "cpu"), dbl, sgl, torch.device("cpu"),
                                     *x, ts, 3.5, cfg, retain_bytes=0)


CACHE3 = dict(mode="interval", interval=3)
LOOPS = {
    "dev-28": ("bfloat16", True, _run_resident, 28, True),
    "dev-28-float32": ("float32", True, _run_resident, 28, True),
    "schnell-4": ("bfloat16", False, _run_resident, 4, False),
    "cache3-order0": ("bfloat16", True, lambda m, c, x, ts: _run_resident(
        m, c, x, ts, cache=tsampling.CacheConfig(**CACHE3, order=0)), 28, True),
    "cache3-order1": ("bfloat16", True, lambda m, c, x, ts: _run_resident(
        m, c, x, ts, cache=tsampling.CacheConfig(**CACHE3, order=1)), 28, True),
    "kontext": ("bfloat16", True, _run_kontext, 28, True),
    "streamed-offload": ("bfloat16", True, _run_streamed, 28, True),
}


class Recorder:
    """The ``t_vec`` each evaluation's ``flux_pre`` takes and the ``dt`` each update
    takes, in order, as copies."""

    def __init__(self, monkeypatch):
        self.t_vecs, self.dts, self.layouts = [], [], []

        def flux_pre(model, cfg, img, img_ids, txt, txt_ids, t_vec, *rest):
            self.t_vecs.append(t_vec.clone())
            self.layouts.append((t_vec.is_contiguous(), t_vec.storage_offset()))
            return PRE(model, cfg, img, img_ids, txt, txt_ids, t_vec, *rest)

        def _update(img, dt, pred):
            self.dts.append(dt.clone())
            return UPDATE(img, dt, pred)

        monkeypatch.setattr(tflux, "flux_pre", flux_pre)
        monkeypatch.setattr(tsampling, "_update", _update)
        monkeypatch.setattr(toffload, "_update", _update)


def _same(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("loop", list(LOOPS))
def test_each_served_loop_gives_the_stepwise_formulas_latents_bit_for_bit(loop, monkeypatch):
    dtype, guidance, run, steps, shift = LOOPS[loop]
    cfg = port_cfg(dtype, guidance_embed=guidance)
    model = tflux.init_flux_params(cfg, torch.Generator().manual_seed(1), getattr(torch, dtype))
    x = inputs(cfg, getattr(torch, dtype))
    ts = get_schedule(steps, DEV_TOKENS, shift=shift)
    with torch.inference_mode():  # as a request runs its loop
        ref_rec = Recorder(monkeypatch)
        with monkeypatch.context() as m:
            m.setattr(tsampling, "Schedule", StepwiseSchedule)
            m.setattr(toffload, "Schedule", StepwiseSchedule)
            ref = run(model, cfg, x, ts)
        rec = Recorder(monkeypatch)
        out = run(model, cfg, x, ts)
    assert out.dtype == ref.dtype and torch.equal(out, ref)
    # every step's dt, and each evaluation's t_vec, as the reference made them
    assert len(rec.dts) == steps and _same(rec.dts, ref_rec.dts)
    assert _same(rec.dts, [euler_ref(cfg, x[0], a, b)[1] for a, b in zip(ts[:-1], ts[1:])])
    evaluated = {"cache3-order0": 11, "cache3-order1": 11}.get(loop, steps)
    assert len(rec.t_vecs) == evaluated and _same(rec.t_vecs, ref_rec.t_vecs)
    if evaluated == steps:
        assert _same(rec.t_vecs, [euler_ref(cfg, x[0], a, b)[0] for a, b in zip(ts[:-1], ts[1:])])
    # what the compiled ``pre`` sees: a contiguous (B,) tensor of its own, as before
    assert set(rec.layouts) == {(True, 0)}


def test_the_schedule_is_the_stepwise_formula_at_every_step_and_batch():
    """Every (t_vec, dt) of flux-dev's and schnell's schedules at batch 1 and 3, with a
    compute dtype other than the latents', against the reference; ``ts`` the fp32
    timesteps."""
    cfg = SimpleNamespace(dtype=torch.bfloat16)
    for ts in (get_schedule(28, DEV_TOKENS, shift=True), get_schedule(4, DEV_TOKENS, shift=False),
               get_schedule(20, 1024, shift=True)):
        for img in (torch.zeros(1, 4, 16), torch.zeros(3, 4, 16, dtype=torch.float16)):
            sched = tsampling.Schedule(cfg, img, ts)
            assert len(sched) == len(ts) - 1
            assert torch.equal(sched.ts, torch.tensor(ts, dtype=torch.float32))
            for i in range(len(sched)):
                t_vec, dt = sched.step(i)
                r_vec, r_dt = euler_ref(cfg, img, ts[i], ts[i + 1])
                assert t_vec.dtype == r_vec.dtype and torch.equal(t_vec, r_vec) and t_vec.shape == (img.shape[0],)
                assert dt.dtype == r_dt.dtype and dt.shape == () and torch.equal(dt, r_dt)


def test_the_lead_counts_nothing_off_a_card():
    lead = tsampling.Lead(torch.device("cpu"))
    for _ in range(3):
        lead.starting()
        lead.stepped()
    assert lead.steps_ahead is None
    stats = {}
    cfg = port_cfg("float32")
    model = tflux.init_flux_params(cfg, torch.Generator().manual_seed(1), torch.float32)
    tsampling.denoise(model, cfg, *inputs(cfg, torch.float32), get_schedule(2, 16), 3.5, stats=stats)
    assert "steps_ahead" not in stats


# ---------------------------------------------------------------- the benchmark's reader


def _records(*timings, ok=True):
    return [SimpleNamespace(ok=ok, kept={"timings": t}) for t in timings]


def _ahead_pct(records):
    from portbench import run

    return run.read_metric("denoise.ahead_pct", SimpleNamespace(records=records))


def test_ahead_pct_is_the_share_of_steps_after_the_first_enqueued_ahead():
    dev = dict(denoise_seconds=2.7, denoise_it_per_s=28 / 2.7)
    schnell = dict(denoise_seconds=0.36, denoise_it_per_s=4 / 0.36)
    recs = _records({**dev, "steps_ahead": 27}, {**dev, "steps_ahead": 20}, {**schnell, "steps_ahead": 1})
    assert _ahead_pct(recs) == pytest.approx(100.0 * 48 / 57)
    # a failed request and one without the loop's timings count for nothing
    assert _ahead_pct(recs + _records({**dev, "steps_ahead": 0}, ok=False) + _records({"steps_ahead": 3})) == \
        pytest.approx(100.0 * 48 / 57)


def test_ahead_pct_reads_nothing_without_the_counter():
    dev = dict(denoise_seconds=2.7, denoise_it_per_s=28 / 2.7)
    assert _ahead_pct(_records(dev, dev)) is None
    assert _ahead_pct([]) is None
    assert _ahead_pct(_records(dict(denoise_seconds=0.1, denoise_it_per_s=10.0, steps_ahead=0))) is None


# ------------------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_model(card, flux, seed=1):
    cfg = tflux.FluxStatic.from_params(FluxParams(**flux), compute_dtype="bfloat16")
    return cfg, tflux.init_flux_params(cfg, torch.Generator(card).manual_seed(seed), torch.bfloat16,
                                       tflux.quant_tier("fp8"))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [None, CACHE3], ids=["plain", "cache3"])
def test_card_the_loop_makes_no_sync(card, cache):
    """Under ``set_sync_debug_mode("error")`` the whole loop, its schedule's copy
    included, makes no sync; and with the card asleep before the loop, the host
    enqueues every step and returns while the card still sleeps."""
    cfg, model = _card_model(card, dict(CARD_FLUX, depth=1, depth_single_blocks=1))
    x = inputs(cfg, torch.bfloat16, h=32, w=32, device=card)
    ts = get_schedule(6, DEV_TOKENS, shift=True)
    kw = {} if cache is None else {"cache": tsampling.CacheConfig(**cache)}
    with torch.inference_mode():
        warm = tsampling.denoise(model, cfg, *x, ts, 3.5, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = tsampling.denoise(model, cfg, *x, ts, 3.5, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # 3 steps: few enough launches that the card's launch queue never fills
        asleep = torch.cuda.Event()
        torch.cuda._sleep(2_000_000_000)  # about a second at the H100's clocks
        asleep.record()
        start = time.perf_counter()
        again = tsampling.denoise(model, cfg, *x, ts[:4], 3.5, **kw)
        host = time.perf_counter() - start
        still_asleep = not asleep.query()
        torch.cuda.synchronize()
    assert still_asleep, f"the loop waited for the card ({host:.3f} s on the host)"
    assert torch.equal(out, warm)
    assert torch.equal(again, tsampling.denoise(model, cfg, *x, ts[:4], 3.5, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", [None, CACHE3], ids=["plain", "cache3"])
def test_card_a_model_that_outruns_its_host_has_every_step_enqueued_ahead(card, cache):
    """flux-dev's width at 2048² (16384 image tokens, 512 of text), 1 + 2 blocks: a
    step's device work outlasts its enqueue, so every step after the first begins while
    the card still runs the step before: ``steps_ahead`` = steps − 1."""
    flux = dict(CARD_FLUX, hidden_size=3072, num_heads=24, depth=1, depth_single_blocks=2, in_channels=64,
                vec_in_dim=768, context_in_dim=4096)
    cfg, model = _card_model(card, flux)
    x = inputs(cfg, torch.bfloat16, h=256, w=256, txt_len=512, device=card)
    steps = 8
    ts = get_schedule(steps, DEV_TOKENS, shift=True)
    kw = {} if cache is None else {"cache": tsampling.CacheConfig(**cache)}
    with torch.inference_mode():
        tsampling.denoise(model, cfg, *x, ts, 3.5, **kw)
        torch.cuda.synchronize()
        stats = {}
        tsampling.denoise(model, cfg, *x, ts, 3.5, stats=stats, **kw)
        torch.cuda.synchronize()
    assert stats["steps_ahead"] == steps - 1, stats
