"""The port's step cache against the JAX package's on the CPU: ``sampling.denoise`` with
a ``CacheConfig`` against JAX ``_denoise_scan_cached`` (through JAX ``denoise``, as
tests/test_step_cache.py runs it), ``flux_cache_indicator`` against JAX's in fp32 and
at the fp8 tier, and the cache on the served path: ``generate``, the stdlib server's
handler and the web page's presets.

One tiny flux (hidden 64, 1 double + 1 single block) in fp32, its JAX weights carried
across by the converter, attention through ``use_pallas=False`` on both sides; inputs
from a numpy seed; 8 steps of a linear schedule. Each JAX configuration compiles once
(a few seconds), so the JAX side runs six, and each one checks more than one thing:
interval 2 with order 1, interval 3, dynamic at a mid threshold, dynamic at an
unreachable one, dynamic with coefficients and order 1, and the uncached loop, which
the port's interval 1 and dynamic threshold 0 must reproduce.

Tolerances: model evaluations equal exactly; latents within 1e-4 relative norm (fp32
on both sides, the forward's own tolerance in test_torch_flux.py, over 8 steps). A
dynamic decision compares an accumulated drift with the threshold, so a drift that
sat on the threshold could fall either way on the two sides' fp32 orders: each dynamic
case computes its drift at every unforced step again with the JAX indicator, on the
port's trajectory, and requires it at least 1e-3 (relative) away from the threshold.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import sampling as jsampling
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import packing as jpacking
from flux_fp8_api_tpu.utils.config import FluxParams
from flux_fp8_api_tpu_torch import sampling as tsampling
from flux_fp8_api_tpu_torch import webui as twebui
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.server import PipelineServer

from .torch_parity import numpy_flux_params, t, to_torch

torch.set_num_threads(1)

PARAMS = FluxParams(
    in_channels=16, vec_in_dim=32, context_in_dim=48, hidden_size=64, mlp_ratio=4.0,
    num_heads=4, depth=1, depth_single_blocks=1, axes_dim=[4, 6, 6], theta=10_000,
    qkv_bias=True, guidance_embed=True,
)
STEPS = 8
TIMESTEPS = np.linspace(1.0, 0.0, STEPS + 1, dtype=np.float32).tolist()
GUIDANCE = 3.5
MARGIN = 1e-3

# name → the JAX configuration each port case is held against (None: uncached)
JAX_CASES = {
    "uncached": None,
    "interval 2, order 1": {"mode": "interval", "interval": 2, "order": 1},
    "interval 3": {"mode": "interval", "interval": 3},
    "dynamic 0.5": {"mode": "dynamic", "threshold": 0.5},
    "dynamic 1e9": {"mode": "dynamic", "threshold": 1e9},
    "dynamic 1.0, coefficients, order 1": {"mode": "dynamic", "threshold": 1.0, "order": 1,
                                           "coefficients": [4.0, 1.0, 0.0]},
}


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, port cfg, port model, numpy inputs)."""
    jcfg = jflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)
    params = numpy_flux_params(jcfg)
    pcfg = tflux.FluxStatic.from_params(PARAMS, compute_dtype="float32", use_pallas=False)
    r = np.random.default_rng(0)
    x = dict(
        img=r.normal(size=(1, 16, PARAMS.in_channels)).astype(np.float32),
        img_ids=np.asarray(jpacking.make_img_ids(8, 8, 1)),
        txt=r.normal(size=(1, 6, PARAMS.context_in_dim)).astype(np.float32),
        txt_ids=np.asarray(jpacking.make_txt_ids(6, 1)),
        vec=r.normal(size=(1, PARAMS.vec_in_dim)).astype(np.float32),
    )
    return jcfg, params, pcfg, to_torch(params), x


KEYS = ("img", "img_ids", "txt", "txt_ids", "vec")
jax_indicator = jax.jit(jflux.flux_cache_indicator, static_argnums=1)


@pytest.fixture(scope="module")
def jax_runs(tiny):
    """name → (latents, model evaluations) of the JAX package's loop, fused as served."""
    jcfg, params, _, _, x = tiny
    out = {}
    for name, spec in JAX_CASES.items():
        stats = {}
        cache = None if spec is None else jsampling.CacheConfig.parse(spec)
        lat = jsampling.denoise(params, jcfg, *(jnp.array(x[k]) for k in KEYS), TIMESTEPS, GUIDANCE,
                                fused=True, cache=cache, stats=stats)
        out[name] = (np.asarray(lat), int(stats.get("model_evals", STEPS)))
    return out


def port_run(tiny, spec, record=None):
    """The port's loop → (latents, model evaluations); ``record`` collects the latent
    each dynamic step's indicator sees."""
    _, _, pcfg, model, x = tiny
    stats = {}
    cache = None if spec is None else tsampling.CacheConfig.parse(spec)
    indicator = tsampling.flux_cache_indicator
    if record is not None:
        def recording(model_, cfg_, img, *a):
            record.append(img.clone())
            return indicator(model_, cfg_, img, *a)

        tsampling.flux_cache_indicator = recording
    try:
        lat = tsampling.denoise(model, pcfg, *(t(x[k]) for k in KEYS), TIMESTEPS, GUIDANCE,
                                cache=cache, stats=stats)
    finally:
        tsampling.flux_cache_indicator = indicator
    return lat, stats.get("model_evals", STEPS)


@pytest.mark.parametrize("spec,against,evals", [
    ({"mode": "interval", "interval": 1}, "uncached", 8),
    ({"mode": "dynamic", "threshold": 0}, "uncached", 8),
    (JAX_CASES["interval 2, order 1"], "interval 2, order 1", 6),  # {0, 1, 7} ∪ {0, 2, 4, 6}
    (JAX_CASES["interval 3"], "interval 3", 5),  # {0, 1, 7} ∪ {0, 3, 6}
    (JAX_CASES["dynamic 1e9"], "dynamic 1e9", 3),  # the forced steps alone
    (JAX_CASES["dynamic 0.5"], "dynamic 0.5", None),
    (JAX_CASES["dynamic 1.0, coefficients, order 1"], "dynamic 1.0, coefficients, order 1", None),
], ids=["interval 1", "dynamic 0", "interval 2 order 1", "interval 3", "dynamic 1e9", "dynamic 0.5",
        "dynamic coefficients order 1"])
def test_cached_loop_matches_jax(tiny, jax_runs, spec, against, evals):
    want_lat, want_evals = jax_runs[against]
    lat, n = port_run(tiny, spec)
    assert isinstance(n, int) and n == want_evals
    if evals is not None:
        assert n == evals
    else:
        assert 3 < n < STEPS  # a mid threshold skips some steps, not all
    assert _rel(lat.numpy(), want_lat) < 1e-4
    if against == "uncached":  # every step evaluated: the uncached loop's latents bit for bit
        assert torch.equal(lat, port_run(tiny, None)[0])


def _polyval(coefficients, x):
    y = np.float32(0)
    for c in coefficients:
        y = y * x + np.float32(c)
    return y


@pytest.mark.parametrize("name", ["dynamic 0.5", "dynamic 1.0, coefficients, order 1"])
def test_dynamic_decisions_keep_their_margin(tiny, jax_runs, name):
    """The drift, accumulated as the JAX scan accumulates it, from the JAX indicator on
    the port's trajectory: every unforced step's sum lies at least MARGIN (relative)
    from the threshold, and the decisions it gives are the port's and JAX's count."""
    jcfg, params, _, _, x = tiny
    cache = tsampling.CacheConfig.parse(JAX_CASES[name])
    seen = []
    _, n = port_run(tiny, JAX_CASES[name], record=seen)
    assert len(seen) == STEPS
    accum, prev, evals = np.float32(0), None, 0
    for i, img in enumerate(seen):
        ind = np.asarray(jax_indicator(params, jcfg, jnp.asarray(img.numpy()), jnp.full((1,), TIMESTEPS[i], jnp.float32),
                                   jnp.asarray(x["vec"]), jnp.full((1,), GUIDANCE, jnp.float32)))
        evaluate = i < cache.warmup or i >= STEPS - cache.tail
        if not evaluate:
            rel = np.float32(np.mean(np.abs(ind - prev)) / (np.mean(np.abs(prev)) + np.float32(1e-8)))
            if cache.coefficients is not None:
                rel = _polyval(cache.coefficients, rel)
            accum = accum + abs(rel)
            assert abs(accum - cache.threshold) >= MARGIN * cache.threshold, (i, accum)
            evaluate = accum >= cache.threshold
        if evaluate:
            accum, evals = np.float32(0), evals + 1
        prev = ind
    assert evals == n == jax_runs[name][1]


def test_order_1_extrapolates(tiny):
    """At the same evaluations, order 1's skipped steps use the slope: other latents."""
    a, na = port_run(tiny, {"mode": "interval", "interval": 3})
    b, nb = port_run(tiny, {"mode": "interval", "interval": 3, "order": 1})
    assert na == nb == 5 and not torch.equal(a, b) and bool(torch.isfinite(b).all())


def test_cache_indicator_matches_jax(tiny):
    """fp32, and at the fp8 tier (img_mod_lin quantized, img_in float): relative norm
    1e-5, the few ops' fp32 order. At fp8 the two sides cast the same modulation input
    to e5m2 (no element on a rounding boundary for these inputs)."""
    jcfg, params, pcfg, model, x = tiny
    r = np.random.default_rng(3)
    img = r.normal(size=(1, 16, PARAMS.in_channels)).astype(np.float32)
    g = np.full((1,), GUIDANCE, np.float32)
    q = jflux.quantize_flux_tree(params)
    qmodel = to_torch(q)
    assert qmodel["double_blocks"][0]["img_mod_lin"].kind == "fp8" and qmodel["img_in"].kind == "float"
    for jp, tm in ((params, model), (q, qmodel)):
        for tv in (0.9, 0.1):
            tt = np.full((1,), tv, np.float32)
            a = np.asarray(jax_indicator(jp, jcfg, *(jnp.asarray(v) for v in (img, tt, x["vec"], g))))
            b = tflux.flux_cache_indicator(tm, pcfg, t(img), t(tt), t(x["vec"]), t(g)).numpy()
            assert b.shape == a.shape == (1, 16, PARAMS.hidden_size)
            assert _rel(b, a) < 1e-5


@pytest.fixture(scope="module")
def pipe():
    """config-tiny-cpu.json (flux-schnell, 4 steps, bf16, no calibration)."""
    return FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")


def test_generate_reports_model_evals(pipe):
    pipe.generate("a cat", 64, 64, 4, seed=1, silent=True, cache={"mode": "interval", "interval": 3})
    assert pipe.timings["cache_model_evals"] == 3  # {0, 1, 3} ∪ {0, 3}
    pipe.generate("a cat", 64, 64, 4, seed=1, silent=False, cache={"mode": "dynamic", "threshold": 0})
    assert pipe.timings["cache_model_evals"] == 4  # with the progress bar too
    pipe.generate("a cat", 64, 64, 4, seed=1, silent=True)
    assert "cache_model_evals" not in pipe.timings


def test_cache_ignored_while_calibrating(caplog):
    pipe = FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json",
                                                       flow_quantization_dtype="qfloat8", num_scale_trials=2)
    assert pipe._needs_calibration
    with caplog.at_level(logging.WARNING, logger="flux_fp8_api_tpu_torch.pipeline"):
        out = pipe.generate("a cat", 64, 64, 4, seed=1, silent=True, cache={"mode": "interval", "interval": 2})
    assert out.getvalue()[:2] == b"\xff\xd8"
    assert any("step cache ignored" in r.getMessage() for r in caplog.records)
    assert "cache_model_evals" not in pipe.timings and not pipe._needs_calibration


@pytest.mark.parametrize("cache,status", [
    ({"mode": "interval", "interval": 3}, 200),
    ({"mode": "dynamic", "threshold": 0.4, "order": 1}, 200),
    ({"mode": "nope"}, 400),
    ({"interval": 2}, 400),
    ({"mode": "interval", "order": 2}, 400),
])
def test_server_serves_the_cache(pipe, cache, status):
    from flux_fp8_api_tpu import server as jserver

    srv = PipelineServer(pipe)
    code, ctype, payload, _ = srv.handle_generate({"prompt": "a cat", "width": 64, "height": 64,
                                                   "num_steps": 4, "seed": 3, "cache": cache})
    assert code == status
    if status == 200:
        assert ctype == "image/jpeg" and payload[:2] == b"\xff\xd8"
        assert 3 <= srv.last_timings["cache_model_evals"] <= 4
    elif "mode" in cache:  # the JAX server's 400, message and all
        want = jserver.PipelineServer(pipeline=None).handle_generate({"prompt": "x", "cache": cache})
        assert (code, json.loads(payload)) == (want[0], json.loads(want[2]))


def test_web_page_presets_parse():
    from flux_fp8_api_tpu.main_gr import STEP_CACHE_CHOICES

    parsed = [tsampling.CacheConfig.parse(v) for v in twebui.STEP_CACHE_PRESETS.values()]
    assert [c.mode for c in parsed] == ["none", "dynamic", "interval"]
    assert [v for v in twebui.STEP_CACHE_PRESETS.values() if v] == [v for v in STEP_CACHE_CHOICES.values() if v]
    page = twebui.render_index(None).decode()
    assert '<select id="cache">' in page and '"cache_presets"' in page and "body.cache = cache" in page
