"""The slice end to end on the CPU: the port's denoise loop, calibration protocol and
VAE decode against the JAX package's from shared noise, the switch to
``use_pallas=False`` at load for weights whose logit bound is too high, the pipeline's
refusals and timings, and the HTTP server built from configs/config-tiny-cpu.json.

Tolerances: the float slice (two Euler steps, unpack, VAE decode) in fp32 agrees to a
relative norm of 1e-4 and elements to 1e-3 — the flux forward's own tolerance (see
test_torch_flux.py) carried through two steps and the decoder. The calibration
protocol runs its first steps at in_scale 1, where small activations sit in e5m2's
coarsest range and the two sides' fp32-order differences cross rounding boundaries
(test_torch_flux.py explains the mechanism): against JAX the frozen scales and the
output agree to 5e-2; against the same protocol written out on the port's own
functions, bit for bit.
"""

import io
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import calibration as jcal
from flux_fp8_api_tpu import sampling as jsampling
from flux_fp8_api_tpu.models import autoencoder as jae
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops import attention as jattn
from flux_fp8_api_tpu.ops import packing as jpacking
from flux_fp8_api_tpu.ops.schedule import get_schedule
from flux_fp8_api_tpu_torch import calibration as tcal
from flux_fp8_api_tpu_torch import sampling as tsampling
from flux_fp8_api_tpu_torch.models import autoencoder as tae
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.ops import packing as tpacking
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.server import PipelineServer

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .torch_parity import numpy_ae_params, numpy_flux_params, t, to_torch

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setattr(jattn, "FORCE_PALLAS_INTERPRET", True)


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


def shared_inputs(h_latent=8, w_latent=8, txt_len=6, seed=0):
    r = np.random.default_rng(seed)
    p = TINY_FLUX_PARAMS
    noise = r.normal(size=(1, p.in_channels // 4, h_latent, w_latent)).astype(np.float32)
    return dict(
        img=np.asarray(jpacking.pack_latents(jnp.asarray(noise))),
        img_ids=np.asarray(jpacking.make_img_ids(h_latent, w_latent, 1)),
        txt=r.normal(size=(1, txt_len, p.context_in_dim)).astype(np.float32),
        txt_ids=np.asarray(jpacking.make_txt_ids(txt_len, 1)),
        vec=r.normal(size=(1, p.vec_in_dim)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def models():
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    params = numpy_flux_params(cfg)
    ae = numpy_ae_params(TINY_AE_PARAMS)
    return cfg, params, ae


def test_two_steps_and_decode_match_jax(models):
    cfg, params, ae = models
    x = shared_inputs()
    timesteps = get_schedule(2, x["img"].shape[1], shift=True)
    a = jsampling.denoise(params, cfg, *(jnp.asarray(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "vec")),
                          timesteps, 3.5, fused=False)
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    b = tsampling.denoise(to_torch(params), pcfg, *(t(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "vec")),
                          timesteps, 3.5, fused=True)
    a, b = np.asarray(a), b.numpy()
    assert _rel(b, a) < 1e-4
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)

    def decode_jax(lat):
        z = jnp.transpose(jpacking.unpack_latents(jnp.asarray(lat), 64, 64), (0, 2, 3, 1))
        return np.asarray(jax.jit(lambda p, z: jae.ae_decode(p, TINY_AE_PARAMS, z))(ae, z))

    def decode_port(lat):
        z = tpacking.unpack_latents(t(lat), 64, 64).permute(0, 2, 3, 1)
        return tae.ae_decode(to_torch(ae), TINY_AE_PARAMS, z).numpy()

    pa, pb = decode_jax(a), decode_port(b)
    assert pb.shape == pa.shape == (1, 64, 64, 3)
    assert _rel(pb, pa) < 1e-4
    np.testing.assert_allclose(pb, pa, rtol=1e-3, atol=1e-3)


def test_calibration_protocol_matches_jax(models):
    """Two collect steps that freeze the fp8 input scales, then a plain step, as the
    JAX pipeline's _calibration_denoise runs them."""
    cfg, params, ae = models
    qparams = jflux.quantize_flux_tree(params)
    x = shared_inputs(seed=4)
    args = [jnp.asarray(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "vec")]
    timesteps = get_schedule(3, x["img"].shape[1])
    collect, plain = jsampling.make_denoise_step(cfg, collect_amax=True), jsampling.make_denoise_step(cfg)
    running, img, jp = None, args[0], qparams
    for i, (tc, tp) in enumerate(zip(timesteps[:-1], timesteps[1:])):
        if i < 2:
            img, amaxes = collect(jp, img, *args[1:], tc, tp, 3.5)
            running = jcal.merge_amax(running, amaxes)
            jp = jcal.apply_input_scales(jp, running)
        else:
            img = plain(jp, img, *args[1:], tc, tp, 3.5)

    spec = tiny_spec(num_scale_trials=2, flow_dtype="float32")
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    pipe = FluxPipeline("flux-dev", model=to_torch(qparams), model_cfg=pcfg, ae=to_torch(ae), config=spec)
    assert pipe._needs_calibration
    out = pipe._calibration_denoise(*(t(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "vec")),
                                    timesteps, 3.5, silent=True)
    assert not pipe._needs_calibration and pipe._trials_done == 2
    ja = np.asarray(jp["double_blocks"]["img_attn_qkv"].in_scale)
    tb = torch.stack([b["img_attn_qkv"].in_scale for b in pipe.model_params["double_blocks"]]).numpy()
    np.testing.assert_allclose(tb, ja, rtol=5e-2)
    assert np.all(tb != 1.0)
    assert _rel(out.numpy(), np.asarray(img)) < 5e-2

    # the same protocol written out on the port's own functions: bit for bit
    model = to_torch(qparams)
    collect_t, plain_t = tsampling.make_denoise_step(pcfg, collect_amax=True), tsampling.make_denoise_step(pcfg)
    targs = [t(x[k]) for k in ("img", "img_ids", "txt", "txt_ids", "vec")]
    running, timg = None, targs[0]
    for i, (tc, tp) in enumerate(zip(timesteps[:-1], timesteps[1:])):
        if i < 2:
            timg, amaxes = collect_t(model, timg, *targs[1:], tc, tp, 3.5)
            running = tcal.merge_amax(running, amaxes)
            tcal.apply_input_scales(model, running)
        else:
            timg = plain_t(model, timg, *targs[1:], tc, tp, 3.5)
    assert torch.equal(timg, out)


def test_pipeline_refuses_what_is_not_ported(models):
    """What is left to refuse: a pp mesh composed with tp, as JAX refuses it (pp
    meshes serve: tests/test_torch_pp.py). Offload, ported since, constructs and serves
    with each flag (tests/test_torch_offload.py holds it against JAX), and so does the
    step cache (tests/test_torch_step_cache.py)."""
    cfg, params, ae = models
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    x = shared_inputs()
    for field in ("offload_flow", "offload_vae", "offload_text_encoder"):
        pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=pcfg, ae=to_torch(ae),
                            config=tiny_spec(flow_dtype="float32", **{field: True}))
        pipe._encode_prompts = lambda prompts: {p: (t(x["vec"]), t(x["txt"])) for p in prompts}
        assert pipe.generate("a cat", 64, 64, 2).getvalue()[:2] == b"\xff\xd8"
    with pytest.raises(ValueError, match="pp does not compose"):
        FluxPipeline("flux-dev", config=tiny_spec(mesh={"tp": 2, "pp": 2}))
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=pcfg, ae=to_torch(ae),
                        config=tiny_spec(flow_dtype="float32"))
    x = shared_inputs()
    pipe._encode_prompts = lambda prompts: {p: (t(x["vec"]), t(x["txt"])) for p in prompts}
    out = pipe.generate("a cat", 64, 64, 2, cache={"mode": "interval"})
    assert out.getvalue()[:2] == b"\xff\xd8" and pipe.timings["cache_model_evals"] == 2


def _fixed_inputs(pipe, noise, timesteps, vec, txt, to):
    """Make ``pipe`` draw ``noise`` and ``timesteps`` and encode every prompt to
    (``vec``, ``txt``), each converted by ``to``: shared inputs for two pipelines whose
    generators and random text encoders differ."""
    pipe.preprocess_latent = lambda *a, **kw: (to(noise), timesteps)
    pipe._encode_prompts = lambda prompts: {p: (to(vec), to(txt)) for p in prompts}


def test_high_logit_bound_serves_through_sdpa_and_matches_jax(models, caplog):
    """k-norm scales ×40 put max_logit_bound above MAX_SAFE_LOGIT. Both pipelines
    decide at load to serve with use_pallas=False (the port logs the bound) and
    generate; from the same noise and text their latents agree as the float slice
    does in test_two_steps_and_decode_match_jax: relative norm 1e-4."""
    from flux_fp8_api_tpu import pipeline as jpipeline

    cfg, params, ae = models
    params = dict(params, single_blocks=dict(params["single_blocks"], knorm=params["single_blocks"]["knorm"] * 40.0))
    spec = tiny_spec(flow_dtype="float32")
    jpipe = jpipeline.FluxPipeline("flux-dev", model=params, model_cfg=cfg, ae=ae, config=spec)
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    with caplog.at_level("WARNING", logger="flux_fp8_api_tpu_torch.pipeline"):
        pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=pcfg, ae=to_torch(ae), config=spec)
    assert cfg.use_pallas and pcfg.use_pallas
    assert jpipe.model_cfg.use_pallas is False and pipe.model_cfg.use_pallas is False
    assert any("bound of 246 > 100" in r.getMessage() and "use_pallas=False" in r.getMessage()
               for r in caplog.records)

    r = np.random.default_rng(21)
    noise = r.normal(size=(1, TINY_FLUX_PARAMS.in_channels // 4, 8, 8)).astype(np.float32)
    vec = r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32)
    txt = r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32)
    timesteps = get_schedule(2, 16, shift=True)
    _fixed_inputs(jpipe, noise, timesteps, vec, txt, jnp.asarray)
    _fixed_inputs(pipe, noise, timesteps, vec, txt, t)
    seen = []
    decode = jpipe.vae_decode
    jpipe.vae_decode = lambda lat, h, w: (seen.append(np.asarray(lat)), decode(lat, h, w))[1]
    jpipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    b = pipe.last_latents.numpy()
    assert np.isfinite(b).all() and b.shape == seen[0].shape == (1, 16, TINY_FLUX_PARAMS.in_channels)
    assert _rel(b, seen[0]) < 1e-4


def test_prepare_seconds_excludes_preprocess_latent(models):
    """As in the JAX pipeline, prepare_seconds starts after preprocess_latent (noise
    and schedule; with img2img, the VAE encode) and times prepare alone."""
    cfg, params, ae = models
    pcfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32")
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=pcfg, ae=to_torch(ae),
                        config=tiny_spec(flow_dtype="float32"))
    x = shared_inputs()
    pipe._encode_prompts = lambda prompts: {p: (t(x["vec"]), t(x["txt"])) for p in prompts}
    draw = pipe.preprocess_latent

    def slow_preprocess(*a, **kw):
        time.sleep(0.5)
        return draw(*a, **kw)

    pipe.preprocess_latent = slow_preprocess
    start = time.perf_counter()
    pipe.generate("a cat", 64, 64, 2, seed=1, silent=True)
    assert time.perf_counter() - start >= 0.5
    assert pipe.timings["prepare_seconds"] < 0.25


def test_cache_config_validation():
    assert tsampling.CacheConfig.parse(None).mode == "none"
    assert tsampling.CacheConfig.parse({"mode": "none", "interval": "3"}).interval == 3
    with pytest.raises(ValueError):
        tsampling.CacheConfig.parse({"bogus": 1})
    with pytest.raises(ValueError, match="without a cache mode"):
        tsampling.CacheConfig.parse({"interval": 4})
    with pytest.raises(ValueError):
        tsampling.CacheConfig.parse({"mode": "sometimes"})
    with pytest.raises(TypeError):
        tsampling.CacheConfig.parse(3)


def test_timings_count_this_requests_cond_cache_hits():
    """``timings`` carries the hits and misses of the request it describes; the
    lifetime totals stay on the pipeline's attributes."""
    pipe = FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")
    for _ in range(2):
        pipe.generate("a lighthouse at dusk", 64, 64, 2, seed=3)
    assert (pipe.timings["cond_cache_hits"], pipe.timings["cond_cache_misses"]) == (1, 0)
    assert (pipe.cond_cache_hits, pipe.cond_cache_misses) == (1, 1)


@pytest.fixture(scope="module")
def server():
    pipe = FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")
    srv = PipelineServer(pipe, host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _request(srv, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_server_generates_jpeg(server):
    from PIL import Image

    status, headers, payload = _request(
        server, "/generate", {"prompt": "a red house", "width": 96, "height": 64, "num_steps": 2, "seed": 7}
    )
    assert status == 200, payload
    assert headers["content-type"] == "image/jpeg" and headers["x-seed"] == "7"
    im = Image.open(io.BytesIO(payload))
    assert im.format == "JPEG" and im.size == (96, 64)
    assert bool(torch.isfinite(server.pipeline.last_latents.float()).all())
    status, _, body = _request(server, "/metrics")
    metrics = json.loads(body)
    assert status == 200 and metrics["requests"] >= 1 and metrics["denoise_it_per_s"] > 0
    status, _, body = _request(server, "/health")
    assert status == 200 and json.loads(body)["status"] == "ok"


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/generate", {"width": 64}, 400),
    ("POST", "/generate", {"prompt": "x", "cache": {"bogus": 1}}, 400),
    ("POST", "/generate", {"prompt": "x", "width": 64, "height": 64, "cache": {"mode": "dynamic"}}, 200),
    ("POST", "/generate", {"prompt": "x", "width": 64, "height": 64, "init_image": "abc"}, 500),
    ("POST", "/lora", {"action": "load", "path": "x"}, 500),
    ("GET", "/", None, 200),
    ("GET", "/nope", None, 404),
])
def test_server_errors(server, method, path, body, code):
    status, _, _ = _request(server, path, body if method == "POST" else None)
    assert status == code
