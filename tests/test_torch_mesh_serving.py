"""Serving on a mesh: FluxPipeline on a world of ranks against the JAX pipeline on its
mesh, the flat file a tp pipeline saves, the per-request sp drop, the refusals, the
launcher and the CLI (``main.main([... "--mesh", "tp=2"])`` serving a request through
the first rank with a follower), and ``FluxPipeline.profile``.

The ranks run in processes that import torch and the port only
(tests/torch_mesh_worker.py, over gloo); JAX runs here on its virtual CPU mesh.
Tolerances: fp32 latents of two steps with XLA attention on both sides agree to a
relative norm of 2e-5 (summation order of the split contractions, carried through two
Euler steps); the int8 tier on a mesh is one rank's bit for bit, latents and JPEG.
"""

import json
import multiprocessing
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flux_fp8_api_tpu import main as jmain
from flux_fp8_api_tpu import pipeline as jpipeline
from flux_fp8_api_tpu.models import flux as jflux
from flux_fp8_api_tpu.ops.schedule import get_schedule
from flux_fp8_api_tpu_torch import main as tmain
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.parallel.launch import free_port
from flux_fp8_api_tpu_torch.parallel.mesh import Mesh, sharded_bytes
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils.safetensors_io import SafetensorsFile

from .helpers import TINY_AE_PARAMS, TINY_FLUX_PARAMS, tiny_spec
from .torch_mesh_worker import np_, run_worlds
from .torch_parity import flatten, numpy_ae_params, numpy_flux_params, t, to_torch

torch.set_num_threads(1)

TIMESTEPS = [float(x) for x in get_schedule(2, 16, shift=True)]
GEN = dict(width=64, height=64, num_steps=2, seed=1)
TP4_MESH = json.load(open("configs/config-dev-tp4.json"))["mesh"]  # {"dp": 1, "tp": 4}


def _rel(b, a):
    return float(np.linalg.norm(b - a) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def models():
    cfg = jflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    params = numpy_flux_params(cfg)
    ae = numpy_ae_params(TINY_AE_PARAMS)
    r = np.random.default_rng(21)
    fixed = dict(noise=r.normal(size=(1, TINY_FLUX_PARAMS.in_channels // 4, 8, 8)).astype(np.float32),
                 vec=r.normal(size=(1, TINY_FLUX_PARAMS.vec_in_dim)).astype(np.float32),
                 txt=r.normal(size=(1, 6, TINY_FLUX_PARAMS.context_in_dim)).astype(np.float32),
                 timesteps=TIMESTEPS)
    return cfg, params, ae, {"float": params, "int8": jflux.quantize_flux_tree(params, kind="int8")}, fixed


def spec(**kw):
    return tiny_spec(flow_dtype="float32", ae_dtype="float32", **kw)


def pipeline_task(tree, ae, fixed, spec_, use_pallas=False, **kw):
    return ("pipeline", {"tree": flatten(tree), "flux_params": TINY_FLUX_PARAMS.model_dump(), "dtype": "float32",
                         "use_pallas": use_pallas, "ae": flatten(ae), "spec": spec_.model_dump(),
                         "generates": [GEN], **fixed, **kw})


def port_one_rank(tree, ae, fixed, spec_, prequantized=False):
    """The port's pipeline in this process, world of one, from the fixed inputs."""
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=False)
    pipe = FluxPipeline("flux-dev", model=to_torch(tree), model_cfg=cfg, ae=to_torch(ae), config=spec_,
                        prequantized=prequantized)
    pipe.preprocess_latent = lambda *a, **kw: (t(fixed["noise"]), list(fixed["timesteps"]))
    pipe._encode_prompts = lambda prompts: {p: (t(fixed["vec"]), t(fixed["txt"])) for p in prompts}
    return pipe


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    _, _, ae, trees, fixed = models
    root = tmp_path_factory.mktemp("mesh_serving")
    jobs = {
        "tp2": {"mesh": {"dp": 1, "tp": 2}, "tasks": [
            pipeline_task(trees["float"], ae, fixed, spec(mesh={"dp": 1, "tp": 2})),
            pipeline_task(trees["int8"], ae, fixed, spec(mesh={"dp": 1, "tp": 2}), prequantized=True,
                          save=str(root / "tp2.safetensors")),
        ]},
        "tp4": {"mesh": TP4_MESH, "tasks": [
            pipeline_task(trees["int8"], ae, fixed, spec(mesh=TP4_MESH, num_scale_trials=2, use_pallas=True),
                          use_pallas=True),
        ]},
    }
    return run_worlds(root, jobs, timeout=150), root


def test_generate_on_tp2_matches_the_jax_pipeline_on_tp2(models, worlds):
    """JAX tests/test_parallel.py:129-138 across the packages: the same weights, noise,
    schedule and conditioning through the JAX pipeline on its {"dp": 1, "tp": 2} mesh
    and the port's two ranks."""
    cfg, params, ae, _, fixed = models
    jpipe = jpipeline.FluxPipeline("flux-dev", model=params, model_cfg=cfg, ae=ae,
                                   config=spec(mesh={"dp": 1, "tp": 2}))
    jpipe.preprocess_latent = lambda *a, **kw: (jnp.asarray(fixed["noise"]), TIMESTEPS)
    jpipe._encode_prompts = lambda prompts: {p: (jnp.asarray(fixed["vec"]), jnp.asarray(fixed["txt"]))
                                             for p in prompts}
    seen = []
    decode = jpipe.vae_decode
    jpipe.vae_decode = lambda lat, h, w: (seen.append(np.asarray(lat)), decode(lat, h, w))[1]
    jpipe.generate("a cat", silent=True, **GEN)
    (results, _) = worlds
    for r, rank in enumerate(results["tp2"]):
        out = rank[0]
        assert out["cfg"]["layout"] == "grouped"
        assert _rel(out["latents0"], seen[0]) < 2e-5
        assert (out["jpeg0"] is not None) == (r == 0)  # the first rank decodes and answers
    assert results["tp2"][0][0]["jpeg0"][:2] == b"\xff\xd8"


def test_config_dev_tp4_mesh_serves_one_ranks_image(models, worlds):
    """configs/config-dev-tp4.json's mesh ({"dp": 1, "tp": 4}) on the int8 tier, with
    K1's path and two calibration trials whose amaxes are reduced over the mesh: the
    latents and the JPEG are one rank's bit for bit, and each rank holds a quarter of
    the block weights."""
    _, _, ae, trees, fixed = models
    one = port_one_rank(trees["int8"], ae, fixed, spec(num_scale_trials=2, use_pallas=True))
    one.model_cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    jpeg = one.generate("a cat", silent=True, **GEN).getvalue()
    results, _ = worlds
    whole = sharded_bytes(one.model_params)
    blocks = sum(sharded_bytes(one.model_params[s]) for s in ("double_blocks", "single_blocks"))
    for r, rank in enumerate(results["tp4"]):
        out = rank[0]
        assert out["cfg"]["use_pallas"] and out["cfg"]["layout"] == "grouped"
        np.testing.assert_array_equal(out["latents0"], one.last_latents.numpy())
        assert out["jpeg0"] == (jpeg if r == 0 else None)
        # the block linears' data and out-sliced scales split four ways; per-tensor
        # scales, row-parallel biases and norms stay whole
        assert out["flow_bytes"] < whole - 0.7 * blocks


def test_save_prequantized_from_tp_writes_one_ranks_file(models, worlds, tmp_path):
    """The shards gathered and the relayout inverted: the file a tp pipeline's first
    rank writes holds the tensors and metadata one rank writes, in the flat layout."""
    _, _, ae, trees, fixed = models
    one = port_one_rank(trees["int8"], ae, fixed, spec(), prequantized=True)
    one.save_prequantized(str(tmp_path / "one.safetensors"))
    _, root = worlds
    a, b = SafetensorsFile(tmp_path / "one.safetensors"), SafetensorsFile(root / "tp2.safetensors")
    assert a.metadata == b.metadata and sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        np.testing.assert_array_equal(np_(b.get(k)), np_(a.get(k)), err_msg=k)


def test_denoise_cfg_drops_sp_for_an_indivisible_request(models):
    """JAX pipeline.py:321-334: a joint length that sp does not divide runs the whole
    attention on every sp rank for that request."""
    _, params, ae, _, _ = models
    cfg = tflux.FluxStatic.from_params(TINY_FLUX_PARAMS, compute_dtype="float32", use_pallas=True)
    pipe = FluxPipeline("flux-dev", model=to_torch(params), model_cfg=cfg, ae=to_torch(ae),
                        config=spec(mesh={"tp": 2, "sp": 2}), mesh=Mesh({"tp": 2, "sp": 2}))
    assert pipe.model_cfg.attn_seq_axis == "sp" and pipe.model_cfg.fused_layout == "grouped"
    assert pipe._denoise_cfg(47).attn_seq_axis is None
    assert pipe._denoise_cfg(48).attn_seq_axis == "sp"


def test_pp_offload_and_unknown_axes_are_refused():
    """pp and offload under a mesh are ported (tests/test_torch_pp.py,
    tests/test_torch_mesh_vae.py): what is refused is pp beside tp, as in JAX; a pp or
    offload mesh gets as far as counting its ranks."""
    with pytest.raises(ValueError, match="pp does not compose"):
        FluxPipeline("flux-dev", config=tiny_spec(mesh={"tp": 2, "pp": 2}))
    for spec in (tiny_spec(mesh={"pp": 2}), tiny_spec(mesh={"tp": 2}, offload_flow=True)):
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            FluxPipeline("flux-dev", config=spec)
    with pytest.raises(ValueError, match="not serving axes"):
        FluxPipeline("flux-dev", config=tiny_spec(mesh={"ep": 2}))
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        FluxPipeline("flux-dev", config=tiny_spec(mesh={"tp": 2}))


@pytest.mark.parametrize("text", ["dp=1,tp=4", "tp=2", "tp=2,sp=2", " tp=2 , dp = 2"])
def test_parse_mesh_takes_what_jax_takes(text):
    assert list(tmain.parse_mesh(text).items()) == list(jmain.parse_mesh(text).items())


@pytest.mark.parametrize("text", ["tp", "tp=", "=2", "tp=two", "tp=2,,"])
def test_parse_mesh_refuses_what_jax_refuses(text):
    with pytest.raises(SystemExit) as want:
        jmain.parse_mesh(text)
    with pytest.raises(SystemExit) as got:
        tmain.parse_mesh(text)
    assert str(got.value) == str(want.value)


def _request(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_main_mesh_serves_through_the_first_rank(monkeypatch, tmp_path):
    """``main.main([... "--mesh", "tp=2"])`` spawns two ranks over gloo: the first
    serves HTTP, the second follows. A request comes back as a JPEG; a LoRA load that
    fails on every rank answers 500; /health reports the mesh."""
    port = free_port()
    argv = ["--config-path", "configs/config-tiny-cpu.json", "--mesh", "tp=2", "--dist-backend", "gloo",
            "--port", str(port), "--host", "127.0.0.1"]
    errors = []
    before = set(multiprocessing.active_children())

    def run():
        try:
            tmain.main(argv)
        except Exception as e:  # the ranks are terminated at the end of the test
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 90
        health = None
        while time.monotonic() < deadline:
            try:
                health = _request(port, "/health", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.5)
        assert health is not None and health[0] == 200, "the first rank never served"
        assert json.loads(health[1])["mesh"]["shape"] == {"tp": 2}
        status, body = _request(port, "/generate", {"prompt": "a cat", "width": 64, "height": 64,
                                                     "num_steps": 2, "seed": 3})
        assert status == 200 and body[:2] == b"\xff\xd8"
        status, body = _request(port, "/lora", {"action": "load", "path": str(tmp_path / "missing.safetensors")})
        assert status == 500 and json.loads(body)["status"] == "error"
        status, body = _request(port, "/generate", {"prompt": "a cat", "width": 64, "height": 64,
                                                     "num_steps": 1, "seed": 4})
        assert status == 200
    finally:
        ranks = set(multiprocessing.active_children()) - before
        for p in ranks:
            p.terminate()
        for p in ranks:
            p.join(timeout=10)
        thread.join(timeout=30)
    assert len(ranks) == 2 and not thread.is_alive()


def test_profile_writes_a_trace(models, tmp_path):
    """``FluxPipeline.profile(log_dir)`` (JAX pipeline.py:927-931): a torch.profiler
    trace of a tiny generate lands in ``log_dir``."""
    _, params, ae, _, fixed = models
    pipe = port_one_rank(params, ae, fixed, spec())
    with pipe.profile(str(tmp_path / "trace")):
        pipe.generate("a cat", silent=True, **GEN)
    files = list((tmp_path / "trace").glob("*.json"))
    assert files and "traceEvents" in json.loads(files[0].read_text())
