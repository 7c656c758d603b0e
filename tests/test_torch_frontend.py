"""The port's request surface on the CPU: the stdlib server's POST /lora, /health with
the fused LoRAs' names, GET / (the browser UI) and POST /generate with an
``init_image``, each answering what ``flux_fp8_api_tpu.server`` answers; the FastAPI
app (where fastapi is installed); and ``main.py``'s choice between uvicorn and the
stdlib server.

The server runs ``configs/config-tiny-cpu.json`` (random weights, 2 + 3 blocks, hidden
64). Response statuses and JSON bodies are compared for equality; images by format and
size. The JAX package is imported inside the tests that compare with it, so that the
FastAPI and ``main.py`` tests also run where JAX is not installed
(``pytest --noconftest tests/test_torch_frontend.py -k "fastapi or main"``).
"""

import base64
import io
import json
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flux_fp8_api_tpu_torch import main as tmain
from flux_fp8_api_tpu_torch import server as tserver
from flux_fp8_api_tpu_torch import webui as twebui
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils.safetensors_io import save_safetensors

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def server():
    pipe = FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")
    srv = tserver.PipelineServer(pipe, host="127.0.0.1", port=0)
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


@pytest.fixture(scope="module")
def lora_file(tmp_path_factory):
    from .test_lora import make_kohya_lora

    path = tmp_path_factory.mktemp("lora") / "kohya-style.safetensors"
    save_safetensors(path, {k: torch.as_tensor(np.asarray(v)) for k, v in make_kohya_lora().items()})
    return str(path)


class _OpensThePath:
    """A pipeline stub for the JAX server whose load_lora fails as a missing file does."""

    def load_lora(self, lora_path, scale, name=None):
        open(lora_path, "rb")


@pytest.mark.parametrize("body", [
    {"action": "load"},
    {"path": "", "scale": 0.5},
    {"action": "unload"},
    {"action": "unload", "name": "", "path": None},
    {"action": "fuse", "path": "x.safetensors"},
    {"action": "load", "path": "/nonexistent/lora.safetensors"},
])
def test_lora_errors_match_the_jax_server(server, body):
    from flux_fp8_api_tpu import server as jserver

    status, headers, payload = _request(server, "/lora", body)
    want_status, want_type, want_payload = jserver.PipelineServer(_OpensThePath()).handle_lora(body)
    assert status == want_status and status in (400, 500)
    assert headers["content-type"] == want_type
    assert json.loads(payload) == json.loads(want_payload)


def _generate(server, seed, **extra):
    body = {"prompt": "a red house", "width": 64, "height": 64, "num_steps": 2, "seed": seed, **extra}
    status, headers, payload = _request(server, "/generate", body)
    assert status == 200, payload
    assert headers["content-type"] == "image/jpeg" and headers["x-seed"] == str(seed)
    im = Image.open(io.BytesIO(payload))
    assert im.format == "JPEG" and im.size == (64, 64)
    return payload, server.pipeline.last_latents.clone()


def test_lora_load_rescale_unload_and_health(server, lora_file):
    def health():
        status, _, body = _request(server, "/health")
        assert status == 200
        return json.loads(body)

    def lora(body):
        status, _, payload = _request(server, "/lora", body)
        return status, json.loads(payload)

    assert health()["loras"] == []
    _, unfused = _generate(server, 5)
    assert lora({"action": "load", "path": lora_file, "scale": 1.5}) == (
        200, {"status": "success", "message": f"LoRA {lora_file} loaded successfully"})
    assert health() == {"status": "ok", "model": "flux-schnell", "loras": ["kohya-style.safetensors"]}
    _, fused = _generate(server, 5)
    assert not torch.equal(fused, unfused)
    held = server.pipeline.model_params["double_blocks"][0]["img_attn_proj"]
    assert lora({"action": "load", "path": lora_file, "scale": 1.5})[0] == 200  # same scale: no-op
    assert server.pipeline.model_params["double_blocks"][0]["img_attn_proj"] is held
    assert lora({"action": "load", "path": lora_file, "scale": 0.5})[0] == 200  # rescale
    assert [e.scale for e in server.pipeline.loras] == [0.5]
    assert lora({"action": "unload", "name": "kohya-style.safetensors"}) == (
        200, {"status": "success", "message": "LoRA kohya-style.safetensors unloaded successfully"})
    assert health()["loras"] == []
    _, restored = _generate(server, 5)
    # bf16 weights: load, rescale and unload each round the sum to bf16
    assert float((restored.float() - unfused.float()).norm() / unfused.float().norm()) < 2e-2
    # an unknown name: the JAX server answers success too (the registry logs a warning)
    assert lora({"action": "unload", "name": "nope"}) == (
        200, {"status": "success", "message": "LoRA nope unloaded successfully"})


@pytest.mark.parametrize("path", ["/", "/index.html"])
def test_index_page(server, path):
    from flux_fp8_api_tpu import webui as jwebui

    status, headers, payload = _request(server, path)
    assert status == 200 and headers["content-type"] == "text/html; charset=utf-8"
    page = payload.decode()
    assert page.startswith("<!doctype html>") and "__CONFIG__" not in page
    for needle in ('fetch("generate"', 'fetch("lora"', 'fetch("metrics"', "init_image", '"model": "flux-schnell"',
                   '"platform": "cpu"', '"default_steps": 4'):
        assert needle in page, needle
    assert twebui.RESOLUTION_PRESETS == jwebui.RESOLUTION_PRESETS


def test_init_image_requests(server):
    txt2img, _ = _generate(server, 9)
    b64 = base64.b64encode(txt2img).decode()
    _, a = _generate(server, 9, init_image=b64, strength=0.6)
    assert server.pipeline.timings["encode_seconds"] > 0
    _, b = _generate(server, 9, init_image="data:image/jpeg;base64," + b64, strength=0.6)
    assert torch.equal(a, b)
    status, _, payload = _request(server, "/generate", {"prompt": "x", "width": 64, "height": 64,
                                                        "init_image": "not an image"})
    body = json.loads(payload)
    assert status == 500 and body["status"] == "error" and body["message"]


def test_fastapi_app():
    pytest.importorskip("fastapi")
    pytest.importorskip("httpx")  # fastapi's TestClient
    from fastapi.testclient import TestClient

    from flux_fp8_api_tpu_torch.api import app

    pipe = FluxPipeline.load_pipeline_from_config_path("configs/config-tiny-cpu.json")
    app.state.model = pipe
    client = TestClient(app)
    assert client.get("/health").json() == {"status": "ok", "model": "flux-schnell", "loras": []}
    index = client.get("/")
    assert index.status_code == 200 and index.text.startswith("<!doctype html>")
    resp = client.post("/generate", json={"prompt": "x", "width": 64, "height": 64, "num_steps": 2, "seed": 3})
    assert resp.status_code == 200 and resp.headers["x-seed"] == "3"
    assert Image.open(io.BytesIO(resp.content)).size == (64, 64)
    assert client.post("/generate", json={"prompt": "x", "seed": -1}).status_code == 422
    resp = client.post("/generate", json={"prompt": "x", "width": 64, "height": 64, "num_steps": 2, "seed": 4,
                                          "cache": {"mode": "dynamic", "threshold": 0}})
    # flux-schnell runs 4 steps; threshold 0 evaluates each, whatever the weights' drift
    assert resp.status_code == 200 and pipe.timings["cache_model_evals"] == 4
    assert client.post("/generate", json={"prompt": "x", "cache": {"mode": "nope"}}).json() == {
        "detail": "cache mode must be none|interval|dynamic, got 'nope'"}
    assert client.post("/lora", json={"action": "load"}).json() == {"detail": "Lora path is required"}
    resp = client.post("/lora", json={"action": "unload", "name": "nope"})
    assert resp.status_code == 200 and resp.json()["status"] == "success"
    assert client.get("/metrics").json()["requests"] == 2


def test_api_without_fastapi_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastapi", None)
    monkeypatch.delitem(sys.modules, "flux_fp8_api_tpu_torch.api", raising=False)
    with pytest.raises(ImportError, match="stdlib server"):
        import flux_fp8_api_tpu_torch.api  # noqa: F401


@pytest.mark.parametrize("installed,served_by", [
    (("uvicorn", "fastapi"), "uvicorn"), (("fastapi",), "stdlib"), (("uvicorn",), "stdlib"),
])
def test_main_serves_under_uvicorn_when_both_import(monkeypatch, installed, served_by):
    pipe = object()
    monkeypatch.setattr(FluxPipeline, "load_pipeline_from_config_path", classmethod(lambda cls, *a, **kw: pipe))
    calls = []
    fake_app = types.SimpleNamespace(state=types.SimpleNamespace())
    uvicorn = types.ModuleType("uvicorn")
    uvicorn.run = lambda app, host, port: calls.append(("uvicorn", app, host, port))
    api = types.ModuleType("flux_fp8_api_tpu_torch.api")
    api.app = fake_app
    monkeypatch.setitem(sys.modules, "uvicorn", uvicorn if "uvicorn" in installed else None)
    monkeypatch.setitem(sys.modules, "flux_fp8_api_tpu_torch.api", api if "fastapi" in installed else None)
    monkeypatch.setattr(tserver, "serve", lambda p, host, port: calls.append(("stdlib", p, host, port)))
    tmain.main(["--config-path", "configs/config-tiny-cpu.json", "--port", "8123", "--host", "127.0.0.1"])
    if served_by == "uvicorn":
        assert calls == [("uvicorn", fake_app, "127.0.0.1", 8123)] and fake_app.state.model is pipe
    else:
        assert calls == [("stdlib", pipe, "127.0.0.1", 8123)]
