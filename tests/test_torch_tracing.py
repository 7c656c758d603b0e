"""The program's spans and counters (``tracing.py``) on the CPU, through
``configs/config-tiny-cpu.json`` (random weights, 2 + 3 blocks, hidden 64, flux-schnell's
4 steps): the span tree of one served request under ``torch.profiler``, children inside
their parents in time; nothing of the profiler touched while none records, and the same
bytes either way; the text span's timing; the compiled-dispatch counters; the reply
counters of the stdlib server, of the FastAPI app (where fastapi imports) and of the
ASGI wrapper alone; the lock wait inside ``last_seconds``.
"""

import asyncio
import json
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flux_fp8_api_tpu_torch import server as tserver
from flux_fp8_api_tpu_torch import tracing
from flux_fp8_api_tpu_torch.models import flux as tflux
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline

torch.set_num_threads(1)

TINY = "configs/config-tiny-cpu.json"
BODY = {"width": 64, "height": 64, "num_steps": 4}
STEP_CHILDREN = ("dispatch", "pre", "double_blocks", "single_blocks", "final", "update")
PARENTS = {"queue": "request", "generate": "request", "preprocess": "generate", "prepare": "generate",
           "denoise": "generate", "decode": "generate", "text": "prepare", "vae_encode": "preprocess",
           "step": "denoise", "vae_decode": "decode", "jpeg": "decode",
           **{c: "step" for c in STEP_CHILDREN}}


@pytest.fixture(scope="module")
def server():
    srv = tserver.PipelineServer(FluxPipeline.load_pipeline_from_config_path(TINY), host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _post(srv, body):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate", data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as resp:
        return json.loads(resp.read())


def _program_spans(prof):
    return [(e.name[len(tracing.PREFIX):], e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith(tracing.PREFIX)]


def _every_thread():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))


def _inside(child, spans, parent):
    return [p for p in spans if p[0] == parent and p[1] <= child[1] and child[2] <= p[2]]


def _wait_for_replies(srv, n, timeout=10.0):
    """The reply is counted just after its last write, which the client may see first."""
    deadline = time.monotonic() + timeout
    while srv.replies.snapshot()["replies"] < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return srv.replies.snapshot()


@pytest.mark.parametrize("cache", [None, {"mode": "interval", "interval": 3}])
def test_a_request_emits_the_span_tree(server, cache):
    """One POST /generate under a profiler of every thread: each span once per request
    (``step`` once per schedule step, its children once per evaluated step, ``update``
    at every step), each child inside its parent, the reply after the request."""
    _post(server, {**BODY, "prompt": "warm", "seed": 1})
    with _every_thread() as prof:
        _post(server, {**BODY, "prompt": f"a house {cache}", "seed": 2, "cache": cache})
    _wait_for_replies(server, server.last_timings["replies"] + 1)
    spans = _program_spans(prof)
    counts = Counter(name for name, _, _ in spans)
    evaluations = 4 if cache is None else server.last_timings["cache_model_evals"]
    assert evaluations < 4 or cache is None
    assert counts == {"request": 1, "queue": 1, "generate": 1, "preprocess": 1, "prepare": 1, "text": 1,
                      "denoise": 1, "step": 4, "update": 4, "decode": 1, "vae_decode": 1, "jpeg": 1,
                      "reply": 1, **{c: evaluations for c in STEP_CHILDREN if c != "update"}}
    for sp in spans:
        if sp[0] in PARENTS:
            assert len(_inside(sp, spans, PARENTS[sp[0]])) == 1, sp
    (request,), (reply,) = ([sp for sp in spans if sp[0] == n] for n in ("request", "reply"))
    assert request[2] <= reply[1]


def test_img2img_times_the_encoder_inside_preprocess(server):
    img = (np.arange(64 * 64 * 3) % 251).astype(np.uint8).reshape(64, 64, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server.pipeline.generate("a cat", 64, 64, 4, seed=3, init_image=img, strength=0.5, silent=True)
    spans = _program_spans(prof)
    (encode,) = [sp for sp in spans if sp[0] == "vae_encode"]
    assert len(_inside(encode, spans, "preprocess")) == 1
    assert 0 < server.pipeline.timings["encode_seconds"] <= (encode[2] - encode[1]) / 1e6 + 1e-3


def test_without_a_profiler_no_record_function_is_made(server, monkeypatch):
    """The same request profiled, then with ``record_function`` raising wherever it is
    made: the same JPEG bytes and latents."""
    body = {**BODY, "prompt": "a quiet lake", "seed": 5}
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = server.handle_generate(body)[2]
    latents = server.pipeline.last_latents.clone()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.recording()
    assert server.handle_generate(body)[2] == profiled
    assert torch.equal(server.pipeline.last_latents, latents)
    assert tracing.span("step") is tracing.span("update")  # one shared context, nothing made


def test_text_seconds_on_a_miss_and_not_on_a_full_hit(server):
    pipe = server.pipeline
    pipe.generate("a prompt never seen", 64, 64, 4, seed=1, silent=True)
    t = dict(pipe.timings)
    assert t["cond_cache_misses"] == 1 and 0 < t["text_seconds"] <= t["prepare_seconds"]
    pipe.generate("a prompt never seen", 64, 64, 4, seed=1, silent=True)
    assert pipe.timings["cond_cache_hits"] == 1 and "text_seconds" not in pipe.timings


def test_compiled_dispatch_counters(monkeypatch):
    """A warmed compiled pipeline builds no graph and runs nothing eagerly; a bucket past
    the admitted ones runs eagerly, and the counters say so."""
    monkeypatch.setattr(tflux, "COMPILE_BACKEND", "aot_eager")
    tflux.reset_compiled()
    try:
        pipe = FluxPipeline.load_pipeline_from_config_path(
            TINY, compile_blocks=True, compile_extras=True, warmup_resolutions=[[64, 64]], warmup_steps=4)
        pipe.generate("a cat", 64, 64, 4, seed=1, silent=True)
        t = pipe.timings
        # four functions chosen per evaluation, four evaluations
        assert (t["compiled_calls"], t["graphs_built"], t["eager_calls"]) == (16, 0, 0)
        monkeypatch.setattr(tflux, "MAX_COMPILED_BUCKETS", 1)
        pipe.generate("a cat", 80, 64, 4, seed=1, silent=True)
        assert (pipe.timings["compiled_calls"], pipe.timings["graphs_built"], pipe.timings["eager_calls"]) == (0, 0, 16)
    finally:
        tflux.reset_compiled()


def test_stdlib_replies_count_one_write_and_reach_the_next_request(server):
    """In a closed loop, request k's ``last_timings`` holds the replies through k − 1."""
    before = _wait_for_replies(server, server.replies.snapshot()["replies"])
    for k in range(3):
        payload = _post(server, {**BODY, "prompt": f"loop {k}", "seed": k})
        assert server.last_timings["replies"] == before["replies"] + k
        assert len(payload) > 0
    after = _wait_for_replies(server, before["replies"] + 3)
    assert after["replies"] == before["replies"] + 3
    assert after["reply_writes"] - before["reply_writes"] == 3
    assert after["reply_seconds"] > before["reply_seconds"]
    metrics = _get(server, "/metrics")
    assert {"requests", "total_seconds", "last_seconds", "avg_seconds", "request_id", "queue_seconds",
            "replies", "reply_seconds", "reply_writes", "text_seconds", "prepare_seconds", "denoise_seconds",
            "decode_seconds", "compiled_calls", "graphs_built", "eager_calls"} <= set(metrics)
    assert "images" not in metrics and metrics["replies"] >= after["replies"]
    assert set(server.metrics) == {"requests", "total_seconds", "last_seconds"}


def test_last_seconds_holds_the_lock_wait(server):
    server.lock.acquire()
    releaser = threading.Timer(0.3, server.lock.release)
    releaser.start()
    _post(server, {**BODY, "prompt": "waits", "seed": 9})
    releaser.join(5)
    assert not releaser.is_alive()
    queued = server.last_timings["queue_seconds"]
    assert queued >= 0.25 and server.metrics["last_seconds"] > queued + server.last_timings["denoise_seconds"]


def _asgi_run(app, path, chunks, fail_at=None):
    """Drive an ASGI app through ``tserver.ReplyTimer`` once; → the messages sent."""
    sent = []

    async def send(message):
        if fail_at is not None and len(sent) == fail_at:
            raise ConnectionResetError("the client went away")
        sent.append(message)

    async def receive():
        return {"type": "http.request", "body": b"{}", "more_body": False}

    srv = tserver.PipelineServer(None)
    timer = tserver.ReplyTimer(app(chunks), server=lambda: srv)
    scope = {"type": "http", "method": "POST", "path": path}
    try:
        asyncio.run(timer(scope, receive, send))
    except ConnectionResetError:
        pass
    return srv.replies.snapshot(), sent


def _streaming_app(chunks):
    async def app(scope, receive, send):
        await send({"type": "http.response.start", "status": 200, "headers": []})
        for c in chunks:
            await send({"type": "http.response.body", "body": c, "more_body": True})
        await send({"type": "http.response.body", "body": b"", "more_body": False})

    return app


def _whole_app(chunks):
    """What ``Response`` sends: the start, then the whole body in one last message."""
    async def app(scope, receive, send):
        await send({"type": "http.response.start", "status": 200, "headers": []})
        await send({"type": "http.response.body", "body": b"".join(chunks), "more_body": False})

    return app


@pytest.mark.parametrize("app, writes, messages, fail_at",
                         [(_streaming_app, 3, 5, 2), (_whole_app, 1, 2, 1)], ids=["streamed", "whole"])
def test_the_asgi_wrapper_counts_body_messages_that_carry_bytes(app, writes, messages, fail_at):
    totals, sent = _asgi_run(app, "/generate", [b"a\n", b"b\n", b"c"])
    assert (totals["replies"], totals["reply_writes"]) == (1, writes) and totals["reply_seconds"] > 0
    assert len(sent) == messages  # every message passed on as it was
    assert _asgi_run(app, "/lora", [b"x"])[0]["replies"] == 0
    totals, sent = _asgi_run(app, "/generate", [b"a", b"b"], fail_at=fail_at)
    assert totals["replies"] == 0 and len(sent) == fail_at  # cut short: closed, not counted


def test_fastapi_replies_in_one_write_with_its_length(server):
    """POST /generate leaves the FastAPI app as one body message framed by its length,
    the stdlib server's bytes for the same body and seed."""
    pytest.importorskip("fastapi")
    pytest.importorskip("httpx")  # fastapi's TestClient
    from fastapi.testclient import TestClient

    from flux_fp8_api_tpu_torch.api import app

    body = {**BODY, "prompt": "one write", "seed": 3}
    app.state.model = server.pipeline
    try:
        client = TestClient(app)
        before = app.state.server.replies.snapshot()
        resp = client.post("/generate", json=body)
        assert resp.status_code == 200 and resp.headers["content-type"] == "image/jpeg"
        after = app.state.server.replies.snapshot()
        assert after["replies"] - before["replies"] == 1
        assert after["reply_writes"] - before["reply_writes"] == 1
        assert int(resp.headers["content-length"]) == len(resp.content) > 0
        assert "chunked" not in resp.headers.get("transfer-encoding", "")
        assert resp.headers["x-seed"] == "3"
        assert resp.content == _post(server, body)
    finally:
        app.state.model = None
