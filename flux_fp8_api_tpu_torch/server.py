"""Stdlib HTTP server with the reference API surface
(JAX counterpart: ``flux_fp8_api_tpu.server``; reference api.py:27-122).

Endpoints and JSON shapes are the JAX server's:

- POST /generate  {prompt, width, height, num_steps, guidance, seed, strength,
                   init_image, cache, input_image} → image/jpeg (+ ``X-Seed``: the
                   seed used); a malformed ``cache``, any cache under pipeline
                   parallelism, and a request the pipeline refuses
                   (``pipeline.RequestError``: an ``input_image`` where no Kontext
                   model serves it, ...) answer 400, and a pipeline feature not
                   ported yet (``NotImplementedError``) 501
- POST /lora      {action: load|unload, path, name, scale} → JSON status
- GET  /          the browser UI (``webui.py``)
- GET  /health (with the fused LoRAs' names, and the mesh of a meshed pipeline),
  GET /metrics

One lock serialises generate and LoRA calls. ``api.py`` serves the same handlers
under FastAPI.

The server numbers its generate requests and opens the ``request``, ``queue`` and
``reply`` spans of ``tracing.py``. ``last_timings`` is the last generate's ``timings``
with its ``request_id``, its ``queue_seconds`` (the wait for the lock) and the reply
totals (``replies``, ``reply_seconds``, ``reply_writes``: replies to POST /generate
sent, their seconds from the response's start to its last body message, and their
body writes) as they stood when its generate ended; GET /metrics shows them as they
stand.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

import numpy as np

from . import tracing
from .pipeline import RequestError
from .sampling import CacheConfig
from .webui import render_index

MAX_RAND = 2**32 - 1

logger = logging.getLogger(__name__)

GENERATE_DEFAULTS: Dict[str, Any] = {
    "width": 720,
    "height": 1024,
    "num_steps": 24,
    "guidance": 3.5,
    "seed": None,
    "strength": 1.0,
    "init_image": None,
    "cache": None,
    "input_image": None,  # a Kontext model's context image (base64), BFL's API name
}


def _error(status: int, message: str):
    return status, "application/json", json.dumps({"status": "error", "message": message}).encode()


class PipelineServer:
    def __init__(self, pipeline, host: str = "0.0.0.0", port: int = 8088):
        self.pipeline = pipeline
        self.host = host
        self.port = port
        self.lock = threading.Lock()
        self.metrics = {"requests": 0, "total_seconds": 0.0, "last_seconds": None}
        self.last_timings: Dict[str, Any] = {}  # of the last completed request
        self.replies = tracing.Totals(replies=0, reply_seconds=0.0, reply_writes=0)
        self._request_ids = itertools.count(1)
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------------- handlers
    def handle_generate(self, body: Dict[str, Any]):
        """→ (status, content_type, payload, headers), error paths included.
        ``metrics["last_seconds"]``: the ``request`` span to the end of generate, the
        wait for the lock included."""
        if "prompt" not in body:
            return (*_error(400, "prompt is required"), {})
        args = dict(GENERATE_DEFAULTS)
        args.update({k: v for k, v in body.items() if k in GENERATE_DEFAULTS or k == "prompt"})
        if args.get("seed") is None:
            args["seed"] = int(np.random.randint(0, MAX_RAND))
        try:
            args["cache"] = CacheConfig.parse(args.get("cache"))
        except (TypeError, ValueError) as e:
            return (*_error(400, str(e)), {})
        mesh = getattr(self.pipeline, "mesh", None)
        if args["cache"].mode != "none" and mesh is not None and mesh.size("pp") > 1:
            # validated here, before the request reaches the mesh (the JAX package
            # raises inside the request, a 500)
            return (*_error(400, "the step cache does not run under pipeline parallelism (pp): "
                                 "send the request without a cache"), {})
        request_id = next(self._request_ids)
        with tracing.timed("request", args=str(request_id)) as request:
            with tracing.timed("queue") as queue:
                self.lock.acquire()
            try:
                with tracing.span("generate"):
                    out = self.pipeline.generate(silent=True, **args)
            except RequestError as e:
                return (*_error(400, str(e)), {})
            except NotImplementedError as e:
                return (*_error(501, str(e)), {})
            else:
                dt = request.elapsed()
                self.metrics["requests"] += 1
                self.metrics["total_seconds"] += dt
                self.metrics["last_seconds"] = dt
                self.last_timings = {**getattr(self.pipeline, "timings", {}), "request_id": request_id,
                                     "queue_seconds": queue.seconds, **self.replies.snapshot()}
            finally:
                self.lock.release()
        return 200, "image/jpeg", out.getvalue(), {"x-seed": str(args["seed"])}

    def count_reply(self, seconds: float, writes: int) -> None:
        """One reply to POST /generate sent, in ``seconds`` and ``writes`` body writes."""
        self.replies.add(replies=1, reply_seconds=seconds, reply_writes=writes)

    def handle_lora(self, body: Dict[str, Any]):
        """→ (status, content_type, payload): the JAX server's envelopes and messages
        (reference api.py:89-122)."""
        action = body.get("action", "load")
        try:
            if action == "load":
                if not body.get("path"):
                    return _error(400, "Lora path is required")
                with self.lock:
                    self.pipeline.load_lora(lora_path=body["path"], scale=body.get("scale", 1.0),
                                            name=body.get("name"))
                msg = f"LoRA {body['path']} loaded successfully"
            elif action == "unload":
                ident = body.get("name") or body.get("path")
                if not ident:
                    return _error(400, "Lora path or name is required")
                with self.lock:
                    self.pipeline.unload_lora(ident)
                msg = f"LoRA {ident} unloaded successfully"
            else:
                return _error(400, f"Invalid action {action}")
        except Exception as e:  # reference api.py:105-121: the failure in the envelope
            logger.exception("LoRA %s failed", action)
            return _error(500, str(e))
        return 200, "application/json", json.dumps({"status": "success", "message": msg}).encode()

    def handle_health(self):
        out = {
            "status": "ok" if self.pipeline is not None else "loading",
            "model": getattr(self.pipeline, "name", None),
            "loras": [entry.name for entry in getattr(self.pipeline, "loras", [])],
        }
        mesh = getattr(self.pipeline, "mesh", None)
        if mesh is not None:  # a meshed pipeline: its axes and this rank's device
            out["mesh"] = {"shape": mesh.shape, "backend": mesh.backend, "device": str(mesh.device)}
        return 200, "application/json", json.dumps(out).encode()

    def handle_metrics(self):
        out = dict(self.metrics)
        if out["requests"]:
            out["avg_seconds"] = out["total_seconds"] / out["requests"]
        out.update(self.last_timings)
        out.update(self.replies.snapshot())
        return 200, "application/json", json.dumps(out).encode()

    # --------------------------------------------------------------------- server
    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, status: int, ctype: str, payload: bytes, headers=None):
                self.send_response(status)
                self.send_header("content-type", ctype)
                self.send_header("content-length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/health":
                    self._send(*server.handle_health())
                elif self.path == "/metrics":
                    self._send(*server.handle_metrics())
                elif self.path in ("/", "/index.html"):
                    self._send(200, "text/html; charset=utf-8", render_index(server.pipeline))
                else:
                    self._send(404, "application/json", b'{"detail":"Not Found"}')

            def do_POST(self):
                length = int(self.headers.get("content-length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, "application/json", b'{"detail":"invalid JSON"}')
                    return
                try:
                    if self.path == "/generate":
                        reply = server.handle_generate(body)
                        with tracing.timed("reply") as sent:
                            self._send(*reply)
                        server.count_reply(sent.seconds, 1)  # _send writes the body once
                    elif self.path == "/lora":
                        self._send(*server.handle_lora(body))
                    else:
                        self._send(404, "application/json", b'{"detail":"Not Found"}')
                except BrokenPipeError:
                    pass
                except Exception as e:  # the boundary: report the failure, keep serving
                    logger.exception("POST %s failed", self.path)
                    self._send(*_error(500, str(e)))

        return Handler

    def _bind(self):
        self._httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        # port=0 asks the OS for a free ephemeral port; reflect what was bound
        self.port = self._httpd.server_address[1]

    def serve_forever(self):
        self._bind()
        print(f"flux-fp8-api-tpu-torch serving on http://{self.host}:{self.port}")
        self._httpd.serve_forever()

    def start_background(self):
        self._bind()
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


class ReplyTimer:
    """An ASGI wrapper around ``app`` that opens the ``reply`` span of each POST
    /generate at its response's start, closes it when its last body message has been
    sent, and counts the reply, its seconds and its body messages that carry bytes in
    ``server()``'s totals, whatever Response class serves the body. A reply cut short
    closes its span and is not counted."""

    def __init__(self, app, server: Callable[[], PipelineServer]):
        self.app, self.server = app, server

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http" or scope["method"] != "POST" or scope["path"] != "/generate":
            await self.app(scope, receive, send)
            return
        reply, writes = None, 0

        async def timed_send(message):
            nonlocal reply, writes
            if message["type"] == "http.response.start":
                reply = tracing.timed("reply").__enter__()
            await send(message)
            if message["type"] == "http.response.body":
                writes += bool(message.get("body"))
                if not message.get("more_body", False):
                    reply.__exit__(None, None, None)
                    self.server().count_reply(reply.seconds, writes)
                    reply = None

        try:
            await self.app(scope, receive, timed_send)
        finally:
            if reply is not None:
                reply.__exit__(None, None, None)


def serve(pipeline, host: str = "0.0.0.0", port: int = 8088):
    PipelineServer(pipeline, host, port).serve_forever()
