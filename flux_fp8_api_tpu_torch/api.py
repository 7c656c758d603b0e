"""FastAPI app (JAX counterpart: ``flux_fp8_api_tpu.api``; reference ``api.py:1-123``):
POST /generate → streamed JPEG with ``x-seed``, POST /lora → load/unload, GET / (the
browser UI), GET /health and /metrics.

The request schemas are the JAX app's, validated by pydantic (422 on a malformed
body). The work, the lock that serialises /generate against /lora, the counters and
the LoRA envelopes are the stdlib server's (:class:`.server.PipelineServer`), run on
``app.state.model``; the 400s are raised as FastAPI's ``{"detail": ...}``, as in the
JAX app.

    app.state.model = pipeline
    uvicorn.run(app, host=..., port=...)
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np

try:
    from fastapi import FastAPI, HTTPException
    from fastapi.responses import JSONResponse, Response, StreamingResponse
except ImportError as e:
    raise ImportError(
        "fastapi is not installed; the stdlib server (flux_fp8_api_tpu_torch.server) "
        "provides the same endpoints without extra wheels"
    ) from e
from pydantic import BaseModel, Field

from .server import MAX_RAND, PipelineServer
from .webui import render_index

app = FastAPI()
app.state.model = None
app.state.server = PipelineServer(None)


class GenerateArgs(BaseModel):
    """reference api.py:38-48."""

    prompt: str
    width: Optional[int] = Field(default=720)
    height: Optional[int] = Field(default=1024)
    num_steps: Optional[int] = Field(default=24)
    guidance: Optional[float] = Field(default=3.5)
    # ge=0, not the reference's gt=0 (api.py:46): its own default factory can draw 0
    seed: Optional[int] = Field(default_factory=lambda: np.random.randint(0, MAX_RAND), ge=0, lt=MAX_RAND)
    strength: Optional[float] = 1.0
    init_image: Optional[str] = None
    cache: Optional[dict] = None


class LoraArgs(BaseModel):
    """reference api.py:27-31."""

    scale: Optional[float] = 1.0
    path: Optional[str] = None
    name: Optional[str] = None
    action: Optional[str] = "load"  # "load" | "unload"


class LoraLoadResponse(BaseModel):
    status: str
    message: str


def _server() -> PipelineServer:
    """The handlers, on the pipeline the app serves now."""
    server = app.state.server
    server.pipeline = app.state.model
    return server


def _raise_client_error(status: int, payload: bytes) -> None:
    if status in (400, 501):
        raise HTTPException(status_code=status, detail=json.loads(payload)["message"])


@app.post("/generate")
def generate(args: GenerateArgs):
    """Generate an image from the prompt (reference api.py:54-86)."""
    status, ctype, payload, headers = _server().handle_generate(args.model_dump())
    _raise_client_error(status, payload)
    return StreamingResponse(io.BytesIO(payload), media_type=ctype, headers=headers)


@app.post("/lora", response_model=LoraLoadResponse)
def lora_action(args: LoraArgs):
    """Load or unload a LoRA (reference api.py:89-122): the same 400/500 envelopes."""
    status, _, payload = _server().handle_lora(args.model_dump())
    _raise_client_error(status, payload)
    return JSONResponse(content=json.loads(payload), status_code=status)


@app.get("/")
def index():
    """The browser UI (webui.py), the page the stdlib server serves at /."""
    return Response(content=render_index(app.state.model), media_type="text/html; charset=utf-8")


@app.get("/health")
def health() -> dict:
    return json.loads(_server().handle_health()[2])


@app.get("/metrics")
def metrics() -> dict:
    """Request counters, latency and the last request's per-phase timings, incl.
    ``denoise_it_per_s`` (the reference's headline rate, flux_pipeline.py:628-630)."""
    return json.loads(_server().handle_metrics()[2])
