"""The system under test: the port's pipeline, built as a configuration ships it from
weights the benchmark drew, and its FastAPI app served by uvicorn in this process.

This module and ``trace.spans`` are the benchmark's only contact with the program's
insides. The flow and the VAE load through the program's own checkpoint path, as a
BFL file would: a stand-in for its safetensors reader hands out the drawn tensors by
their BFL names.
T5 and CLIP are built from their published sizes through the program's config
classes, HF-name loaders, weight-only tiers and ``TextEncoder``, with the word-level
tokenizer the program draws for random weights.
"""

from __future__ import annotations

import threading
import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Dict, Optional, Tuple
from unittest import mock

DRAWN = "drawn:"  # the path prefix the stand-in reader answers to


def _drawn_file_class(models: Dict):
    from flux_fp8_api_tpu_torch.utils.safetensors_io import SafetensorsFile

    class DrawnFile(SafetensorsFile):
        """The program's safetensors reader over ``models[name]`` for a path
        ``drawn:<name>``."""

        def __init__(self, path, use_native: bool = False):
            self.path, self.use_native, self.metadata = path, False, {}
            self._w = models[str(path)[len(DRAWN):]]

        def keys(self):
            return self._w.keys()

        def __contains__(self, name: str) -> bool:
            return name in self._w

        def get(self, name: str, index: Optional[int] = None):
            t = self._w.get(name)
            return t if index is None else t[index]

    return DrawnFile


def model_spec(spec: Dict, overrides: Dict):
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec

    return ModelSpec(**{**spec["spec"], **overrides})


def build_pipeline(spec: Dict, weights: Dict, overrides: Dict, mark=lambda phase: None):
    """The configuration's ``FluxPipeline`` over the drawn weights. Its constructor
    calibrates and, with the compile flags, warms ``overrides["warmup_resolutions"]``.
    ``mark(phase)`` is called as each phase of the build ends: ``flow`` (drawn and
    quantized), ``ae``, ``text`` (T5 and CLIP), ``calibrate``, ``warm`` (the buckets
    compiled or read from the cache, and run)."""
    from flux_fp8_api_tpu_torch.models.clip import CLIPConfig, load_clip_checkpoint
    from flux_fp8_api_tpu_torch.models.conditioner import TextEncoder, apply_quantization
    from flux_fp8_api_tpu_torch.models.t5 import T5Config, load_t5_checkpoint
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils import checkpoint, loader
    from flux_fp8_api_tpu_torch.utils.config import into_device, into_dtype

    config = model_spec(spec, {"ckpt_path": DRAWN + "flux", "ae_path": DRAWN + "ae", **overrides})
    drawn = _drawn_file_class(weights)
    with ExitStack() as stack:
        for mod in (loader, checkpoint):
            stack.enter_context(mock.patch.object(mod, "SafetensorsFile", drawn))
        flow, flow_cfg, _ = loader.load_flow_model(config)
        weights["flux"].release()
        mark("flow")
        ae = loader.load_autoencoder(config)
        weights["ae"].release()
        mark("ae")
    device, dtype = into_device(config.text_enc_device), into_dtype(config.text_enc_dtype)
    t5_cfg, clip_cfg = T5Config(**spec["t5"]), CLIPConfig(**spec["clip"])
    t5 = TextEncoder(
        "t5", apply_quantization("t5", load_t5_checkpoint(weights["t5"].get, t5_cfg, dtype, device=device),
                                 config.text_enc_quantization_dtype),
        t5_cfg, loader.ToyTokenizer("t5"), max_length=config.text_enc_max_length, dtype=dtype, device=device,
        offload=config.offload_text_encoder, stream=config.stream_text_encoder)
    weights["t5"].release()
    clip = TextEncoder(
        "clip", apply_quantization("clip", load_clip_checkpoint(weights["clip"].get, clip_cfg, dtype, device=device),
                                   config.clip_quantization_dtype),
        clip_cfg, loader.ToyTokenizer("clip"), max_length=77, dtype=dtype, device=device,
        offload=config.offload_text_encoder)
    weights["clip"].release()
    mark("text")
    warmup = FluxPipeline.warmup

    def timed_warmup(self, *args, **kwargs):
        mark("calibrate")
        return warmup(self, *args, **kwargs)

    with mock.patch.object(FluxPipeline, "warmup", timed_warmup):
        pipeline = FluxPipeline(name=str(getattr(config.version, "value", config.version)), clip=clip, t5=t5,
                                model=flow, model_cfg=flow_cfg, ae=ae, config=config, prequantized=False)
    mark("warm")
    return pipeline


@dataclass
class Served:
    """A running server: its port, its request counters and how to stop it."""

    port: int
    counters: object  # the app's PipelineServer: ``metrics["last_seconds"]``
    stop: callable


def serve(pipeline, timeout: float = 60.0) -> Served:
    """``api.app`` serving ``pipeline`` under uvicorn on 127.0.0.1, on a port the OS
    picks, in a thread of this process."""
    import uvicorn
    from flux_fp8_api_tpu_torch.api import app

    app.state.model = pipeline
    server = uvicorn.Server(uvicorn.Config(app, host="127.0.0.1", port=0, log_level="warning",
                                           access_log=False, lifespan="off"))
    thread = threading.Thread(target=server.run, name="uvicorn", daemon=True)
    thread.start()
    deadline = time.monotonic() + timeout
    while not server.started:
        if time.monotonic() > deadline or not thread.is_alive():
            raise RuntimeError("uvicorn did not start")
        time.sleep(0.05)
    port = server.servers[0].sockets[0].getsockname()[1]

    def stop():
        server.should_exit = True
        thread.join(timeout)
        if thread.is_alive():
            raise RuntimeError("uvicorn did not stop")
        app.state.model = None

    return Served(port, app.state.server, stop)


def conditioning(pipeline, prompt: str) -> Optional[Tuple]:
    """The (pooled CLIP, weighted T5) the served path computed for ``prompt``, from the
    pipeline's conditioning cache, while it still holds the entry."""
    return pipeline._cond_cache.get((prompt, pipeline.config.text_enc_max_length))
