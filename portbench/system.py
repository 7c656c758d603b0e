"""The system under test: the port's FastAPI app served by uvicorn in this process,
and the stand-in for the program's checkpoint reader through which a family's
``build`` loads the weights the benchmark drew.

This module, the family modules' ``build`` and ``keep``, and ``trace.spans`` are the
benchmark's only contact with the program's insides.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional
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


@contextlib.contextmanager
def drawn_checkpoints(models: Dict):
    """While open, the program's loaders read a checkpoint path ``drawn:<name>`` from
    ``models[name]`` (a :class:`portbench.weights.Weights`) by its tensors' names, as
    they would read a safetensors file."""
    from flux_fp8_api_tpu_torch.utils import checkpoint, loader

    drawn = _drawn_file_class(models)
    with contextlib.ExitStack() as stack:
        for mod in (loader, checkpoint):
            stack.enter_context(mock.patch.object(mod, "SafetensorsFile", drawn))
        yield


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
