"""Starting the ranks of a serving mesh, and the loop the followers run.

JAX runs one controller, so this module has no JAX counterpart. Here every rank of the
mesh is a process (``parallel/mesh.py``). The first rank serves HTTP; the others
follow:

- the first rank validates a request (a 400 never reaches the followers), then
  broadcasts it — the ``generate`` kwargs, or a LoRA load or unload — over the mesh's
  control group (:class:`MeshPipeline`);
- every rank runs it, and every rank reports whether it failed; the first rank
  answers, with the image or, when any rank failed, with the error (a 500);
- the compute collectives carry the process group's timeout, so a rank that dies
  mid-request makes the others raise instead of hanging forever.

:func:`run_ranks` starts the world: under ``torchrun`` the ranks come from the
environment; otherwise it spawns one process per rank itself (start method
``spawn``), so one command serves a mesh as the JAX CLI's does.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def free_port() -> int:
    """A free TCP port on this host for the ranks' rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, world: int, port: int, fn: Callable, args: tuple) -> None:
    """One spawned rank: torchrun's environment, then ``fn(*args)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    fn(*args)


def run_ranks(fn: Callable, world: int, args: tuple = ()) -> None:
    """Run ``fn(*args)`` on every rank of a world of ``world`` processes: here when
    this process is already one of them (torchrun) or the world is one process, else
    in ``world`` spawned processes, joined here (one failing rank ends the others)."""
    if world == 1 or under_torchrun():
        fn(*args)
        return
    import torch.multiprocessing as mp

    mp.start_processes(_rank_entry, args=(world, free_port(), fn, args), nprocs=world,
                       join=True, start_method="spawn")


def _execute(pipe, op: str, kwargs: Dict[str, Any]):
    """Run one broadcast operation on this rank; raise on every rank when any rank
    failed."""
    error: Optional[BaseException] = None
    out = None
    try:
        out = getattr(pipe, op)(**kwargs)
    except Exception as e:  # reported to every rank below, then re-raised
        logger.exception("rank %d: %s failed", pipe.mesh.global_rank, op)
        error = e
    if pipe.mesh.any_failed(error is not None):
        if error is not None:
            raise error
        raise RuntimeError(f"{op} failed on another rank of the mesh")
    return out


class MeshPipeline:
    """The first rank's view of a meshed :class:`~..pipeline.FluxPipeline` for the
    servers: ``generate``, ``load_lora`` and ``unload_lora`` are broadcast to the
    followers and run on every rank; everything else reads this rank's pipeline."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.mesh = pipe.mesh

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def _run(self, op: str, **kwargs):
        self.mesh.broadcast_object({"op": op, "kwargs": kwargs})
        return _execute(self._pipe, op, kwargs)

    def generate(self, **kwargs):
        if kwargs.get("seed") is None:  # one seed for every rank
            kwargs["seed"] = self._pipe.set_seed(None)[1]
        return self._run("generate", **kwargs)

    def load_lora(self, lora_path, scale: float, name: Optional[str] = None):
        return self._run("load_lora", lora_path=lora_path, scale=scale, name=name)

    def unload_lora(self, path_or_identifier: str):
        return self._run("unload_lora", path_or_identifier=path_or_identifier)

    def stop(self) -> None:
        """Release the followers from their loop."""
        self.mesh.broadcast_object({"op": "stop"})


def follower_loop(pipe) -> None:
    """A follower's life: run what the first rank broadcasts until it says stop."""
    while True:
        msg = pipe.mesh.broadcast_object(None)
        if msg["op"] == "stop":
            return
        try:
            _execute(pipe, msg["op"], msg["kwargs"])
        except Exception:  # logged by _execute; the first rank answers the request
            pass
