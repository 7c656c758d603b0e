"""The program's spans and counters, from a request to its reply.

A span names a stretch of host time: ``with span("step"):``. While a ``torch.profiler``
records (``FluxPipeline.profile``, or any profiler over the process), each span is also
a ``torch.profiler.record_function("flux.<name>")``, so the profiler places it on the
timeline of the device's kernels. With none recording a span site costs one flag read
and a branch: it makes no ``record_function`` and, for :func:`span`, allocates nothing.
:func:`timed` spans also take the host clock always, for the pipeline's ``timings``
and the server's ``metrics``. Spans sit in the eager Python around compiled calls,
never inside a ``torch.compile``'d function.

The spans of one request, nested on the handler's thread (``server.py``; ``reply`` on
the thread that sends the response)::

    request                        the generate handler from its wait for the lock
      queue                        the wait for the generate lock
      generate                     the server's call of FluxPipeline.generate
        preprocess                 noise, schedule; vae_encode for an init image
        context                    a Kontext request's context image: decode,
                                   resize, VAE encode, pack, ending in a device sync
        prepare                    ids, packing and text
          text                     T5, CLIP, emphasis for the conditioning-cache
                                   misses, offload moves; under a profiler it ends
                                   in a device sync
        denoise                    the loop, ending in a device sync
          step                     one schedule step: its enqueue, since no step
                                   waits for the card (the dynamic cache's one
                                   read per unforced step aside)
            dispatch               Compiled.functions: the bucket and its admission
            pre, double_blocks, single_blocks, final
            update                 the Euler step
        decode
          vae_decode               ending in host pixels
          jpeg
    reply                          the response's start to its last body message

Counters: ``models/flux.py:COMPILED_CALLS``, ``COMPILES`` and ``EAGER_CALLS``, whose
deltas each generate puts in its ``timings``; a Kontext request's context tokens
(``timings["context_tokens"]``); on a card, the denoise steps whose enqueue began while
the card still ran the step before (``timings["steps_ahead"]``, ``sampling.Lead``: an
event after each step's update, queried without a wait); the server's reply totals
(:class:`Totals`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch.autograd.profiler as _profiler

PREFIX = "flux."

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process now."""
    return _profiler._is_profiler_enabled


def span(name: str, args: Optional[str] = None):
    """The span ``name``: a ``record_function`` while a profiler records, else a shared
    context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(PREFIX + name, args)


class timed:
    """A span that also takes the host clock: ``seconds`` after a normal exit, written
    to ``into[key]`` where given; :meth:`elapsed` while it is open. An exception
    leaves ``into`` as it was."""

    __slots__ = ("name", "args", "into", "key", "start", "seconds", "_record")

    def __init__(self, name: str, into: Optional[Dict] = None, key: Optional[str] = None,
                 args: Optional[str] = None):
        self.name, self.args, self.into, self.key = name, args, into, key
        self.start = self.seconds = None

    def __enter__(self) -> "timed":
        self._record = span(self.name, self.args)
        self._record.__enter__()
        self.start = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def __exit__(self, exc_type, exc, tb) -> bool:
        seconds = self.elapsed()
        self._record.__exit__(exc_type, exc, tb)
        if exc_type is None:
            self.seconds = seconds
            if self.into is not None:
                self.into[self.key] = seconds
        return False


class Totals:
    """Running totals that several threads add to, under a lock of their own."""

    def __init__(self, **zero):
        self._lock = threading.Lock()
        self._values = dict(zero)

    def add(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._values[k] += v

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(self._values)
