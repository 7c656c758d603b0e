"""The traced part of a run: a few served requests under ``torch.profiler``, reduced in
memory to kernel totals, device busy time and idle gaps, with the host spans the
benchmark records around its calls into the program's layers.

Spans (``torch.profiler.record_function``, opened by the benchmark, never by the
program): ``request`` (the client's round trip), ``handler`` (the server's generate
handler), and the pipeline's ``preprocess_latent``, ``prepare``, ``denoise``,
``vae_decode`` and ``into_bytes``. Each stretch of the device's idle time is named
after the innermost span open over it.
"""

from __future__ import annotations

import contextlib
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
SPAN = "portbench."

# (kind, substrings of a kernel's name), first match wins: a frozen copy of
# profile_step.py's KINDS
KINDS = (
    ("attention, K1 (qknorm_attention)", ("qknorm_attention",)),
    ("fused by inductor (triton_*)", ("triton_",)),
    ("rope pass backward (rope_rotate, backward build)", ("rope_rotate_kernel<true>",)),
    ("rope pass (rope_rotate)", ("rope_rotate",)),
    ("attention, SDPA forward and backward (flash / cuDNN / efficient)", ("flash", "fmha", "sdpa", "cudnn")),
    ("optimizer and clip (foreach)", ("multi_tensor",)),
    ("GEMMs (cuBLAS/cuBLASLt)", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
    ("norms and reductions", ("reduce", "norm", "softmax")),
    ("copies and casts (the fp8 activation cast among them)", ("copy", "cat", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def kernel_family(name: str) -> Dict:
    """``kernels/<name>.json``: which kernel names belong to a family of kernels."""
    return json.loads((HERE / "kernels" / f"{name}.json").read_text())


def in_family(kernel: str, family: Dict) -> bool:
    low = kernel.lower()
    return any(p in low for p in family["include"]) and not any(p in low for p in family.get("exclude", []))


@dataclass
class Trace:
    """What the traced requests left: kernels as (name, start µs, end µs), spans as
    (name, start µs, end µs), the window [start, end] µs."""

    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of kernel intervals, clipped to the window."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def busy_within(self, span: str) -> Tuple[float, float]:
        """(seconds of the spans named ``span`` in the window, seconds of those in
        which a kernel ran)."""
        busy = self.busy_intervals()
        total = inside = 0.0
        for name, s, e in self.spans:
            s, e = max(s, self.start), min(e, self.end)
            if name != span or e <= s:
                continue
            total += e - s
            inside += sum(max(0.0, min(e, b) - max(s, a)) for a, b in busy)
        return total / 1e6, inside / 1e6

    def kernel_seconds(self, pred=lambda name: True) -> Tuple[float, int]:
        """(seconds, launches) of the kernels in the window whose name passes ``pred``."""
        sel = [(s, e) for n, s, e in self.kernels if pred(n) and s >= self.start and e <= self.end]
        return sum(e - s for s, e in sel) / 1e6, len(sel)

    def by_kind(self) -> List[Tuple[str, float]]:
        acc: Dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            if s >= self.start and e <= self.end:
                acc[kind_of(n)] += (e - s) / 1e6
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def top_kernels(self, n: Optional[int] = 40, pred=lambda name: True) -> List[Tuple[str, float, int]]:
        """(name, seconds, launches) of the ``n`` kernels (all, for None) whose name
        passes ``pred`` that took most time in the window."""
        acc: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for name, s, e in self.kernels:
            if s >= self.start and e <= self.end and pred(name):
                acc[name][0] += (e - s) / 1e6
                acc[name][1] += 1
        return [(k, v[0], v[1]) for k, v in sorted(acc.items(), key=lambda kv: -kv[1][0])[:n]]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds in the window by what the host was in: each stretch of a gap
        goes to the innermost span open over it ("outside any span" where none is)."""
        acc: Dict[str, float] = defaultdict(float)
        prev = self.start
        for s, e in self.busy_intervals() + [(self.end, self.end)]:
            if s > prev:
                over = [sp for sp in self.spans if sp[1] < s and sp[2] > prev]
                cuts = sorted({prev, s} | {t for sp in over for t in sp[1:] if prev < t < s})
                for a, b in zip(cuts, cuts[1:]):
                    open_ = [sp for sp in over if sp[1] <= a and sp[2] >= b]
                    label = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "outside any span"
                    acc[label] += (b - a) / 1e6
            prev = max(prev, e)
        return sorted(acc.items(), key=lambda kv: -kv[1])


def family_kernels(trace: Trace) -> Dict[str, List[Tuple[str, float, int]]]:
    """For each family of ``kernels/``, every kernel of the window it takes."""
    out = {}
    for path in sorted((HERE / "kernels").glob("*.json")):
        fam = kernel_family(path.stem)
        out[path.stem] = trace.top_kernels(None, lambda name, fam=fam: in_family(name, fam))
    return out


def read_profile(prof) -> Trace:
    """The profiler's events → a :class:`Trace` whose window runs from the first
    ``request`` span's start to the last one's end."""
    from torch.autograd import DeviceType

    tr = Trace()
    for ev in prof.events():
        start, end = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            tr.kernels.append((ev.name, start, end))
        elif ev.name.startswith(SPAN):
            tr.spans.append((ev.name[len(SPAN):], start, end))
    requests = [sp for sp in tr.spans if sp[0] == "request"]
    if not requests:
        raise RuntimeError("the profiler recorded no request span")
    if not tr.kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    tr.start, tr.end = min(sp[1] for sp in requests), max(sp[2] for sp in requests)
    return tr


def _spanned(name: str, fn):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(SPAN + name):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def spans(pipeline, handler_owner):
    """Record the benchmark's spans around the pipeline's phases and the server's
    generate handler while the context is open."""
    from unittest import mock

    import flux_fp8_api_tpu_torch.pipeline as pipeline_mod

    with contextlib.ExitStack() as stack:
        for name in ("preprocess_latent", "prepare", "vae_decode", "into_bytes"):
            stack.enter_context(mock.patch.object(pipeline, name, _spanned(name, getattr(pipeline, name))))
        stack.enter_context(mock.patch.object(pipeline_mod, "denoise", _spanned("denoise", pipeline_mod.denoise)))
        stack.enter_context(mock.patch.object(handler_owner, "handle_generate",
                                              _spanned("handler", handler_owner.handle_generate)))
        yield


def request_span():
    from torch.profiler import record_function

    return record_function(SPAN + "request")
