"""One run of one benchmark cell:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's configuration as it ships (weights drawn on the card from the
seed, calibration, the compiled bucket of the cell's traffic warmed), serves it over
HTTP in this process, drives the closed loop for ``--seconds``, checks a sample of
the answers against the plain reference, and prints one JSON line last on stdout.
``--trace 1`` also profiles a few requests after the window and reports the
per-layer metrics instead of the end-to-end ones. Build and compile caches live under
``build/portbench/`` of the checkout.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the run's start, before anything heavy is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "flux_fp8_api_tpu")
WARM_INDEX = 2**31  # the request index of set-up's one HTTP call, outside any window


def point_caches() -> None:
    """Every build and kernel cache into fixed directories of the checkout, before
    torch is imported; nothing under /tmp or the home directory."""
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "compile/inductor"), ("TRITON_CACHE_DIR", "compile/triton"),
                     ("TRITON_HOME", "triton_home"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"  # transformers, where anything imports it, loads no JAX


def load_family(name: str):
    """The module ``families/<name>.py`` (what it provides: ``families/__init__.py``)."""
    if not (name.isidentifier() and (HERE / "families" / f"{name}.py").is_file()):
        raise SystemExit(f"no family {name!r}: portbench/families/{name}.py is missing")
    return importlib.import_module(f"portbench.families.{name}")


def load_cell(name: str) -> Dict:
    """The cell ``name`` of BENCHMARK.json with its configuration file, its family and
    its mix."""
    from .generator import load_mix

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    spec = json.loads((ROOT / conf["file"]).read_text())
    metrics = [m for m in bench["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    from .check import limits

    return {"cell": cell, "spec": spec, "family": load_family(spec["family"]), "mix": load_mix(cell["traffic"]),
            "limits": limits(name), "per_layer": metrics,
            "end_to_end": [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class RunData:
    """What the per-layer readers (``metrics/<name>.py``) read: the window's answered
    requests, the traced requests and their trace, the cell's family, spec and mix."""

    family: object
    spec: Dict
    mix: Dict
    records: List = field(default_factory=list)
    profiled: List = field(default_factory=list)
    trace: Optional[object] = None

    @staticmethod
    def timed(records: List) -> List:
        """The answered requests whose denoise loop the pipeline timed."""
        return [r for r in records if r.ok and "denoise_seconds" in r.kept.get("timings", {})]

    @staticmethod
    def evaluations(record) -> int:
        """The flow evaluations of one timed request: the step cache's count where it
        ran, else the schedule's steps (its rate times its seconds)."""
        t = record.kept["timings"]
        return t.get("cache_model_evals", round(t["denoise_it_per_s"] * t["denoise_seconds"]))


class Phases:
    """Set-up split into phases: the seconds from the end of the last phase (the
    run's start, for the first) to each ``mark``, the device synchronised first."""

    def __init__(self, device: str):
        self.device, self.last, self.seconds = device, T0, {}

    def mark(self, name: str) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


def read_metric(name: str, run: RunData) -> Optional[float]:
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(run)


def p95(xs: List[float]) -> float:
    """The 95th percentile, linear between order statistics (``statistics``'
    inclusive method)."""
    return xs[0] if len(xs) == 1 else statistics.quantiles(xs, n=20, method="inclusive")[18]


def run_cell(cell: Dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             serve: Optional[Callable] = None, overrides: Optional[Dict] = None) -> Dict:
    """Set up, drive, trace and check one cell; → the result line's object."""
    import torch

    from . import check, generator, system
    from . import trace as tracing

    spec, mix, family = cell["spec"], cell["mix"], cell["family"]
    bodies = [generator.request(seed, i, mix) for i in range(len(generator.shapes(mix)))]  # every shape
    for body in bodies:
        family.check_body(body)  # before set-up: a body the reference cannot judge never runs
    steps = max(family.steps(spec, body) for body in bodies)
    overrides = {"warmup_resolutions": generator.resolutions(mix), "warmup_steps": steps,
                 "compilation_cache_dir": str(CACHE / "compile"), **(overrides or {})}
    phases = Phases(device)
    phases.mark("import")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pipeline = family.build(spec, family.weights(spec, seed, device), overrides, phases.mark)
    served = (serve or system.serve)(pipeline)
    phases.mark("serve")
    try:
        # the HTTP path's first calls, at the mix's own resolutions (one step each)
        generator.warm(served.port, seed, mix, first=WARM_INDEX)
        phases.mark("http_warm")
        t_window = phases.last

        def keep(rec):
            rec.kept = {"check": family.keep(pipeline, rec.body), "timings": dict(served.counters.last_timings),
                        "server_seconds": served.counters.metrics["last_seconds"]}

        records = generator.drive(served.port, seed, mix, seconds=seconds, after=keep)
        window = records[-1].done - records[0].sent
        data = RunData(family, spec, mix, records)
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            # the server's threads too: the spans around the pipeline's phases open there
            every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            with tracing.spans(pipeline, served.counters), \
                    profile(activities=acts, experimental_config=every_thread) as prof:
                data.profiled = generator.drive(served.port, seed, mix, count=mix["profiled_requests"],
                                                first=len(records), after=keep, span=tracing.request_span)
            data.trace = tracing.read_profile(prof)
            del prof
            # the one file a traced run writes: the kernels that took most time, and
            # every kernel each family of ``kernels/`` takes
            CACHE.mkdir(parents=True, exist_ok=True)
            (CACHE / "trace_summary.json").write_text(json.dumps(
                {"top_kernels": data.trace.top_kernels(), "families": tracing.family_kernels(data.trace)}, indent=1))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    finally:
        served.stop()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package were loaded: {found}")
    failed = sum(not r.ok for r in records + data.profiled)
    checked = check.sample(records, seed, mix["checked_requests"])
    for r in records + data.profiled:  # what the check does not read is freed with the program
        if all(r is not c for c in checked):
            r.kept.pop("check", None)
    del pipeline
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    numbers = family.judge(spec, seed, checked, device)
    limits = cell["limits"]
    ok = [r for r in records if r.ok]
    result = {
        "correct": check.verdict(numbers, limits) and failed == 0,
        "attempted": len(records) + len(data.profiled),
        "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if not trace:
        e2e = {"images_per_s": (len(ok) / window, "images/s"),
               "first_byte_p95_s": (p95([r.first_byte - r.sent for r in ok]), "s"),
               "setup_s": (t_window - T0, "s")}
        for m in cell["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]][0], "unit": e2e[m["name"]][1]}
    else:
        for m in cell["per_layer"]:
            v = read_metric(m["name"], data)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        tr = data.trace
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [[k, v] for k, v in tr.by_kind()[:10]],
                               "idle_gaps": [[k, v] for k, v in tr.idle_gaps()[:10]]}
    result["window"] = {"seconds": window, "requests": len(records),
                        "jpeg_bytes": sum(len(r.payload) for r in ok) / max(len(ok), 1)}
    result["setup_phases"] = phases.seconds
    result["check"] = check.compared(numbers, limits)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    point_caches()
    cell = load_cell(args.workload)
    import torch

    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in result["setup_phases"].items()), file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
