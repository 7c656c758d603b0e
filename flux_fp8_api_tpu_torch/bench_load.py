"""Checkpoint read time on the card's host: the reload of a full-size prequantized
flux-dev flow (chip_smoke phase 10(a)) by each checkout given, from a warm and from a
cold page cache.

    python -m flux_fp8_api_tpu_torch.bench_load [--tree DIR ...] [--out DIR]

The flow of ``configs/config-dev.json`` (random weights from its seed, fp8, calibrated
by ``compile()``'s trials, no warm-up) is saved prequantized; then
``load_models_from_config`` of a copy of ``configs/config-dev-prequant.json`` pointing
at the file is timed in a fresh process of each ``--tree`` (a checkout of this repo,
default this one; another commit's ``git archive`` to compare), in the order A, B, B,
A, first with the file in the page cache, then with its pages dropped before each run
(:func:`evict_from_page_cache`). One JSON line per run: the tree, the cache state,
``read_s`` (the host clock around the call, ending in a device sync, as phase 10(a)
reads it), the file system under ``--out`` and the bytes the page cache gave up first
(none on a tmpfs: there every read is warm); then the summary line with the card. Needs one CUDA card and about 13 GB of disk under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the timed call, run in a fresh process of each tree
_READ = """
import json, sys, time
import torch
from flux_fp8_api_tpu_torch.utils.config import load_config_from_path
from flux_fp8_api_tpu_torch.utils.loader import load_models_from_config
config = load_config_from_path(sys.argv[1])
t = time.perf_counter()
models = load_models_from_config(config)
torch.cuda.synchronize()
print(json.dumps({"read_s": time.perf_counter() - t, "prequantized": models.flow_prequantized}))
"""


def evict_from_page_cache(path) -> int:
    """Write the file's dirty pages back, then drop its pages that no map holds from
    the page cache (``posix_fadvise`` DONTNEED, no privilege needed); returns the bytes
    by which the kernel's page cache shrank meanwhile (0 where the file cannot leave
    it: tmpfs)."""

    def cached() -> int:
        for line in Path("/proc/meminfo").read_text().splitlines():
            if line.startswith("Cached:"):
                return int(line.split()[1]) * 1024
        return 0

    before = cached()
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return max(before - cached(), 0)


def write_prequantized(out: Path) -> Path:
    """configs/config-dev.json's flow, calibrated, saved prequantized under ``out``;
    returns the config that reloads it."""
    import torch

    from .pipeline import FluxPipeline

    pipe = FluxPipeline.load_pipeline_from_config_path(
        str(ROOT / "configs" / "config-dev.json"), compile_blocks=False, compile_extras=False)
    pipe.compile()  # the calibration trials alone: no compile flag asks for a warm-up
    path = out / "flux-dev-prequant.safetensors"
    pipe.save_prequantized(str(path))
    del pipe
    torch.cuda.empty_cache()
    spec = json.loads((ROOT / "configs" / "config-dev-prequant.json").read_text())
    spec["ckpt_path"] = str(path)
    config = out / "config-dev-prequant.json"  # the reload phase 10(a) times
    config.write_text(json.dumps(spec))
    return config


def file_system(path) -> str:
    """The type of the file system holding ``path`` (/proc/mounts, longest mount point
    that contains it): a tmpfs keeps a file's pages in memory, so it has no cold read."""
    path, best = str(Path(path).resolve()), ("", "unknown")
    for line in Path("/proc/mounts").read_text().splitlines():
        _, point, kind = line.split()[:3]
        if (path == point or path.startswith(point.rstrip("/") + "/")) and len(point) > len(best[0]):
            best = (point, kind)
    return best[1]


def time_read(tree: Path, config: Path) -> dict:
    """``load_models_from_config`` of ``config`` in a fresh process of ``tree``."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    done = subprocess.run([sys.executable, "-c", _READ, str(config)], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"{tree}: the reload failed\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", type=Path, help="a checkout to time (repeatable)")
    ap.add_argument("--out", type=Path, default=None, help="where the file goes (default: a temporary directory)")
    args = ap.parse_args(argv)
    import torch

    from .ablate_attention import card_line

    if not torch.cuda.is_available():
        raise SystemExit("bench_load times a reload onto a CUDA card and needs one")
    trees = [t.resolve() for t in args.tree or [ROOT]]
    order = trees + trees[::-1] if len(trees) > 1 else trees * 2
    out = Path(tempfile.mkdtemp(prefix="bench_load_", dir=args.out))
    rows = []
    try:
        config = write_prequantized(out)
        path = json.loads(config.read_text())["ckpt_path"]
        size, fs = Path(path).stat().st_size, file_system(path)
        for cache in ("warm", "cold"):
            for tree in order:
                dropped = evict_from_page_cache(path) if cache == "cold" else 0
                row = {"tree": tree.name, "cache": cache, "bytes": size, "file_system": fs,
                       "dropped_bytes": dropped, **time_read(tree, config)}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    summary = {"metric": "prequant reload read_s", "card": card_line(),
               "read_s": {f"{t.name} {c}": [r["read_s"] for r in rows if r["tree"] == t.name and r["cache"] == c]
                          for t in trees for c in ("warm", "cold")}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
