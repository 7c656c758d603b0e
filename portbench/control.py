"""The control of a cell's check: the reference one grid lower put in the program's
place and judged as a run judges the program (``check.control``), on the cell's own
requests at its own sizes.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

Prints one JSON line per seed with the numbers and the limits. ``correct`` must come
out false on every seed; the smallest reading of each number is its upper reading.
Runs on the card only, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    from .run import load_cell, point_caches

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    point_caches()
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    from . import check, generator

    mix = cell["mix"]
    for seed in args.seeds:
        bodies = [generator.request(seed, i, mix) for i in range(mix["checked_requests"])]
        numbers = check.control(cell["spec"], seed, bodies, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": check.verdict(numbers, cell["limits"]),
                          "numbers": numbers, "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
