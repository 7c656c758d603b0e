"""The controls of a cell's check: the family's controls put in the program's place
and judged as a run judges the program, on the cell's own requests at its own sizes.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...] [--control <name>]

``--control`` names one of the family's ``CONTROLS``; the default, the first, is the
reference one grid lower, from which the limits' upper readings come. Prints one JSON
line per seed with the numbers and the limits. ``correct`` must come out false on
every seed. Runs on the card only, as the benchmark does.
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
    ap.add_argument("--control")
    args = ap.parse_args(argv)
    point_caches()
    cell = load_cell(args.workload)
    family = cell["family"]
    name = args.control or family.CONTROLS[0]
    if name not in family.CONTROLS:
        ap.error(f"--control must be one of {family.CONTROLS}")
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    from . import check, generator

    mix = cell["mix"]
    for seed in args.seeds:
        bodies = [generator.request(seed, i, mix) for i in range(mix["checked_requests"])]
        numbers = family.control(cell["spec"], seed, bodies, "cuda", name)
        print(json.dumps({"workload": args.workload, "control": name, "seed": seed,
                          "correct": check.verdict(numbers, cell["limits"]), "numbers": numbers,
                          "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
