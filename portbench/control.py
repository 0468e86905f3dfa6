"""The control of a cell: the plain reference in a lower precision put in
the program's place, judged as a run judges the program.  Its numbers
set the upper reading of each limit (PERF.md); `correct` has to come out
false for it.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

on the card (`--device cpu` runs it at the cell's sizes on the CPU,
slowly).  Prints one JSON line a seed, then the least of each number
over the seeds beside its limit.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import cells  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default=None,
                   help="a fault in the program's place instead of the "
                        "control, where the cell's driver has it (half)")
    args = p.parse_args(argv)
    cell = cells.resolve(args.workload)
    driver = cells.load_driver(cell.traffic["driver"])
    least = {}
    for seed in args.seeds:
        kw = {"fault": args.fault} if args.fault else {}
        numbers = driver.control(cell, seed, args.device, **kw)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": numbers}), flush=True)
        for k, v in numbers.items():
            least[k] = min(v, least.get(k, v))
    limits = cell.limits["numbers"]
    fails = [k for k, lim in limits.items() if least.get(k, 0) > lim]
    print(json.dumps({"workload": cell.name, "least": least,
                      "limits": limits, "fails_every_seed": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
