"""Run one cell of the benchmark of sam6d_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell's files are found by the names in BENCHMARK.json
(`harness/cells.py`); its traffic file names the driver that runs it.
The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 a breakdown, and last the
numbers that decided `correct`, each beside its limit.  Those numbers are
also the last lines of standard error.  Exit codes: 2 without the cards,
3 if a JAX module is loaded, 1 on any other error (no result printed).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Caches of the program and its libraries stay inside the checkout, at
# fixed paths (the port's kernels build into build/torch_kernels/).
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

from portbench.harness import cells, guard  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result(cell, rec, trace: bool) -> dict:
    import torch

    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = cells.load_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": rec.correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": device}
    if trace and rec.profile is not None:
        device["busy_s"] = rec.profile.busy_s
        device["window_s"] = rec.profile.window_s
        out["breakdown"] = rec.profile.breakdown()
    out["numbers"] = rec.numbers
    out["check"] = {k: {"value": rec.numbers.get(k), "limit": lim}
                    for k, lim in rec.limits.items()}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = cells.resolve(args.workload)
    guard.require_cards(cell.chips)
    driver = cells.load_driver(cell.traffic["driver"])
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace), T0)
    out = result(cell, rec, bool(args.trace))
    guard.check_no_jax("at exit")
    print(f"portbench: {cell.name} seed {args.seed} on {card_limit()}: "
          f"setup {rec.setup_s:.3f} s, window {rec.window_s:.3f} s, "
          f"{1e3 * rec.window_s / max(1, rec.attempted):.2f} ms a frame or "
          f"step, {rec.attempted} attempted, {rec.failed} failed, check "
          f"{rec.check_s:.1f} s over {rec.judged} answers", file=sys.stderr)
    for f in rec.failures[:5] + rec.check_errors:
        print(f"portbench: {f}", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
