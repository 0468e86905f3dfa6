"""A cell's files, found by the names in BENCHMARK.json.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one metric lives in a file of its own:

* configs/<config>.json   the sizes as run (the `file` of the config entry)
* traffic/<traffic>.json  the mix's parameters; its "driver" names
                          drivers/<driver>.py, which runs the cell
* limits/<cell>.json      the limits of the numbers that decide `correct`
* metrics/<metric>.py     a reader: read(rec) -> number or None

so that a later cell, configuration or metric is new files and new
entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, bench: dict | None = None, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = root / "portbench" / "limits" / f"{name}.json"
    with open(limits_path) as f:
        limits = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=config, traffic_name=w["traffic"], traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _load(path: Path, prefix: str):
    if not path.exists():
        raise FileNotFoundError(path)
    mod_name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str, root: Path = ROOT):
    """drivers/<name>.py, which defines run(cell, seed, seconds, trace, t0)."""
    return _load(root / "portbench" / "drivers" / f"{name}.py",
                 "portbench_driver_")


def load_reader(metric: str, root: Path = ROOT):
    """metrics/<metric>.py, which defines read(rec) -> number or None."""
    return _load(root / "portbench" / "metrics" / f"{metric}.py",
                 "portbench_metric_")
