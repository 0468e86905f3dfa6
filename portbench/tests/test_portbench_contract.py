"""BENCHMARK.json against the benchmark's contract, the cells' files found
by name, a cell, a configuration and a metric added as new files only,
and the no-JAX guard."""

from __future__ import annotations

import json
import re
import shutil
import sys

import pytest

from portbench.harness import cells, guard

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_entries(bench):
    seen = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200
        assert c["source"].startswith("https://")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = cells.resolve(w["name"], bench)
        got = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w["name"] in moved["workloads"]


def test_each_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.resolve(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.limits["numbers"]
        driver = cells.load_driver(cell.traffic["driver"])
        assert callable(driver.run) and callable(driver.control)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cells.load_reader(m["name"]).read)


def test_a_cell_config_and_metric_come_as_new_files(tmp_path, bench):
    """A later cell, configuration and metric: new files and new entries
    in a copy of the tree, no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "portbench")
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    (root / "portbench/configs/pem_small_test.json").write_text(json.dumps(
        dict(json.loads((root / "portbench/configs/pem_base.json")
                        .read_text()), name="pem_small_test")))
    (root / "portbench/traffic/pair.json").write_text(json.dumps(
        dict(json.loads((root / "portbench/traffic/bin.json").read_text()),
             instances=[2])))
    (root / "portbench/limits/pem_small_test.pair.json").write_text(
        (root / "portbench/limits/pem_base.bin.json").read_text())
    (root / "portbench/metrics/frames_served.py").write_text(
        "def read(rec):\n    return len(rec.frames) or None\n")
    new = dict(bench)
    new["configs"] = bench["configs"] + [dict(
        bench["configs"][0], name="pem_small_test",
        file="portbench/configs/pem_small_test.json")]
    new["workloads"] = bench["workloads"] + [{
        "name": "pem_small_test.pair", "config": "pem_small_test",
        "traffic": "pair", "chips": 1, "why": "two instances a frame"}]
    new["per_layer"] = bench["per_layer"] + [{
        "name": "frames_served", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "pipeline/pem_runner",
        "moves": "frame_p50_ms", "workloads": ["pem_small_test.pair"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = cells.resolve("pem_small_test.pair", root=root)
    assert cell.traffic["instances"] == [2]
    assert [m["name"] for m in cell.per_layer][-1] == "frames_served"
    reader = cells.load_reader("frames_served", root=root)
    from portbench.harness.record import Record
    rec = Record(cell=cell.name, seed=1, trace=True)
    rec.frames = [{"ms": 1.0, "ok": True}] * 3
    assert reader.read(rec) == 3
    assert cells.load_driver(cell.traffic["driver"], root=root).run
    for p, data in before.items():
        assert p.read_bytes() == data


def test_no_jax_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded(["sam6d_tpu_torch",
                                   "sam6d_tpu_torch.ops.fps", "jaxtyping",
                                   "flaxen", "torch"]) == []
    assert guard.forbidden_loaded(["sam6d_tpu.config", "jax", "jaxlib.xla",
                                   "flax.linen", "numpy"]) == [
        "flax.linen", "jax", "jaxlib.xla", "sam6d_tpu.config"]


def test_the_reference_and_harness_import_nothing_of_the_port():
    import ast

    for path in cells.HERE.rglob("*.py"):
        rel = path.relative_to(cells.HERE).parts
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".")[0]
                assert top not in guard.FORBIDDEN, (path, m)
                if rel[0] in ("reference", "harness", "metrics"):
                    assert top != "sam6d_tpu_torch", (path, m)


def test_a_run_without_a_card_exits_2_and_prints_nothing(monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "pem_base.bin", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
    assert "sam6d_tpu" not in {m.split(".")[0] for m in sys.modules}
