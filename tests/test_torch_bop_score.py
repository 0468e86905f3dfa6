"""The port's BOP19 scorer against the JAX package's.

Every case of `tests/test_bop_score.py` (TestErrors, TestDatasetAR,
TestProtocolExact) runs with its module's `bop_score` replaced by a
stand-in that calls each function in both packages on the same
arguments, asserts their results equal, and hands the test the port's:
so each case holds on the port, and every error, recall and AR the case
computes is equal between the packages.  Then: both packages on a
two-object tree (`tests/helpers/bop_tree.py`: a cube listing discrete
symmetries, a vase a continuous one) with VSD, on the GT poses (AR 1)
and on deliberately perturbed rows; the csv writer and reader; and the
CLI's JSON, the port's through `python -m` in a process of its own.
Tolerance: none, all numpy float64 on the host.  Rasterizer compared:
the numpy one on both sides (`sam6d_tpu.utils.native.rasterize` and
`sam6d_tpu_torch.utils.native.rasterize` return None here, so neither
renderer takes the C++ one, whose boundary pixels differ).
"""

import inspect
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import sam6d_tpu.utils.native
import sam6d_tpu_torch.utils.native
import tests.test_bop_score as jax_cases
from sam6d_tpu.pipeline import bop_eval as j_eval
from sam6d_tpu.pipeline import bop_score as j_score
from sam6d_tpu_torch.pipeline import bop_eval as t_eval
from sam6d_tpu_torch.pipeline import bop_score as t_score
from tests.test_bop_score import bop_dir  # noqa: F401  (the fixture)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import bop_tree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def numpy_rasterizer(monkeypatch):
    monkeypatch.setattr(sam6d_tpu.utils.native, "rasterize",
                        lambda *a, **k: None)
    monkeypatch.setattr(sam6d_tpu_torch.utils.native, "rasterize",
                        lambda *a, **k: None)


def assert_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


class BothPackages:
    """`bop_score` as the JAX cases call it: each function runs in both
    packages; the results must be equal; the port's is returned."""

    calls = 0

    def __getattr__(self, name):
        j, t = getattr(j_score, name), getattr(t_score, name)
        if not callable(j):
            assert_equal(t, j)
            return t

        def both(*args, **kwargs):
            want, got = j(*args, **kwargs), t(*args, **kwargs)
            assert_equal(got, want)
            BothPackages.calls += 1
            return got
        return both


CASES = [(cls, name) for cls in (jax_cases.TestErrors,
                                 jax_cases.TestDatasetAR,
                                 jax_cases.TestProtocolExact)
         for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("cls,name", CASES,
                         ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_jax_case_on_the_port(cls, name, request, monkeypatch):
    monkeypatch.setattr(jax_cases, "bop_score", BothPackages())
    method = getattr(cls(), name)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(method).parameters}
    before = BothPackages.calls
    method(**kwargs)
    assert BothPackages.calls > before


def test_case_list_is_complete():
    assert len(CASES) == 12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop_tree") / "lmo"
    bop_tree.write_bop_tree(root, height=120, width=160, n_test=2, n_pbr=0)
    return str(root)


def perturbed_rows(root):
    """The GT rows, altered: a spin about each object's symmetry axis
    (forgiven), a 20 mm shift, a 12-degree tilt, a duplicate of lower
    confidence, and one frame's estimate of an object dropped."""
    rows = bop_tree.gt_pose_rows(root)
    info = json.load(open(os.path.join(root, "models", "models_info.json")))
    out = []
    for n, r in enumerate(rows):
        R = np.array(r["R"], np.float64).reshape(3, 3)
        t = np.array(r["t"], np.float64)
        if n == 0:
            continue
        if n == 1:  # spin about the object's z axis
            R = R @ jax_cases._rot([0, 0, 1], 90.0)
        elif n == 2:
            t = t + [20.0, 0.0, 0.0]
        else:
            R = R @ jax_cases._rot([1, 0.2, 0], 12.0)
        out.append(dict(r, R=R.flatten().tolist(), t=t.tolist(),
                        score=0.9 - 0.1 * n))
        if n == 2:
            out.append(dict(r, score=0.1))  # exact, lower confidence
    assert {str(r["obj_id"]) for r in rows} <= set(info)
    return out


@pytest.mark.parametrize("rows_of", ["gt", "perturbed"])
def test_two_object_tree_scores_equal(tree, rows_of):
    rows = (bop_tree.gt_pose_rows(tree) if rows_of == "gt"
            else perturbed_rows(tree))
    for kw in ({}, {"use_vsd": False}, {"model_sample": 50},
               {"image_width": 640}):
        got = t_score.score_dataset(rows, tree, **kw)
        assert got == j_score.score_dataset(rows, tree, **kw)
        if rows_of == "gt":
            assert got["ar"] == 1.0 and got["n_gt"] == 4
        else:
            assert 0.0 < got["ar"] < 1.0
    if rows_of == "gt":
        assert set(got) == {"ar", "ar_mssd", "ar_mspd", "ar_vsd", "n_gt"}


def test_symmetries_of_the_tree_match(tree):
    info = json.load(open(os.path.join(tree, "models", "models_info.json")))
    for meta in info.values():
        for n in (None, 16):
            got = t_score.symmetry_transforms(meta, n)
            np.testing.assert_array_equal(
                got, j_score.symmetry_transforms(meta, n))
        assert len(got) == 16 if "symmetries_continuous" in meta else 4


def test_csv_writer_and_reader_match(tree, tmp_path):
    rows = perturbed_rows(tree)
    t_eval.write_bop_csv(rows, str(tmp_path / "t.csv"))
    j_eval.write_bop_csv(rows, str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    got = t_score.read_bop_csv(str(tmp_path / "t.csv"))
    assert got == j_score.read_bop_csv(str(tmp_path / "t.csv"))
    assert len(got) == len(rows)


def test_cli_json_matches(tree, tmp_path, capsys):
    path = str(tmp_path / "result_bop.csv")
    t_eval.write_bop_csv(perturbed_rows(tree), path)
    for extra in ([], ["--no_vsd"]):
        args = ["--csv", path, "--dataset_dir", tree, "--split", "test",
                *extra]
        j_score.main(args)
        want = json.loads(capsys.readouterr().out)
        proc = subprocess.run(
            [sys.executable, "-m", "sam6d_tpu_torch.pipeline.bop_score",
             *args], cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1]) == want
        assert ("ar_vsd" in want) == (not extra)
