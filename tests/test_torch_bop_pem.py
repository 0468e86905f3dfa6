"""The port's PEM sweep over a BOP dataset against the JAX package's.

`run_bop_eval` on a two-object tree of tests/helpers/bop_tree.py (96 x
128, two frames), its templates rendered at 64 px, detections from its
visible masks ordered so that the banks go A, B, A (frame 1's B dropped);
the tiny PEM config of test_torch_pem.py with 300 points a view, the JAX
weights carried across and the JAX key's hypothesis uniforms injected for
each bucket.  The port's sweep runs first and writes each object's
feature cache, which the JAX sweep then reads, so JAX runs only the
banks and the requests op by op (`jax.disable_jit`, for the reason
test_torch_pem.py gives).

Both packages' coarse solves are recorded.  As in test_torch_matching.py,
the test holds what float32 determines: the sampled triplets equal, the
poses of the triplets of three distinct points within 1e-4; and where
both solves' winners are such triplets, the same winner and the final
pose within `close_poses`' tolerances (R and t / radius 2e-3, scores
1e-6).  A winner drawn with a repeated point (two distinct points, the
reference's sampling with replacement, ROADMAP.md section 3) has a
rotation about their axis that is float noise, so which hypothesis wins
there is not determined; those rows are held to their ids, finite
rotations and the other checks only.  The csv equals the JAX one but for
the `time` column (numbers to the same tolerances); the merged json's
keys are equal.
"""

import dataclasses
import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import sam6d_tpu.config as jc
import sam6d_tpu.models.pem.matching as j_match
import sam6d_tpu_torch.config as tc
import sam6d_tpu_torch.models.pem.matching as t_match
import tests.test_torch_matching as hyp
from sam6d_tpu.models.pem.model import PEM as JPEM
from sam6d_tpu.pipeline import bop_eval as j_eval
from sam6d_tpu.pipeline.pem_runner import PEMRunner as JRunner
from sam6d_tpu_torch.params import flax_to_state_dict
from sam6d_tpu_torch.pipeline import bop_eval as t_eval
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner as TRunner
from sam6d_tpu_torch.pipeline.renderer import render_bop_templates
from tests.test_torch_pem import (
    close_poses,
    coarse_uniforms,
    make_inputs,
    random_variables,
    tiny_config,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import bop_tree  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pem_tree(tmp_path_factory):
    """Two frames of both objects (A = 1, B = 5); frame 1's B detection
    is dropped, so the sweep onboards A, B and restores A."""
    base = tmp_path_factory.mktemp("pem_bop")
    root = base / "lmo"
    bop_tree.write_bop_tree(root, height=96, width=128, n_test=2, n_pbr=0)
    templates = base / "templates"
    render_bop_templates(str(root / "models"), str(templates), 64)
    dets = [d for d in bop_tree.gt_detections(root)
            if not (d["image_id"] == 1 and d["category_id"] == 5)]
    det_path = str(base / "detection_ism.json")
    bop_tree.save_json(det_path, dets)
    return dict(root=str(root), templates=str(templates), det_path=det_path,
                base=base)


def pem_runners():
    jcfg, tcfg = (dataclasses.replace(tiny_config(c),
                                      n_sample_template_point=300)
                  for c in (jc, tc))
    N, S = jcfg.fine_npoint, jcfg.feature_extraction.img_size
    inst, tem_pts, tem_feat = make_inputs(
        np.random.RandomState(0), 1, N, jcfg.n_sample_model_point, S,
        jcfg.feature_extraction.out_dim)
    example = {k: v for k, v in inst.items() if k != "score"}
    example.update(dense_po=tem_pts, dense_fo=tem_feat)
    variables = random_variables(JPEM(jcfg), example)
    jrun = JRunner(jcfg, variables=variables)
    trun = TRunner(tcfg, state_dict=flax_to_state_dict(variables),
                   device="cpu")
    return jcfg, tcfg, jrun, trun


def recording(monkeypatch, module, jax_side: bool):
    """Record every compute_coarse_Rt call of `module`: its key (JAX),
    attention, points and the pose it returns, as numpy."""
    calls, solve = [], module.compute_coarse_Rt

    def record(*args, **kwargs):
        R, t = solve(*args, **kwargs)
        key, rest = (args[0], args[1:4]) if jax_side else (None, args[:3])
        calls.append(dict(key=key, inputs=[np.asarray(x) for x in rest],
                          R=np.asarray(R), t=np.asarray(t)))
        return R, t

    monkeypatch.setattr(module, "compute_coarse_Rt", record)
    return calls


def winners_if_determined(jcall, tcall, u, n1, monkeypatch):
    """The two solves' hypotheses: equal triplets, and the full ones'
    poses within 1e-4; returns the winner's index where both winners are
    full triplets (and asserts they are the same), else None."""
    monkeypatch.setattr(hyp, "B", 1)
    i1, i2, _, Rs, ts = hyp._hypotheses_jax(
        jcall["key"], *(jax.numpy.asarray(x) for x in jcall["inputs"]), n1)
    i1t, i2t, _, Rst, tst = hyp._hypotheses_torch(
        *(torch.from_numpy(x) for x in tcall["inputs"]), n1,
        tuple(torch.from_numpy(x) for x in u))
    np.testing.assert_array_equal(i1t, i1)
    np.testing.assert_array_equal(i2t, i2)
    full = (hyp._distinct(i1) == 3) & (hyp._distinct(i2) == 3)
    np.testing.assert_allclose(Rst[full], Rs[full], atol=1e-4)
    np.testing.assert_allclose(tst[full], ts[full], atol=1e-4)
    wj = hyp._winner(Rs, ts, jcall["R"], jcall["t"])[0]
    wt = hyp._winner(Rst, tst, tcall["R"], tcall["t"])[0]
    assert wj and wt
    if not (full[0, wj].all() and full[0, wt].all()):
        return None
    assert set(wj) == set(wt)
    return wj[0]


def test_pem_sweep_matches_jax(pem_tree, monkeypatch):
    jcfg, tcfg, jrun, trun = pem_runners()
    n1 = tcfg.coarse_point_matching.nproposal1
    u = coarse_uniforms(jax.random.PRNGKey(0), 1, n1)
    buckets = []

    def uniforms(bucket):
        buckets.append(bucket)
        return coarse_uniforms(jax.random.PRNGKey(0), bucket, n1)

    tcalls = recording(monkeypatch, t_match, jax_side=False)
    jcalls = recording(monkeypatch, j_match, jax_side=True)
    out_t, out_j = (str(pem_tree["base"] / n) for n in ("out_t", "out_j"))
    args = (pem_tree["root"], pem_tree["det_path"], pem_tree["templates"])
    got = t_eval.run_bop_eval(tcfg, *args, out_t, runner=trun,
                              uniforms=uniforms)
    with jax.disable_jit():
        want = j_eval.run_bop_eval(jcfg, *args, out_j, runner=jrun)
    assert buckets == [1, 1, 1] and len(tcalls) == len(jcalls) == 3
    assert [(r["im_id"], r["obj_id"]) for r in got] == \
        [(r["im_id"], r["obj_id"]) for r in want] == [(0, 1), (0, 5), (1, 1)]

    determined = []
    for g, w, tcall, jcall in zip(got, want, tcalls, jcalls):
        assert g.keys() == w.keys()
        assert {k: g[k] for k in ("scene_id", "im_id", "obj_id")} == \
            {k: w[k] for k in ("scene_id", "im_id", "obj_id")}
        R = np.array(g["R"]).reshape(3, 3)
        assert abs(np.linalg.det(R) - 1) < 1e-4 and np.isfinite(g["t"]).all()
        win = winners_if_determined(jcall, tcall, u, n1, monkeypatch)
        determined.append(win is not None)
        if win is None:
            continue
        pts = np.load(os.path.join(pem_tree["templates"],
                                   f"obj_{g['obj_id']:06d}",
                                   "feat_cache.npz"))["pts"]
        radius = np.linalg.norm(pts, axis=2).max(axis=1)

        def pose(r):
            return {"pred_R": np.array(r["R"]).reshape(1, 3, 3),
                    "pred_t": np.array(r["t"])[None] / 1000.0,
                    "score": np.array([r["score"]])}
        close_poses(pose(g), pose(w), radius, score_key="score")
    assert sum(determined) >= 2, determined

    # The csv: equal but for the time column; the merged json's keys.
    lines = [open(os.path.join(d, "result_bop.csv")).read().splitlines()
             for d in (out_t, out_j)]
    assert len(lines[0]) == len(lines[1]) == 4
    assert lines[0][0] == lines[1][0]
    for g, w, same in zip(lines[0][1:], lines[1][1:], determined):
        g, w = g.split(","), w.split(",")
        assert g[:3] == w[:3] and len(g) == len(w) == 7
        if same:  # score, R, t (mm): the tolerances above, and rounding
            for i, atol in ((3, 2e-6), (4, 2e-3 + 1e-6), (5, 0.2)):
                np.testing.assert_allclose(np.array(g[i].split(), float),
                                           np.array(w[i].split(), float),
                                           atol=atol)
    merged = [json.load(open(os.path.join(d, "detection_pem_bop.json")))
              for d in (out_t, out_j)]
    assert [r.keys() for r in merged[0]] == [r.keys() for r in merged[1]]
    assert merged[0] == got
    # `time` runs from the frame's start: a frame's second object's row
    # includes the first's work.
    assert got[1]["time"] >= got[0]["time"] > 0.0

    # After A, B, A the runner holds A's bank and knows it: onboarding B
    # again must build B's bank, not keep A's.
    a_dir, b_dir = (os.path.join(pem_tree["templates"], f"obj_{i:06d}")
                    for i in (1, 5))
    assert trun._onboarded_dir == a_dir
    bank_a = trun.template_bank
    trun.onboard(b_dir, cache_path=os.path.join(b_dir, "feat_cache.npz"))
    assert trun.template_bank is not bank_a
    assert trun._onboarded_dir == b_dir


def test_pem_sweep_refuses_more_ranks(pem_tree, monkeypatch, tmp_path):
    """More than one rank used to raise here (no barrier before the
    merge).  Now, in a world of 2, each rank writes its shard and meets
    the barrier (`sync_hosts`), and only rank 0 merges: rank 1 returns
    None and writes no merged file; rank 0 merges both shards in rank
    order.  The real two-process run is in tests/test_torch_parallel.py."""
    import torch.distributed as dist

    barriers = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(t_eval, "sync_hosts", barriers.append)
    assert t_eval.process_rank() == (1, 2)
    assert t_eval.write_shard_and_merge(str(tmp_path), [{"a": 1}], "x",
                                        "x.json") is None
    assert barriers == ["x-merge"]
    assert sorted(os.listdir(tmp_path)) == ["x_0001.json"]
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    merged = t_eval.write_shard_and_merge(str(tmp_path), [{"b": 2}], "x",
                                          "x.json")
    assert merged == [{"b": 2}, {"a": 1}]
    assert json.load(open(tmp_path / "x.json")) == merged
    assert barriers == ["x-merge", "x-merge"]


def test_shard_frames_matches():
    frames = list(range(10))
    for i in range(3):
        assert t_eval.shard_frames(frames, i, 3) == \
            j_eval.shard_frames(frames, i, 3)
