"""The port's multi-rank paths on the CPU, in gloo process groups.

Each multi-rank case runs `tests/helpers/torch_parallel_worker.py` in
2 or 4 processes (a free local port, every process with its own 120 s
timeout, so a hang fails the test and never stalls the run); one launch
serves several cases, whose results the tests read.

* `init_distributed`'s layout: explicit arguments, then torchrun's
  variables, then SLURM's (no processes needed).
* The hypothesis-parallel coarse solve at hyp = 2 and 4, and at dp 2 x
  hyp 2 (at hyp = 2 and dp 2 x hyp 2 with the bank's shared distance
  field, 2 rows a batch shard), against what the JAX
  `sharded_compute_coarse_Rt` computes: its shard_map (too slow for this
  lane run eagerly, and under jit XLA's re-association can move a
  float16 CDF step of the sampler, see test_torch_pem.py) is, for each
  batch shard, `compute_coarse_Rt(fold_in(key, d), ...,
  return_score=True)` on every axis index d and the argmax of the scores
  over d, lowest d on ties.  Rank d is fed the uniforms of
  `fold_in(key, d)`.  As in test_torch_matching.py a pose is held to
  1e-4 where the JAX winner is a triplet of three distinct points; a
  winner drawn with a repeated point fixes only its points' images,
  which are held to 1e-4.
* The BOP merge with a deliberately slow rank 1: rank 0's merge holds
  both shards.  The PEM sweep over 2 ranks: rank 0's merged rows equal
  the one-process sweep's (the same injected uniforms).
* One training step at dp = 2 and at tp = 2 against the port's
  one-process step on the whole batch (which test_torch_train.py holds
  to JAX, so the chain reaches JAX): parameters and BatchNorm statistics
  after the step, loss and gradient norm.  Tolerances, float32: the
  gradient norm and loss 1e-5 relative (sums split over ranks);
  BatchNorm statistics 1e-5; parameters 1e-6 absolute.  Adam's first
  step moves a weight by lr * g / (|g| + eps), whose slope in g peaks at
  lr / eps where |g| << eps: at the default eps 1e-6 that multiplies the
  float32 rounding of a split sum by 100 (one weight of the tiny model
  then moved 1.5e-6 apart at dp = 2), so the steps run with eps 1e-3,
  where the update follows the gradient at a slope of at most 0.1.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam6d_tpu.models.pem.matching as jm
import sam6d_tpu.ops.pointcloud as jpc
import sam6d_tpu.ops.procrustes as jpr
import sam6d_tpu.ops.sampling as jsm
import sam6d_tpu_torch.config as tc
from sam6d_tpu.ops.distance_field import build_min_dist_field
from sam6d_tpu_torch.parallel import distributed as pd
from sam6d_tpu_torch.parallel.hyp_parallel import local_budget
from tests.test_torch_matching import _inputs
from tests.test_torch_pem import tiny_config

HELPERS = Path(__file__).resolve().parent / "helpers"
WORKER = HELPERS / "torch_parallel_worker.py"
sys.path.insert(0, str(HELPERS))
import bop_tree  # noqa: E402

torch.set_num_threads(2)

N1, N2, N_REFINE = 128, 16, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out: Path, world: int, inputs: dict, timeout: float = 120.0):
    """Run every scenario of `inputs` in one `world`-rank gloo group;
    {scenario: [rank 0's result, rank 1's, ...]}."""
    return start_launch(out, world, inputs, timeout)()


def start_launch(out: Path, world: int, inputs: dict,
                 timeout: float = 120.0):
    """`launch`, started: returns the function that waits for the ranks
    (each for at most `timeout` s) and returns their results, so that the
    caller can compute its reference meanwhile."""
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), port, str(out),
         ",".join(inputs)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env) for r in range(world)]

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        results = {}
        for name in inputs:
            results[name] = []
            for r in range(world):
                with open(out / f"{name}_{r}.pkl", "rb") as f:
                    results[name].append(pickle.load(f))
        return results

    return wait


# -- init_distributed's layout ------------------------------------------------

LAYOUT_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAYOUT_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_distributed_env_reads_args_then_torchrun_then_slurm(clean_env):
    mp = clean_env
    assert pd.distributed_env() == (None, None, None, None)
    mp.setenv("SLURM_NTASKS", "8")
    mp.setenv("SLURM_PROCID", "5")
    mp.setenv("SLURM_LOCALID", "1")
    assert pd.distributed_env() == (None, 8, 5, 1)
    mp.setenv("MASTER_ADDR", "node0")
    mp.setenv("MASTER_PORT", "29500")
    mp.setenv("WORLD_SIZE", "4")
    mp.setenv("RANK", "3")
    mp.setenv("LOCAL_RANK", "3")
    assert pd.distributed_env() == ("node0:29500", 4, 3, 3)
    assert pd.distributed_env("host:1", 2, 1, 0) == ("host:1", 2, 1, 0)


def test_init_distributed_is_false_for_one_process(clean_env):
    assert not pd.init_distributed(device="cpu")
    assert not pd.init_distributed("127.0.0.1:1", 1, 0, device="cpu")
    clean_env.setenv("WORLD_SIZE", "1")
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")
    clean_env.setenv("MASTER_PORT", "1")
    assert not pd.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    pd.sync_hosts("no group")  # nothing to wait for
    assert pd.process_index() == 0 and pd.process_count() == 1


@pytest.mark.parametrize("layout,card,world,rank", [
    ({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1"}, 1, 8, 5),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0"},
     0, 4, 2),
    ({"WORLD_SIZE": "2", "RANK": "1"}, 1, 2, 1),  # no local rank: the rank
])
def test_init_distributed_on_cuda_starts_nccl_on_the_local_card(
        clean_env, layout, card, world, rank):
    """The card's branch, which one card cannot reach (one rank is no
    group): the local rank's card is set, then an NCCL group at the
    address from MASTER_ADDR / MASTER_PORT (the process group and the
    card are stubbed)."""
    calls = []
    mp = clean_env
    mp.setattr(torch.cuda, "set_device", lambda i: calls.append(("card", i)))
    mp.setattr(torch.distributed, "is_initialized", lambda: False)
    mp.setattr(torch.distributed, "init_process_group",
               lambda backend, **kw: calls.append((backend, kw)))
    mp.setenv("MASTER_ADDR", "node0")
    mp.setenv("MASTER_PORT", "29500")
    for k, v in layout.items():
        mp.setenv(k, v)
    assert pd.init_distributed()
    assert calls == [("card", card), ("nccl", dict(
        init_method="tcp://node0:29500", world_size=world, rank=rank))]


def test_make_mesh_checks_the_world_size(two_ranks):
    for res in two_ranks["results"]["mesh"]:
        assert res["error"] == "mesh shape (3,) != 2 ranks"
        assert res["names"] == ("dp", "tp") and res["shape"] == (1, 2)


# -- JAX's sharded coarse solve, as it computes it -----------------------------

def _local_uniforms(key, d, B, n1):
    k1, k2 = jax.random.split(jax.random.fold_in(key, d))
    return tuple(np.array(jax.random.uniform(k, (B, 3 * n1, 1)))
                 for k in (k1, k2))


def _hypotheses(key, atten, pts1, pts2, n1):
    """compute_coarse_Rt's sampled triplets (idx1, idx2), template
    triplets and Procrustes poses for one key (any batch size)."""
    B = atten.shape[0]
    ps = jax.nn.softmax(atten, axis=2) * jax.nn.softmax(atten, axis=1)
    w1 = (jnp.argmax(ps[:, 1:, :], axis=2) > 0).astype(ps.dtype)
    w2 = (jnp.argmax(ps[:, :, 1:], axis=1) > 0).astype(ps.dtype)
    scores = ps[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    i1, i2 = jsm.weighted_sample_2d(key, scores ** 1.5, 3 * n1)
    p2 = jpc.gather_points(pts2, i2).reshape(B, n1, 3, 3)
    p1 = jpc.gather_points(pts1, i1).reshape(B, n1, 3, 3)
    Rs, ts = jpr.weighted_procrustes(p2, p1)
    return (np.asarray(i1).reshape(B, n1, 3), np.asarray(i2).reshape(B, n1, 3),
            np.asarray(p2), np.asarray(Rs), np.asarray(ts))


def jax_sharded(key, atten, pts1, pts2, model, n_dev, dp=1, field=None):
    """What the JAX shard_map computes, per batch shard: each axis index
    d solves its budget from fold_in(key, d); the highest score wins.
    Returns R, t, and per row the winner's (d, template triplet, whether
    the triplet has three distinct points on both sides)."""
    ln1, ln2, lr = local_budget(n_dev, N1, N2, N_REFINE)
    B = len(atten)
    per = B // dp
    R, t, wins = [], [], []
    for s in range(dp):
        rows = slice(s * per, (s + 1) * per)
        args = [jnp.asarray(x[rows]) for x in (atten, pts1, pts2, model)]
        sols = [jm.compute_coarse_Rt(
            jax.random.fold_in(key, d), *args, n_proposal1=ln1,
            n_proposal2=ln2, score_chunk=min(50, ln2), return_score=True,
            dist_field=None if field is None else jnp.asarray(field),
            n_refine=lr) for d in range(n_dev)]
        scores = np.stack([np.asarray(s_[2]) for s_ in sols])  # (n_dev, per)
        best = np.argmax(scores, axis=0)
        hyps = {int(d): _hypotheses(jax.random.fold_in(key, int(d)),
                                    *args[:3], ln1) for d in set(best)}
        for b in range(per):
            d = int(best[b])
            Rb, tb = np.asarray(sols[d][0])[b], np.asarray(sols[d][1])[b]
            i1, i2, p2, Rs, ts = hyps[d]
            k = np.nonzero((Rs[b] == Rb).all(axis=(1, 2))
                           & (ts[b] == tb).all(axis=1))[0][0]
            full = len(set(i1[b, k])) == 3 and len(set(i2[b, k])) == 3
            R.append(Rb)
            t.append(tb)
            wins.append((d, p2[b, k], full))
    return np.stack(R), np.stack(t), wins


def hyp_case(key_seed, n_dev, dp=1, with_field=False):
    # Two rows of test_torch_matching.py's inputs a batch shard, so that
    # the JAX reference reuses the eager ops another case compiled.
    atten, pts1, pts2, model = (np.concatenate(x) for x in zip(*[
        _inputs(key_seed + i) for i in range(dp)]))
    key = jax.random.PRNGKey(key_seed)
    field = None
    if with_field:  # the bank's shared (1, G, G, G) field of one model
        model = np.repeat(model[:1], len(model), axis=0)
        field = np.array(build_min_dist_field(jnp.asarray(model[:1]),
                                              resolution=24))
    ln1 = local_budget(n_dev, N1, N2, N_REFINE)[0]
    per = len(atten) // dp
    inputs = dict(
        shape=(dp, n_dev) if dp > 1 else (n_dev,),
        axes=("dp", "hyp") if dp > 1 else ("hyp",),
        atten=atten, pts1=pts1, pts2=pts2, model=model, field=field,
        n1=N1, n2=N2, n_refine=N_REFINE,
        uniforms=[_local_uniforms(key, d, per, ln1) for d in range(n_dev)])
    return inputs, (key, atten, pts1, pts2, model, n_dev, dp, field)


def check_hyp(results, ref):
    R, t, wins = jax_sharded(*ref)
    for res in results:  # every rank holds its rows' winners
        lo, hi = res["rows"]
        for b in range(lo, hi):
            Rt, tt = res["R"][b - lo], res["t"][b - lo]
            d, p2, full = wins[b]
            if full:
                np.testing.assert_allclose(Rt, R[b], atol=1e-4)
                np.testing.assert_allclose(tt, t[b], atol=1e-4)
            else:  # a repeated draw: its points' images are what it fixes
                np.testing.assert_allclose(p2 @ Rt.T + tt, p2 @ R[b].T + t[b],
                                           atol=1e-4)
            np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-4)
    # These inputs make the cross-rank argmax decide: the winners come
    # from more than one rank.
    assert len({w[0] for w in wins}) > 1, wins
    return wins


# -- the launches ---------------------------------------------------------------

def train_inputs():
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.provider.training_dataset import (
        SyntheticPoseDataset,
        collate,
    )

    cfg = tiny_config(tc)
    tcfg = tc.TrainConfig(batch_size=4, img_size=32,
                          n_sample_observed_point=64,
                          n_sample_template_point=48)
    ds = SyntheticPoseDataset(tcfg, n_samples=8, seed=0)
    batch = collate([ds[i] for i in range(4)])
    model = init_random_(PEM(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return dict(cfg=cfg, optim=tc.OptimConfig(warmup_iters=0, eps=1e-3), batch=batch,
                state=state, seed=3)


def one_process_step(inp):
    from sam6d_tpu_torch.train.state import create_train_state, train_step

    state = create_train_state(inp["cfg"], inp["optim"], device="cpu",
                               state_dict={k: torch.from_numpy(v) for k, v
                                           in inp["state"].items()})
    metrics = train_step(state, inp["batch"],
                         generator=torch.Generator().manual_seed(inp["seed"]))
    return metrics, {k: v.numpy() for k, v in state.model.state_dict().items()}


@pytest.fixture(scope="module")
def pem_tree(tmp_path_factory):
    from sam6d_tpu_torch.pipeline.renderer import render_bop_templates

    base = tmp_path_factory.mktemp("parallel_bop")
    root = base / "lmo"
    bop_tree.write_bop_tree(root, height=96, width=128, n_test=3, n_pbr=0)
    templates = base / "templates"
    render_bop_templates(str(root / "models"), str(templates), 64)
    det_path = str(base / "detection_ism.json")
    bop_tree.save_json(det_path, bop_tree.gt_detections(root))
    return dict(root=str(root), templates=str(templates), det_path=det_path,
                base=base)


def bop_inputs(pem_tree, out):
    import dataclasses

    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.params import init_random_

    cfg = dataclasses.replace(tiny_config(tc), n_sample_template_point=300)
    model = init_random_(PEM(cfg, device="cpu"),
                         torch.Generator().manual_seed(1))
    rng = np.random.RandomState(0)
    n = 3 * cfg.coarse_point_matching.nproposal1
    uniforms = {b: tuple(rng.rand(b, n, 1).astype(np.float32)
                         for _ in range(2)) for b in (1, 2, 4)}
    return dict(cfg=cfg, uniforms=uniforms, root=pem_tree["root"],
                det_path=pem_tree["det_path"], templates=pem_tree["templates"],
                out=str(out),
                state={k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, pem_tree):
    base = tmp_path_factory.mktemp("two_ranks")
    hyp2, ref2 = hyp_case(3, 2, with_field=True)
    train = train_inputs()
    inputs = {"hyp:2": hyp2,
              "merge": dict(dir=str(base / "merge"), delay_s=2.0),
              "train_dp": train, "train_tp": train,
              "cli": dict(cfg=train["cfg"], log_dir=str(base / "cli_log"),
                          params=str(base / "cli_params.npz"),
                          train_cfg=tc.TrainConfig(
                              batch_size=2, img_size=32,
                              n_sample_observed_point=64,
                              n_sample_template_point=48)),
              "mesh": {}, "bop": bop_inputs(pem_tree, base / "bop")}
    return dict(results=launch(base / "run", 2, inputs), inputs=inputs,
                hyp_ref=ref2, base=base)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    base = tmp_path_factory.mktemp("four_ranks")
    hyp4, ref4 = hyp_case(4, 4)
    dphyp, ref_dp = hyp_case(5, 2, dp=2, with_field=True)
    inputs = {"hyp:4": hyp4, "hyp:dp2": dphyp}
    return dict(results=launch(base / "run", 4, inputs),
                refs={"hyp:4": ref4, "hyp:dp2": ref_dp})


# -- the cases --------------------------------------------------------------------

def test_hyp_parallel_solve_on_2_ranks_equals_jax(two_ranks):
    check_hyp(two_ranks["results"]["hyp:2"], two_ranks["hyp_ref"])


def test_hyp_parallel_solve_on_4_ranks_equals_jax(four_ranks):
    check_hyp(four_ranks["results"]["hyp:4"], four_ranks["refs"]["hyp:4"])


def test_hyp_parallel_solve_on_dp2_x_hyp2_equals_jax(four_ranks):
    res = four_ranks["results"]["hyp:dp2"]
    wins = check_hyp(res, four_ranks["refs"]["hyp:dp2"])
    # Ranks (dp, hyp) = (i, 0), (i, 1) hold batch rows 2i, 2i + 1, and
    # both return their winners.
    assert [r["rows"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    np.testing.assert_array_equal(res[0]["R"], res[1]["R"])
    np.testing.assert_array_equal(res[2]["R"], res[3]["R"])
    assert len(wins) == 4


def test_merge_waits_for_the_slow_rank(two_ranks):
    merged = [r["merged"] for r in two_ranks["results"]["merge"]]
    assert merged[1] is None  # only rank 0 merges
    assert merged[0] == [{"rank": 0, "row": 0}, {"rank": 1, "row": 0},
                         {"rank": 1, "row": 1}]
    d = Path(two_ranks["inputs"]["merge"]["dir"])
    assert sorted(os.listdir(d)) == ["merged.json", "pem_shard_0000.json",
                                     "pem_shard_0001.json"]


def test_bop_sweep_over_2_ranks_merges_the_one_process_rows(two_ranks,
                                                            tmp_path):
    from sam6d_tpu_torch.pipeline.bop_eval import run_bop_eval
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    inp = two_ranks["inputs"]["bop"]
    got = [r["rows"] for r in two_ranks["results"]["bop"]]
    run = PEMRunner(inp["cfg"], device="cpu", state_dict={
        k: torch.from_numpy(v) for k, v in inp["state"].items()})
    want = run_bop_eval(inp["cfg"], inp["root"], inp["det_path"],
                        inp["templates"], str(tmp_path), runner=run,
                        uniforms=lambda b: inp["uniforms"][b], device="cpu")
    assert len(want) == 6 and len(got[0]) == len(want)
    # Rank 0 posed frames 0 and 2, rank 1 frame 1; rank 0's merge holds
    # both shards, rank 1 returns its own rows.
    assert [r["im_id"] for r in got[1]] == [1, 1]
    key = lambda r: (r["scene_id"], r["im_id"], r["obj_id"])  # noqa: E731
    by_key = {key(r): r for r in want}
    assert sorted(map(key, got[0])) == sorted(by_key)
    for r in got[0]:
        w = by_key[key(r)]
        np.testing.assert_allclose(r["R"], w["R"], atol=1e-5)
        np.testing.assert_allclose(r["t"], w["t"], atol=1e-3)
        assert r["score"] == pytest.approx(w["score"], abs=1e-6)
    out = Path(inp["out"])
    assert (out / "result_bop.csv").exists()
    assert sorted(p.name for p in out.glob("pem_shard_*.json")) == [
        "pem_shard_0000.json", "pem_shard_0001.json"]


@pytest.mark.parametrize("layout", ["train_dp", "train_tp"])
def test_training_step_equals_one_process_step(two_ranks, layout):
    inp = two_ranks["inputs"][layout]
    metrics, state = one_process_step(inp)
    before = inp["state"]
    for res in two_ranks["results"][layout]:
        m = res["metrics"]
        assert m["update_skipped"] == 0.0 and m["grads_finite"] == 1.0
        for k in ("loss", "grad_norm"):
            assert m[k] == pytest.approx(metrics[k], rel=1e-5), k
        assert res["state"].keys() == state.keys()
        moved = 0
        for k, want in state.items():
            got = res["state"][k]
            if "running" in k:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(got, want, atol=1e-6, err_msg=k)
            moved += not np.array_equal(want, before[k])
        assert moved > 100  # an update was applied


def test_train_cli_over_tp_2_checkpoints_and_saves_full_params(two_ranks):
    """`train_cli` under a 2-rank group with --tp 2: two steps, each tp
    slice's train state in its own checkpoint directory, and
    `save_params` gathering the full weights on rank 0, which
    `PEMRunner.load_params` reads with no entry missed."""
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    res = two_ranks["results"]["cli"]
    inp = two_ranks["inputs"]["cli"]
    assert [(r["step"], r["dp"], r["tp"], r["tp_index"]) for r in res] == [
        (2, 1, 2, 0), (2, 1, 2, 1)]
    ckpt = Path(inp["log_dir"]) / "ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["tp0", "tp1"]
    shards = [torch.load(ckpt / f"tp{i}" / "2.pt", weights_only=True)["model"]
              for i in range(2)]
    qkv = "feature_extraction.rgb_net.vit.blocks_0.attn.qkv.weight"
    assert shards[0][qkv].shape == (72, 48)  # its 6 of 12 heads of q, k, v
    runner = PEMRunner(inp["cfg"], device="cpu")
    assert runner.load_params(res[0]["path"]) == []
    assert runner.model.state_dict()[qkv].shape == (144, 48)
    full = runner.model.state_dict()[qkv]
    for i, shard in enumerate(shards):  # the gather undoes the regrouping
        rows = torch.cat([torch.arange(p * 48 + i * 24, p * 48 + i * 24 + 24)
                          for p in range(3)])
        torch.testing.assert_close(full[rows], shard[qkv], rtol=0, atol=0)
