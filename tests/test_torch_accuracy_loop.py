"""The port's `e2e_synthetic_ar`, `smoke_train_eval` and `train_flagship`
against the JAX tools, on the CPU, and the entry points' runs (the ISM
tools: test_torch_ism_accuracy.py; on the card, K4 / K5 refusing a
gradient and the tiny models' gradients against the CPU's:
test_torch_kernels_cuda.py, which runs there without JAX).  The three
tests that run the JAX PEM share this module, so its variables are made
once and the eager JAX evaluation and requests share one process's
compiled operations.

Same seeds as the JAX tools, the JAX variables carried across by
`sam6d_tpu_torch.params`, both rasterizers pinned to numpy.  Tolerances:
* the synthetic BOP tree: every PNG decodes to equal arrays, the JSON
  files, template xyz maps, meshes and detections are equal; the GT
  poses score an AR of exactly 1;
* `run_eval` at the smoke config (8 template views), the JAX key's
  uniforms injected, the JAX requests op by op: rows held as
  test_torch_bop_pem.py holds a sweep (equal sampled triplets; where
  both coarse winners are triplets of three distinct points, the pose
  within 2e-3, t over the object's radius; a winner with a repeated
  point is float noise, ROADMAP.md section 3), every AR equal;
* `smoke_train_eval`'s `evaluate` at the smoke config (32 / 128 points,
  64-d) on `RenderedPoseDataset`, the JAX tool's loop restated
  (`PEM.__call__` op by op, as the tool runs it, PRNGKey(i) a sample;
  the port poses through `forward_with_bank` without a distance field,
  the JAX key's uniforms injected): where the sample's coarse winners
  are determined (as for `run_eval`), the rotation errors within 2e-3
  deg and the translation errors within 2e-3 mm; the attention
  diagnostics (the JAX train_forward jitted, which moves only float32
  rounding, and its PRNGKey(0) pose noise handed over) 1e-5 relative;
* two steps of `smoke_train_eval`'s loop against the JAX tool's (jitted
  `train_step`, PRNGKey(1) split each step, its draws handed over): the
  loss and metrics 3e-3 relative, each parameter and statistic after the
  steps 3e-3 relative (Frobenius; test_torch_train.py says why gradients
  agree to 3e-3);
* the flagship PEM's JAX variables load into the port's strictly.
"""

import dataclasses
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import sam6d_tpu.config as jc
import sam6d_tpu.models.pem.matching as j_match
import sam6d_tpu_torch.config as tc
import sam6d_tpu_torch.models.pem.matching as t_match
import tools.e2e_synthetic_ar as j_e2e
from sam6d_tpu.config import OptimConfig as JOptim
from sam6d_tpu.config import TrainConfig as JTrain
from sam6d_tpu.models.pem.model import PEM as JPEM
from sam6d_tpu.pipeline.pem_runner import PEMRunner as JRunner
from sam6d_tpu.provider.training_dataset import RenderedPoseDataset as JDS
from sam6d_tpu_torch.models.pem.model import PEM as TPEM
from sam6d_tpu_torch.params import flax_to_state_dict
from sam6d_tpu_torch.pipeline.bop_score import score_dataset
from sam6d_tpu_torch.tools import e2e_synthetic_ar as t_e2e
from sam6d_tpu_torch.tools import smoke_train_eval as t_smoke
from sam6d_tpu_torch.tools import train_flagship as t_flag
from tests.test_torch_bop_pem import recording, winners_if_determined
from tests.test_torch_pem import close_poses, coarse_uniforms, random_variables
from tests.test_torch_train import jax_noise

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
from tool_parity import numpy_rasterizers  # noqa: E402,F401

torch.set_num_threads(2)


def assert_trees_equal(got: pathlib.Path, want: pathlib.Path):
    files = sorted(p.relative_to(want) for p in want.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(got) for p in got.rglob("*")
                           if p.is_file())
    for f in files:
        g, w = got / f, want / f
        if f.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(g)),
                                          np.asarray(Image.open(w)), str(f))
        elif f.suffix == ".json":
            assert json.loads(g.read_text()) == json.loads(w.read_text()), f
        elif f.suffix == ".npy":
            np.testing.assert_array_equal(np.load(g), np.load(w), str(f))
        else:
            assert g.read_bytes() == w.read_bytes(), f


def test_synthetic_bop_tree_matches_jax(tmp_path, numpy_rasterizers):
    got = t_e2e.build_dataset(str(tmp_path / "t"), frames=3,
                              template_size=48)
    want = j_e2e.build_dataset(str(tmp_path / "j"), frames=3,
                               template_size=48)
    assert got[3] == want[3] and len(got[3]) == 3
    assert_trees_equal(tmp_path / "t", tmp_path / "j")


def test_multi_dataset_matches_jax_and_gt_poses_score_one(tmp_path,
                                                          numpy_rasterizers):
    got = t_e2e.build_multi_dataset(str(tmp_path / "t"), n_objects=2,
                                    frames=2, template_size=32)
    want = j_e2e.build_multi_dataset(str(tmp_path / "j"), n_objects=2,
                                     frames=2, template_size=32)
    for g, w in zip(got, want):
        assert g["dets"] == w["dets"]
        assert [g[k] for k in ("obj_id", "scene_id")] == \
            [w[k] for k in ("obj_id", "scene_id")]
    assert_trees_equal(tmp_path / "t", tmp_path / "j")
    out = score_dataset(t_e2e.gt_rows(got), str(tmp_path / "t"))
    assert out["ar"] == 1.0 and out["n_gt"] == 4


def test_smoke_config_is_the_jax_tools():
    assert dataclasses.asdict(t_e2e.smoke_pem_config()) == \
        dataclasses.asdict(j_e2e.smoke_pem_config())


@pytest.fixture(scope="module")
def smoke_variables():
    """Seeded JAX variables of the smoke config's PEM (its shapes from
    an abstract init), and the port's state dict of them."""
    cfg = j_e2e.smoke_pem_config()
    N, S = cfg.fine_npoint, cfg.feature_extraction.img_size
    rng = np.random.RandomState(0)
    example = {
        "pts": (rng.randn(1, N, 3) * 0.05).astype(np.float32),
        "rgb": rng.rand(1, S, S, 3).astype(np.float32),
        "rgb_choose": rng.randint(0, S * S, (1, N)).astype(np.int32),
        "model_pts": (rng.randn(1, N, 3) * 0.05).astype(np.float32),
        "dense_po": (rng.randn(1, N, 3) * 0.05).astype(np.float32),
        "dense_fo": rng.randn(1, N, 32).astype(np.float32)}
    variables = random_variables(JPEM(cfg), example)
    return variables, flax_to_state_dict(variables)


def test_run_eval_matches_jax(tmp_path, numpy_rasterizers, monkeypatch,
                              smoke_variables):
    """run_eval on one frame at the smoke config; the JAX tool's run_eval
    builds its own runner of the same variables."""
    cad, tdir, scene, dets = t_e2e.build_dataset(str(tmp_path / "d"),
                                                 frames=1, template_size=48)
    jcfg = dataclasses.replace(j_e2e.smoke_pem_config(), n_template_view=8)
    tcfg = dataclasses.replace(t_e2e.smoke_pem_config(), n_template_view=8)
    variables, state = smoke_variables
    n1 = tcfg.coarse_point_matching.nproposal1
    u = coarse_uniforms(jax.random.PRNGKey(0), 1, n1)
    rows = {}

    def keep_rows(tag, score):
        def wrapped(r, dataset_dir, **kw):
            rows[tag] = r
            return score(r, dataset_dir, **kw)
        return wrapped

    import sam6d_tpu.pipeline.bop_score as j_score
    import sam6d_tpu_torch.pipeline.bop_score as t_score
    monkeypatch.setattr(j_score, "score_dataset",
                        keep_rows("jax", j_score.score_dataset))
    monkeypatch.setattr(t_score, "score_dataset",
                        keep_rows("port", t_score.score_dataset))
    tcalls = recording(monkeypatch, t_match, jax_side=False)
    jcalls = recording(monkeypatch, j_match, jax_side=True)
    got = t_e2e.run_eval(state, tcfg, cad, tdir,
                         scene, dets, str(tmp_path / "t"), "port",
                         device="cpu", uniforms=u)
    os.makedirs(tmp_path / "j", exist_ok=True)
    t_e2e.write_camera(scene, str(tmp_path / "j" / "camera.json"))
    # The requests op by op (test_torch_pem.py says why); the onboarding
    # jitted, as it samples nothing.
    infer = JRunner.infer

    def eager_infer(self, *a, **k):
        with jax.disable_jit():
            return infer(self, *a, **k)
    monkeypatch.setattr(JRunner, "infer", eager_infer)
    want = j_e2e.run_eval(variables, jcfg, cad, tdir, scene, dets,
                          str(tmp_path / "j"), "jax")
    assert got["ar"] == want["ar"]
    for k in ("ar_vsd", "ar_mssd", "ar_mspd", "n_gt"):
        assert got[k] == want[k], k
    g_rows, w_rows = rows["port"], rows["jax"]
    assert len(g_rows) == len(w_rows) == len(tcalls) == len(jcalls) == 1
    determined = 0
    for g, w, tcall, jcall in zip(g_rows, w_rows, tcalls, jcalls):
        assert {k: g[k] for k in ("scene_id", "im_id", "obj_id")} == \
            {k: w[k] for k in ("scene_id", "im_id", "obj_id")}
        R = np.array(g["R"]).reshape(3, 3)
        assert abs(np.linalg.det(R) - 1) < 1e-4 and np.isfinite(g["t"]).all()
        if winners_if_determined(jcall, tcall, u, n1, monkeypatch) is None:
            continue
        determined += 1

        def pose(r):
            return {"pred_R": np.array(r["R"]).reshape(1, 3, 3),
                    "pred_t": np.array(r["t"])[None] / 1000.0,
                    "score": np.array([r["score"]])}
        # t over the object's radius (50 mm), as close_poses holds it.
        close_poses(pose(g), pose(w), np.array([[0.05]]), score_key="score")
    assert determined == 1


def jax_train_cfg(B):
    """The JAX tool's TrainConfig."""
    return JTrain(batch_size=B, img_size=32, n_sample_observed_point=128,
                  n_sample_template_point=128)


def jax_evaluate(model, variables, source, n_eval):
    """The JAX tool's `evaluate` loop (inline in its main) for the
    rendered dataset, op by op as the tool runs it, returning its errors."""
    rerrs, terrs, crerrs = [], [], []
    for i in range(n_eval):
        s = source.sample(i, aug=False)
        tem_rgb, tem_choose, tem_pts = source.template_arrays(s["obj_idx"],
                                                              seed=i)
        po, fo = model.apply(variables, jnp.asarray(tem_rgb),
                             jnp.asarray(tem_pts), jnp.asarray(tem_choose),
                             128, method=JPEM.get_obj_feats)
        out = model.apply(variables, pts=jnp.asarray(s["pts"])[None],
                          rgb=jnp.asarray(s["rgb"])[None],
                          rgb_choose=jnp.asarray(s["rgb_choose"])[None],
                          model_pts=po, dense_po=po, dense_fo=fo,
                          key=jax.random.PRNGKey(i))
        rerrs.append(t_smoke.rot_err_deg(np.asarray(out["pred_R"])[0],
                                         s["gt_r"]))
        terrs.append(np.linalg.norm(np.asarray(out["pred_t"])[0] - s["gt_t"]))
        crerrs.append(t_smoke.rot_err_deg(np.asarray(out["init_R"])[0],
                                          s["gt_r"]))
    return rerrs, terrs, crerrs


def jax_diagnostics(model, variables, source, nb):
    """The JAX tool's attention diagnostics (train_forward, mutable batch
    statistics, PRNGKey(0)), jitted: training samples no hypotheses, so
    jit moves only float32 rounding (test_torch_train.py)."""
    from sam6d_tpu.provider.training_dataset import collate as j_collate
    from sam6d_tpu.train.loss import pem_loss as j_pem_loss

    eb = {k: jnp.asarray(v) for k, v in j_collate(
        [source.sample(i, aug=False) for i in range(nb)]).items()}

    @jax.jit
    def diag(variables, eb):
        eout, _ = model.apply(
            variables, eb["pts"], eb["rgb"], eb["rgb_choose"], eb["tem_rgb"],
            eb["tem_pts"], eb["tem_choose"], jax.random.PRNGKey(0),
            eb["gt_r"], eb["gt_t"], method="train_forward",
            mutable=["batch_stats"])
        return j_pem_loss(eout, eb["gt_r"], eb["gt_t"],
                          coarse_dis_thres=0.4, fine_dis_thres=0.25)[1]
    return {k: float(v) for k, v in diag(variables, eb).items()}


def test_evaluate_matches_jax(numpy_rasterizers, monkeypatch,
                              smoke_variables):
    """`evaluate` on fixed weights over one held-out sample (its
    diagnostics batch of it) against the JAX tool's loop."""
    variables, state = smoke_variables
    tcfg = t_smoke.train_config(2)
    _, ev = t_smoke.make_datasets("rendered", tcfg, objects=1,
                                  eval_objects=2, n_eval=2)
    jev = JDS(jax_train_cfg(2), n_objects=2, n_template_views=8,
              n_samples=2, seed=987654321)
    model = TPEM(t_smoke.smoke_pem_config(), device="cpu")
    model.load_state_dict(state)
    n1 = model.cfg.coarse_point_matching.nproposal1
    tcalls = recording(monkeypatch, t_match, jax_side=False)
    jcalls = recording(monkeypatch, j_match, jax_side=True)
    got = t_smoke.evaluate(
        model, ev, n_eval=1, batch_size=1,
        uniforms=lambda i: coarse_uniforms(jax.random.PRNGKey(i), 1, n1),
        metrics_noise=jax_noise(jax.random.PRNGKey(0), 1))
    jmodel = JPEM(j_e2e.smoke_pem_config())
    with jax.disable_jit():
        rerrs, terrs, crerrs = jax_evaluate(jmodel, variables, jev, 1)
    em = jax_diagnostics(jmodel, variables, jev, 1)
    assert len(tcalls) == len(jcalls) == 1
    determined = 0
    for i, (tcall, jcall) in enumerate(zip(tcalls, jcalls)):
        u = coarse_uniforms(jax.random.PRNGKey(i), 1, n1)
        if winners_if_determined(jcall, tcall, u, n1, monkeypatch) is None:
            continue
        determined += 1
        assert abs(got["coarse_rot_errs"][i] - crerrs[i]) <= 2e-3
        assert abs(got["rot_errs"][i] - rerrs[i]) <= 2e-3
        assert abs(got["trans_errs"][i] - terrs[i]) * 1e3 <= 2e-3
    assert determined >= 1
    assert got["metrics"].keys() == em.keys()
    for k, w in em.items():
        np.testing.assert_allclose(got["metrics"][k], w, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_loop_matches_jax(numpy_rasterizers, smoke_variables):
    """Two steps of `train` against the JAX tool's loop: its datasets,
    optimizer config and key schedule."""
    import optax  # noqa: F401  (the JAX state's optimizer)
    from sam6d_tpu.provider.training_dataset import collate as j_collate
    from sam6d_tpu.train.state import TrainState as JState
    from sam6d_tpu.train.state import make_optimizer
    from sam6d_tpu.train.state import train_step as j_step
    from sam6d_tpu_torch.train.state import create_train_state

    B, steps = 2, 2
    variables, state_dict = smoke_variables
    ocfg = t_smoke.optim_config(3e-4, 2000)
    jocfg = JOptim(lr=3e-4, warmup_iters=20, max_iters=4000)
    assert ocfg == t_smoke.optim_config() and \
        {k: getattr(ocfg, k) for k in ("lr", "warmup_iters", "max_iters")} \
        == {k: getattr(jocfg, k) for k in ("lr", "warmup_iters", "max_iters")}
    ds, _ = t_smoke.make_datasets("rendered", t_smoke.train_config(B),
                                  objects=2, eval_objects=1, n_eval=1)
    jds = JDS(jax_train_cfg(B), n_objects=2, n_template_views=8,
              n_samples=10**9, seed=0)
    tx = make_optimizer(jocfg)
    jstate = JState(step=jnp.zeros((), jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), tx=tx,
                    apply_fn=JPEM(j_e2e.smoke_pem_config()).apply,
                    spike_skip_norm=150.0, coarse_dis_thres=0.4,
                    fine_dis_thres=0.25)
    step = jax.jit(j_step)
    key, sks, jlog, idx = jax.random.PRNGKey(1), [], [], 0
    for _ in range(steps):
        batch = j_collate([jds[idx + j] for j in range(B)])
        idx += B
        key, sk = jax.random.split(key)
        sks.append(sk)
        jstate, m = step(jstate, batch, sk)
        jlog.append({k: float(v) for k, v in m.items()})

    state = create_train_state(t_smoke.smoke_pem_config(), ocfg, device="cpu",
                               state_dict=state_dict)
    log = t_smoke.train(state, ds, steps, B,
                        noise=lambda it: jax_noise(sks[it], B))
    assert state.step == int(jstate.step) == steps
    for got, want in zip(log, jlog):
        for k in ("loss", "coarse_acc", "fine_acc", "coarse_loss2"):
            if k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=3e-3,
                                           atol=1e-6, err_msg=k)
        assert got["update_skipped"] == 0.0
    want = flax_to_state_dict({"params": jstate.params,
                               "batch_stats": jstate.batch_stats})
    got = state.model.state_dict()
    assert want.keys() == got.keys()
    for k, w in want.items():
        g = got[k].double().numpy()
        w = w.double().numpy()
        assert np.linalg.norm(g - w) <= 3e-3 * np.linalg.norm(w) + 1e-6, k


def test_flagship_weights_cross_the_bridge():
    """The JAX flagship tool's PEM (the shipped config) carried across:
    every entry of the port's PEM, shapes included, strictly."""
    cfg = jc.default_pem_config()
    N, S = cfg.fine_npoint, 224
    example = {
        "pts": np.zeros((1, N, 3), np.float32),
        "rgb": np.zeros((1, S, S, 3), np.float32),
        "rgb_choose": np.zeros((1, N), np.int32),
        "model_pts": np.zeros((1, N, 3), np.float32),
        "dense_po": np.zeros((1, N, 3), np.float32),
        "dense_fo": np.zeros((1, N, cfg.feature_extraction.out_dim),
                             np.float32)}
    shapes = jax.eval_shape(lambda: JPEM(cfg).init(
        jax.random.PRNGKey(0), **example, key=jax.random.PRNGKey(1)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    state = t_flag.make_state(tc.default_pem_config(), tc.OptimConfig(),
                              "cpu", "bf16")
    state.model.load_state_dict(flax_to_state_dict(zeros), strict=True)
    assert state.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def tiny_flagship(monkeypatch):
    """train_flagship at the tiny PEM and small samples (its configs
    monkeypatched), for a CPU run of the entry point."""
    from tests.test_torch_pem import tiny_config

    cfg = dataclasses.replace(tiny_config(tc), n_template_view=8,
                              n_sample_template_point=128,
                              n_sample_model_point=128,
                              n_sample_observed_point=128)
    monkeypatch.setattr(t_flag, "default_pem_config", lambda: cfg)
    monkeypatch.setattr(t_flag, "TrainConfig", lambda batch_size: tc.TrainConfig(
        batch_size=batch_size, img_size=32, n_sample_observed_point=64,
        n_sample_template_point=48))
    return cfg


@pytest.mark.parametrize("pool", [0, 3])
def test_train_flagship_runs_resumes_and_scores(tmp_path, monkeypatch, pool):
    """The entry point on the CPU at a tiny size: 2 steps from the worker
    stream (pool 0) or a fixed pool (pool 3, which stops there); from the
    stream, a resume to 3, the AR curve of both checkpoints beside the
    random weights, the record written."""
    from sam6d_tpu_torch.train.checkpoint import latest_step

    tiny_flagship(monkeypatch)
    ckpt = str(tmp_path / "ckpt")
    args = ["--batch_size", "2", "--objects", "2", "--workers", "1",
            "--pool", str(pool), "--ckpt_dir", ckpt, "--ckpt_every", "2",
            "--eval_frames", "2", "--eval_out", str(tmp_path / "ar"),
            "--device", "cpu", "--dtype", "f32"]
    assert t_flag.main(["--steps", "2", "--skip_eval"] + args) is None
    assert latest_step(ckpt) == 2
    if pool:
        return
    rec = t_flag.main(["--steps", "3", "--eval_curve", "2,3"] + args)
    assert rec["steps"] == 3 and set(rec["ar_curve"]) == {"2", "3"}
    assert 0.0 <= rec["ar_random"] <= 1.0
    assert all(0.0 <= v <= 1.0 for v in rec["ar_curve"].values())
    lines = open(os.path.join(ckpt, "metrics.jsonl")).read().splitlines()
    assert [json.loads(x)["step"] for x in lines] == []  # every 5 steps
    assert json.load(open(os.path.join(ckpt, "flagship_ar.json"))) == \
        json.loads(json.dumps(rec))


def test_smoke_and_e2e_entry_points_run_on_the_cpu(tmp_path):
    """smoke_train_eval --ckpt_dir, then e2e_synthetic_ar on its state."""
    ckpt = str(tmp_path / "ckpt")
    out = t_smoke.main(["--steps", "2", "--eval", "1", "--batch_size", "2",
                        "--objects", "2", "--eval_objects", "1",
                        "--ckpt_dir", ckpt, "--device", "cpu"])
    assert len(out["log"]) == 2 and np.isfinite(out["log"][-1]["loss"])
    out = t_smoke.main(["--steps", "3", "--eval", "1", "--batch_size", "2",
                        "--objects", "2", "--eval_objects", "1",
                        "--ckpt_dir", ckpt, "--device", "cpu"])
    assert len(out["log"]) == 1  # resumed at step 2
    res = t_e2e.main(["--ckpt_dir", ckpt, "--frames", "2", "--out",
                      str(tmp_path / "ar"), "--device", "cpu"])
    for r in res.values():
        assert 0.0 <= r["ar"] <= 1.0 and r["n_gt"] == 2
        assert len(r["request_s"]) == 2

