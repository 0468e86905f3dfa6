"""The PEM training slice of the port against the JAX package on the CPU:
BatchNorm in train mode, the pose noise, the loss, `PEM.train_forward`,
every gradient leaf, the optimizer chain and its schedule, and the
Solver with checkpoint and resume.

Same weights on both sides (JAX variables carried across by
`sam6d_tpu_torch.params`, gradients through the same bridge), the same
synthetic batch (the port's numpy copy of `SyntheticPoseDataset`, equal
array for array), and the same pose-noise draws (the JAX key's draws
handed to the port).  The JAX forward and gradients are jitted: training
samples no hypotheses, so jit moves nothing but float32 rounding (1e-6).

Tolerances: loss and metrics 1e-5 relative; batch statistics 1e-5.
Attention maps (cosine / temp, |x| <= 10) 3e-3 absolute and each
gradient leaf 3e-3 relative (Frobenius), because of the diagonal of the
pairwise-distance field: it is the square root of the cancellation
residual |x|^2 - 2 x.x + |x|^2, and the observed cloud lies about ten
template radii from the camera origin (|x|^2 ~ 100), so the residual is
~1e-5, not 0, and XLA's and PyTorch's matmuls leave different ones.  That
moves the diagonal distance index by up to 0.04 (measured), the
attention maps by up to 1.3e-3 through the geometric attention, and the
gradient leaves by up to 1e-3 relative; every other input agrees to
float32 rounding (the loss to 2e-7).  Leaves whose gradient is zero in
exact arithmetic (key and position biases, which add the same logit to a
whole softmax row) hold float32 noise of ~1e-7 on both sides: 1e-6
absolute.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

import sam6d_tpu_torch.config as tc
from sam6d_tpu.config import OptimConfig as JOptim, TrainConfig as JTrain
from sam6d_tpu.models.pem.matching import aug_pose_noise as j_aug
from sam6d_tpu.models.pem.model import PEM as JPEM
from sam6d_tpu.provider.training_dataset import (
    SyntheticPoseDataset as JSynth,
    collate as j_collate,
)
from sam6d_tpu.train.loss import pem_loss as j_pem_loss
from sam6d_tpu.train.state import make_optimizer, warmup_cosine_schedule
from sam6d_tpu_torch.models.layers import BatchNorm
from sam6d_tpu_torch.models.pem.matching import aug_pose_noise
from sam6d_tpu_torch.models.pem.model import PEM as TPEM
from sam6d_tpu_torch.params import flax_to_state_dict
from sam6d_tpu_torch.provider.training_dataset import (
    SyntheticPoseDataset as TSynth,
    collate,
)
from sam6d_tpu_torch.train import state as tstate
from sam6d_tpu_torch.train.loss import pem_loss
from tests.test_pem_model import tiny_pem_config
from tests.test_torch_pem import random_variables, tiny_config

torch.set_num_threads(2)

B, N_OBS, N_TEM, S = 2, 64, 48, 32
STD_ROTS = (15.0, 10.0, 5.0, 1.25, 1.0)


def tiny_train_cfg(cls, **kw):
    """A TrainConfig (of either package) at the tiny model's sizes."""
    return cls(batch_size=B, img_size=S, n_sample_observed_point=N_OBS,
               n_sample_template_point=N_TEM, **kw)


def jax_noise(key, n=B):
    """The draws `PEM.__call__(train=True)` takes from `key` for
    aug_pose_noise (the coarse half of the key, split in three)."""
    k_coarse, _ = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k_coarse, 3)
    return (float(jax.random.choice(k1, jnp.asarray(STD_ROTS))),
            torch.from_numpy(np.asarray(jax.random.normal(k2, (n, 3)))),
            torch.from_numpy(np.asarray(jax.random.normal(k3, (n, 3)))))


def make_setup(seed=0):
    jcfg, tcfg = tiny_pem_config(), tiny_config(tc)
    batch = j_collate([JSynth(tiny_train_cfg(JTrain), n_samples=8, seed=seed)[i]
                       for i in range(B)])
    model = JPEM(jcfg)
    ex = dict(pts=batch["pts"], rgb=batch["rgb"],
              rgb_choose=batch["rgb_choose"], model_pts=batch["pts"][:, :32],
              dense_po=batch["pts"], dense_fo=np.zeros((B, 64, 32), np.float32))
    variables = random_variables(model, ex)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, model=model,
                variables=variables, state=flax_to_state_dict(variables),
                key=jax.random.PRNGKey(7))


def jax_loss_fn(model, batch):
    def loss_fn(params, batch_stats, key):
        out, upd = model.apply(
            {"params": params, "batch_stats": batch_stats},
            batch["pts"], batch["rgb"], batch["rgb_choose"], batch["tem_rgb"],
            batch["tem_pts"], batch["tem_choose"], key, batch["gt_r"],
            batch["gt_t"], method="train_forward", mutable=["batch_stats"])
        loss, metrics = j_pem_loss(out, batch["gt_r"], batch["gt_t"])
        return loss, (metrics, upd["batch_stats"], out)
    return loss_fn


def port_model(setup, dtype=torch.float32):
    m = TPEM(setup["tcfg"], dtype=dtype, device="cpu")
    m.load_state_dict(setup["state"])
    return m


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def jax_ref(setup):
    f = jax.jit(jax.value_and_grad(jax_loss_fn(setup["model"], setup["batch"]),
                                   has_aux=True))
    v = setup["variables"]
    (loss, (metrics, bs, out)), grads = f(v["params"], v["batch_stats"],
                                          setup["key"])
    return jax.tree_util.tree_map(np.asarray, dict(
        loss=loss, metrics=metrics, bs=bs, out=out, grads=grads))


@pytest.fixture(scope="module")
def port_ref(setup):
    m = port_model(setup)
    b = tensors(setup["batch"])
    out = m.train_forward(b["pts"], b["rgb"], b["rgb_choose"].long(),
                          b["tem_rgb"], b["tem_pts"],
                          b["tem_choose"].long(), b["gt_r"], b["gt_t"],
                          noise=jax_noise(setup["key"]))
    loss, metrics = pem_loss(out, b["gt_r"], b["gt_t"])
    loss.backward()
    return dict(model=m, out=out, loss=loss, metrics=metrics)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else np.linalg.norm(a)


def test_synthetic_dataset_is_the_jax_one():
    jds = JSynth(tiny_train_cfg(JTrain), n_samples=4, seed=3)
    tds = TSynth(tiny_train_cfg(tc.TrainConfig), n_samples=4, seed=3)
    want = j_collate([jds[i] for i in range(3)])
    got = collate([tds[i] for i in range(3)])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Two train-mode calls: outputs, and the running statistics after
    each (two momentum-0.9 updates with the biased variance)."""
    rng = np.random.RandomState(0)
    xs = [(rng.randn(3, 7, 5, 16) * 2 + 1).astype(np.float32)
          for _ in range(2)]
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    mean0 = (0.1 * rng.randn(16)).astype(np.float32)
    var0 = (0.5 + rng.rand(16)).astype(np.float32)
    jbn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=getattr(jnp, dtype))
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    tbn = BatchNorm(16, dtype=getattr(torch, dtype))
    tbn.load_state_dict(flax_to_state_dict(variables))
    for x in xs:
        jx = jnp.asarray(x, getattr(jnp, dtype))
        want, upd = jbn.apply(variables, jx, use_running_average=False,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = tbn(torch.from_numpy(x).to(getattr(torch, dtype)), train=True)
        # bfloat16: one step of the rounded output at |y| < 8.
        atol = 1e-5 if dtype == "float32" else 2 ** -7 * 4
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), atol=atol)
        for k, tk in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(tbn, tk).numpy(), np.asarray(upd["batch_stats"][k]),
                rtol=1e-5, atol=1e-6, err_msg=k)
    # Eval mode reads the running statistics and leaves them alone.
    before = tbn.running_mean.clone()
    tbn(torch.from_numpy(xs[0]).to(getattr(torch, dtype)))
    assert torch.equal(tbn.running_mean, before)


def test_aug_pose_noise_matches_jax():
    rng = np.random.RandomState(1)
    R = np.linalg.qr(rng.randn(4, 3, 3))[0].astype(np.float32)
    t = rng.randn(4, 3).astype(np.float32)
    t[0, 2] = -5.0  # the z clamp at 1e-6
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    noise = (float(jax.random.choice(k1, jnp.asarray(STD_ROTS))),
             torch.from_numpy(np.asarray(jax.random.normal(k2, (4, 3)))),
             torch.from_numpy(np.asarray(jax.random.normal(k3, (4, 3)))))
    with jax.disable_jit():
        wR, wt = j_aug(key, jnp.asarray(R), jnp.asarray(t))
    gR, gt = aug_pose_noise(torch.from_numpy(R), torch.from_numpy(t), noise)
    np.testing.assert_allclose(gR.numpy(), np.asarray(wR), atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-6)
    assert gt[0, 2] == pytest.approx(1e-6)
    # Drawn from a generator instead: rotations stay rotations.
    gR, _ = aug_pose_noise(torch.from_numpy(R), torch.from_numpy(t),
                           generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(torch.linalg.det(gR).numpy(), 1.0, atol=1e-5)


def test_pem_loss_matches_jax():
    """The loss, its metrics and its gradient w.r.t. the attention maps,
    on the same maps and clouds."""
    rng = np.random.RandomState(5)
    n1, n2 = 12, 10
    p1 = rng.randn(B, n1, 3).astype(np.float32) * 0.3
    p2 = rng.randn(B, n2, 3).astype(np.float32) * 0.3
    R = np.linalg.qr(rng.randn(B, 3, 3))[0].astype(np.float32)
    t = (0.1 * rng.randn(B, 3)).astype(np.float32)
    radius = np.array([0.9, 1.1], np.float32)
    attens = [rng.randn(B, n1 + 1, n2 + 1).astype(np.float32) * 5
              for _ in range(2)]
    jout = dict(radius=radius, coarse_attens=attens, sparse_pm=p1,
                sparse_po=p2, fine_attens=attens[::-1], dense_pm=p1,
                dense_po=p2)

    def jl(att):
        o = dict(jout, coarse_attens=att[:2], fine_attens=att[2:])
        return j_pem_loss(o, R, t, 0.3, 0.4)

    (wl, wm), wg = jax.value_and_grad(jl, has_aux=True)(
        [jnp.asarray(a) for a in attens + attens[::-1]])
    ta = [torch.from_numpy(a).requires_grad_() for a in attens + attens[::-1]]
    tout = {k: torch.from_numpy(np.asarray(v)) for k, v in jout.items()
            if "attens" not in k}
    tout.update(coarse_attens=ta[:2], fine_attens=ta[2:])
    gl, gm = pem_loss(tout, torch.from_numpy(R), torch.from_numpy(t), 0.3, 0.4)
    gl.backward()
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(float(gm[k].detach()), float(wm[k]),
                                   rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for a, w in zip(ta, wg):
        assert rel(a.grad.numpy(), w) < 1e-5


def test_train_forward_matches_jax(jax_ref, port_ref):
    want, got = jax_ref["out"], port_ref["out"]
    for k in ("radius", "sparse_pm", "sparse_po", "dense_pm", "dense_po",
              "init_R", "init_t", "pred_R", "pred_t"):
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in ("coarse_attens", "fine_attens"):
        assert len(got[k]) == len(want[k]) == 3
        for g, w in zip(got[k], want[k]):
            np.testing.assert_allclose(g.detach().numpy(), w, atol=3e-3,
                                       err_msg=k)


def test_loss_metrics_and_batch_stats_match_jax(jax_ref, port_ref):
    np.testing.assert_allclose(float(port_ref["loss"]), jax_ref["loss"],
                               rtol=1e-5)
    assert port_ref["metrics"].keys() == jax_ref["metrics"].keys()
    for k, w in jax_ref["metrics"].items():
        np.testing.assert_allclose(float(port_ref["metrics"][k]), w,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # Two updates per BatchNorm (the observed side's PE, then the
    # template side's), from the random statistics the weights carry.
    bs = flax_to_state_dict({"batch_stats": jax_ref["bs"]})
    bufs = dict(port_ref["model"].named_buffers())
    assert bs.keys() == bufs.keys()
    for k, w in bs.items():
        np.testing.assert_allclose(bufs[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_every_gradient_leaf_matches_jax(jax_ref, port_ref):
    want = flax_to_state_dict({"params": jax_ref["grads"]})
    params = dict(port_ref["model"].named_parameters())
    assert want.keys() == params.keys()
    bad = {}
    for k, w in want.items():
        d = np.linalg.norm(params[k].grad.numpy() - w.numpy())
        if not d <= 3e-3 * np.linalg.norm(w.numpy()) + 1e-6:
            bad[k] = rel(params[k].grad.numpy(), w.numpy())
    assert not bad, bad


def test_vit_remat_keeps_values_and_gradients(setup):
    """ViTConfig.remat recomputes each block in the backward: the same
    features and the same gradients, to the bit."""
    cfg = tiny_config(tc)
    rng = np.random.RandomState(4)
    rgb = torch.from_numpy(rng.rand(2, S, S, 3).astype(np.float32))
    choose = torch.from_numpy(rng.randint(0, S * S, (2, 16)))
    cot = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))
    res = []
    for remat in (False, True):
        fe = dataclasses.replace(cfg.feature_extraction, remat=remat)
        m = TPEM(dataclasses.replace(cfg, feature_extraction=fe),
                 device="cpu")
        m.load_state_dict(setup["state"])
        f = m.feature_extraction.get_img_feats(rgb, choose)
        (f * cot).sum().backward()
        res.append((f.detach(), {n: p.grad for n, p in m.named_parameters()
                                 if p.grad is not None}))
    assert torch.equal(res[0][0], res[1][0])
    assert res[0][1].keys() == res[1][1].keys() and res[0][1]
    for k, g in res[0][1].items():
        assert torch.equal(g, res[1][1][k]), k


def test_schedule_matches_optax():
    cfg = JOptim()
    want = warmup_cosine_schedule(cfg)
    got = tstate.warmup_cosine_schedule(tc.OptimConfig())
    for step in (0, 1, 999, 1000, 5000, 600_000, 700_000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))
    assert got(0) == pytest.approx(1e-7)


OPTIM_CASES = {
    # lr large enough that each update shows in float32 parameters.
    "adam_clip": dict(lr=1e-2, warmup_iters=3),
    "spike_skip": dict(lr=1e-2, warmup_iters=3, spike_skip_norm=40.0),
    "accum_2": dict(lr=1e-2, warmup_iters=3, accum_steps=2),
    "no_clip": dict(lr=1e-2, warmup_iters=3, grad_clip=0.0),
}


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_optimizer_chain_matches_optax(case):
    """Five steps of the port's Optimizer against the JAX package's
    make_optimizer chain on the same gradients: parameters, Adam moments
    and the count after each.  Step 3 carries a gradient spike (norm 50,
    above the 40 of the spike case), step 4 a NaN."""
    kw = OPTIM_CASES[case]
    jtx = make_optimizer(JOptim(**kw))
    rng = np.random.RandomState(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jtx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = tstate.Optimizer(tp, tc.OptimConfig(**kw))
    for step in range(5):
        g = {k: (rng.randn(*s) * 0.5).astype(np.float32)
             for k, s in shapes.items()}
        if step == 3:
            scale = 50.0 / np.sqrt(sum((v ** 2).sum() for v in g.values()))
            g = {k: v * np.float32(scale) for k, v in g.items()}
        if step == 4:
            g["b"][0] = np.nan
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g[k]) for k in shapes])
        # float32 rounding, which the global norm (summed in another
        # order) and Adam's cancellations can lift to ~1e-6 of a leaf's
        # largest value.
        def close(a, b, what):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=f"{case} step {step} {what}")

        for k, t in zip(shapes, tp):
            close(t.numpy(), jp[k], k)
        adam = [s for s in jax.tree_util.tree_leaves(
            jst, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        assert len(adam) == 1
        assert opt.count == int(adam[0].count), (case, step)
        for i, k in enumerate(shapes):
            close(opt.mu[i].numpy(), adam[0].mu[k], f"mu {k}")
            close(opt.nu[i].numpy(), adam[0].nu[k], f"nu {k}")


def test_solver_runs_two_steps_then_resumes(tmp_path):
    """The CLI's Solver on the tiny config, on the CPU: two synthetic
    steps, a metrics line per step, a checkpoint; then a fresh Solver
    resumes it: parameters, BatchNorm statistics, optimizer state and step
    equal to the saved ones."""
    from sam6d_tpu_torch.train import train_cli

    args = train_cli.parse_args(["--synthetic", "--steps", "2", "--epochs",
                                 "1", "--device", "cpu",
                                 "--log_dir", str(tmp_path)])
    cfg = tiny_train_cfg(tc.TrainConfig, iters_to_print=1)
    solver = train_cli.build_solver(args, tiny_config(tc), cfg)
    before = [p.detach().clone() for p in solver.state.model.parameters()]
    solver.solve(1)
    state = solver.state
    assert state.step == 2 and state.optimizer.count >= 1
    assert any(not torch.equal(a, p) for a, p in
               zip(before, state.model.parameters()))
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"loss"' in lines[0]
    assert (tmp_path / "ckpt" / "2.pt").exists()

    again = train_cli.build_solver(args, tiny_config(tc), cfg).resume()
    s2 = again.state
    assert s2.step == 2 and s2.optimizer.count == state.optimizer.count
    for (k, a), b in zip(state.model.state_dict().items(),
                         s2.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    s2.optimizer.mu + s2.optimizer.nu):
        assert torch.equal(a, b)
