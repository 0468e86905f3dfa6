"""One PEM train step of the port against the JAX package's `train_step`
on the CPU, at the tiny config: the metrics, the Adam moments, the
parameters and the BatchNorm statistics after the step; the spike guard
on an overflowing batch; microbatch accumulation; uint8 images.

Setup, weights, batch and pose-noise draws as in test_torch_train.py
(which states why the gradients agree to 3e-3 relative rather than to
float32 rounding).  Tolerances here:
* loss and the per-block metrics 1e-5 relative; grad_norm 1e-3 (a norm
  over the gradients above);
* Adam's first moment is 0.5 x the clipped gradient: 3e-3 relative per
  leaf (Frobenius) plus 1e-6 absolute for the leaves that are zero in
  exact arithmetic; the second moment, a square, 6e-3 and 1e-12;
* parameters: the step runs at lr 1e-2 with warmup_factor 0.1, so its
  first update moves each element by up to 1e-3, far above float32
  rounding.  The change (after - before) of each leaf is held to JAX's
  change at 5% relative (Frobenius) plus 1e-3 x the update's size for
  the leaves whose gradient is zero in exact arithmetic.  Adam's first
  update is g / (|g| + eps), about sign(g), so an element whose gradient
  lies within the 3e-3 disagreement of zero may move the other way: 2.7%
  on the worst leaf.  No update, or one of the wrong sign, is 100-200%;
* BatchNorm statistics 1e-5.
"""

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import sam6d_tpu_torch.config as tc
from sam6d_tpu.config import OptimConfig as JOptim
from sam6d_tpu.train.state import (
    TrainState as JTrainState,
    make_optimizer,
    train_step as j_train_step,
)
from sam6d_tpu_torch.params import flax_to_state_dict
from sam6d_tpu_torch.train import state as tstate
from tests.test_torch_train import jax_noise, make_setup

torch.set_num_threads(2)
# A first update (lr x warmup_factor = 1e-3) that float32 parameters show.
OPTIM = dict(lr=1e-2, warmup_factor=0.1)


def port_state(setup, **optim):
    return tstate.create_train_state(
        setup["tcfg"], tc.OptimConfig(**optim), device="cpu",
        state_dict=setup["state"])


def snapshot(state):
    opt = state.optimizer
    return dict(model={k: v.clone() for k, v in
                       state.model.state_dict().items()},
                mu=[m.clone() for m in opt.mu], nu=[n.clone() for n in opt.nu],
                count=opt.count)


def assert_unchanged(state, snap):
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, snap["model"][k]), k
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    snap["mu"] + snap["nu"]):
        assert torch.equal(a, b)
    assert state.optimizer.count == snap["count"]


@pytest.fixture(scope="module")
def ref():
    setup = make_setup()
    v, model = setup["variables"], setup["model"]
    tx = make_optimizer(JOptim(**OPTIM))
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx,
        apply_fn=model.apply, spike_skip_norm=150.0)
    step = jax.jit(j_train_step)
    batch = {k: jnp.asarray(x) for k, x in setup["batch"].items()}
    new, metrics = step(jstate, batch, setup["key"])
    bad = dict(batch, pts=batch["pts"] * 1e30)
    _, bad_metrics = step(new, bad, setup["key"])
    state = port_state(setup, **OPTIM)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    got = tstate.train_step(state, setup["batch"], noise=jax_noise(setup["key"]))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(setup=setup, jnew=np_tree(new), jmetrics=np_tree(metrics),
                jbad=np_tree(bad_metrics), state=state, metrics=got,
                before=before)


def test_metrics_match_jax(ref):
    got, want = ref["metrics"], ref["jmetrics"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        rtol = 1e-3 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(got[k], float(w), rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert got["grads_finite"] == 1.0 and got["update_skipped"] == 0.0


def test_adam_moments_params_and_batch_stats_match_jax(ref):
    state, jnew = ref["state"], ref["jnew"]
    names = [n for n, _ in state.model.named_parameters()]
    adam = [s for s in jax.tree_util.tree_leaves(
        jnew.opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert state.optimizer.count == int(adam.count) == 1
    for moment, rtol, atol in (("mu", 3e-3, 1e-6), ("nu", 6e-3, 1e-12)):
        want = flax_to_state_dict({"params": getattr(adam, moment)})
        for name, got in zip(names, getattr(state.optimizer, moment)):
            w = want[name].numpy()
            d = np.linalg.norm(got.numpy() - w)
            assert d <= rtol * np.linalg.norm(w) + atol, (moment, name)
    want = flax_to_state_dict({"params": jnew.params,
                               "batch_stats": jnew.batch_stats})
    start = flax_to_state_dict({"params": ref["setup"]["variables"]["params"]})
    got = state.model.state_dict()
    assert want.keys() == got.keys()
    step = OPTIM["lr"] * OPTIM["warmup_factor"]
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
            continue
        moved = (got[k] - ref["before"][k]).double().numpy()
        want_moved = (w - start[k]).double().numpy()
        d = np.linalg.norm(moved - want_moved)
        limit = (5e-2 * np.linalg.norm(want_moved)
                 + 1e-3 * step * np.sqrt(want_moved.size))
        assert d <= limit, (k, d, limit)
    assert state.step == int(jnew.step) == 1


def test_spike_batch_leaves_the_state_unchanged(ref):
    """pts x 1e30 overflows the forward: the gradients are non-finite, the
    update is dropped, and the parameters, the optimizer state (the
    schedule's count included) and the BatchNorm statistics keep their
    values; only the step counter advances, as in the JAX package."""
    state, setup = ref["state"], ref["setup"]
    snap = snapshot(state)
    bad = dict(setup["batch"], pts=setup["batch"]["pts"] * np.float32(1e30))
    m = tstate.train_step(state, bad, noise=jax_noise(setup["key"]))
    assert m["update_skipped"] == float(ref["jbad"]["update_skipped"]) == 1.0
    assert m["grads_finite"] == float(ref["jbad"]["grads_finite"]) == 0.0
    assert_unchanged(state, snap)
    assert state.step == 2


def test_accumulation_applies_every_second_step():
    setup = make_setup(seed=1)
    state = port_state(setup, accum_steps=2)
    noise = jax_noise(setup["key"])
    before = snapshot(state)
    m1 = tstate.train_step(state, setup["batch"], noise=noise)
    assert m1["update_skipped"] == 0.0 and state.optimizer.count == 0
    for k, p in state.model.named_parameters():
        assert torch.equal(p, before["model"][k]), k  # accumulating
    tstate.train_step(state, setup["batch"], noise=noise)
    assert state.optimizer.count == 1 and state.optimizer.mini_step == 0
    assert any(not torch.equal(p, before["model"][k])
               for k, p in state.model.named_parameters())


def test_uint8_images_are_normalised_on_the_device():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    got = tstate._to_device({"rgb": img, "rgb_choose": img[..., 0]
                             .astype(np.int32)}, torch.device("cpu"))
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    want = (img.astype(np.float32) / np.float32(255.0) - mean) / std
    np.testing.assert_allclose(got["rgb"].numpy(), want, rtol=1e-6)
    assert got["rgb_choose"].dtype == torch.int64
