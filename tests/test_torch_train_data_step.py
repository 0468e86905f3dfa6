"""The first PEM train step on a MegaPose batch, the port against the JAX
package's `train_step` on the CPU at the tiny config: the same files read
by each package's loader (equal arrays), the same weights, the same
pose-noise draws.

Tolerance: the loss and the per-block metrics 1e-5 relative, grad_norm
1e-3, as `tests/test_torch_train_step.py` states (and why).
"""

import numpy as np
import torch
import jax
import jax.numpy as jnp

import sam6d_tpu_torch.config as tc
from sam6d_tpu.config import OptimConfig as JOptim
from sam6d_tpu.config import TrainConfig as JTrain
from sam6d_tpu.provider.training_dataset import (
    MegaPoseDataset as JMegaPose,
    collate as j_collate,
)
from sam6d_tpu.train.state import (
    TrainState as JTrainState,
    make_optimizer,
    train_step as j_train_step,
)
from sam6d_tpu_torch.provider.training_dataset import MegaPoseDataset, collate
from sam6d_tpu_torch.train import state as tstate
from tests.test_torch_train import B, jax_noise, make_setup
from tests.test_torch_train_data_path import SIZES, tree  # noqa: F401

torch.set_num_threads(2)


def test_first_step_on_megapose_batch_matches_jax(tree):  # noqa: F811
    """The same MegaPose batch (each package's loader on the same files
    and seed: equal arrays), the same weights and pose-noise draws: the
    port's first train_step against the JAX package's."""
    j = JMegaPose(JTrain(**SIZES), tree, seed=4)
    t = MegaPoseDataset(tc.TrainConfig(**SIZES), tree, seed=4)
    jbatch = j_collate([j[i] for i in range(B)])
    batch = collate([t[i] for i in range(B)])
    for k in jbatch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)

    setup = make_setup()
    optim = dict(lr=1e-2, warmup_factor=0.1)
    v, model = setup["variables"], setup["model"]
    tx = make_optimizer(JOptim(**optim))
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=v["params"],
        batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]), tx=tx,
        apply_fn=model.apply, spike_skip_norm=150.0)
    _, want = jax.jit(j_train_step)(
        jstate, {k: jnp.asarray(x) for k, x in jbatch.items()}, setup["key"])
    state = tstate.create_train_state(setup["tcfg"], tc.OptimConfig(**optim),
                                      device="cpu", state_dict=setup["state"])
    got = tstate.train_step(state, batch, noise=jax_noise(setup["key"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        rtol = 1e-3 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(got[k], float(w), rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert got["grads_finite"] == 1.0 and state.optimizer.count == 1
