"""The port's PEMRunner.infer against the JAX PEMRunner.infer.

3 instances pad to a bucket of 4 (the pad row repeats the first).
Setup, tolerances and the reason JAX runs op by op are those of
test_torch_pem.py; max_bucket=2 is held in
test_torch_pem_runner_chunks.py (one file per batch shape, so that the
eager JAX runs go to different workers).

Also `MeshPEMRunner` against the JAX runner on the same mesh shape,
the same 3 instances (here, where the eager JAX ops of that bucket are
already compiled).  The port runs in gloo process groups (`tests/
helpers/torch_parallel_worker.py`, as test_torch_parallel.py), started
before the JAX reference, which runs meanwhile on as many of conftest's
virtual CPU devices, op by op.

* dp = 2: the bucket of 3 instances is 4 (a power of two times dp) and
  each rank runs 2 of its rows.  The JAX forward is one global program,
  so instance i sees row i of the key's one draw: the port's ranks are
  fed that draw and take their rows.
* dp 2 x hyp 2: the JAX coarse solve is a shard_map, which op by op
  takes minutes; the test runs what it computes in its place (the JAX
  runner's `_coarse_solver` swapped for it): each dp shard's rows solved
  on each hyp index d with fold_in(key, d), the highest score winning.
  Rank (i, d) of the port is fed the uniforms of fold_in(key, d) for its
  2 rows.

Every rank returns the whole frame; each is compared with `close_poses`'
tolerances (R and t / radius 2e-3, scores 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import sam6d_tpu.models.pem.matching as jm
from sam6d_tpu.parallel.mesh import make_mesh as j_make_mesh
from sam6d_tpu.pipeline.pem_runner import PEMRunner as JRunner
from sam6d_tpu_torch.parallel.hyp_parallel import local_budget
from tests.test_torch_parallel import start_launch
from tests.test_torch_pem import (
    build_tiny,
    check_runner,
    close_poses,
    coarse_uniforms,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return build_tiny()


def test_runner_infer_matches_bucket_4(tiny):
    check_runner(tiny, None, 4)


def jax_runner(tiny, shape, axes):
    mesh = j_make_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
    run = JRunner(tiny["jcfg"], variables=tiny["variables"], mesh=mesh)
    run.template_bank = tiny["jrun"].template_bank
    return run


def emulated_hyp_solver(cfg, dp, n_dev):
    """The JAX sharded solve's result on a (dp, n_dev) mesh, op by op."""
    c = cfg.coarse_point_matching
    ln1, ln2, lr = local_budget(n_dev, c.nproposal1, c.nproposal2, 32)

    def solve(key, atten, p1, p2, m, df):
        per = atten.shape[0] // dp
        R, t = [], []
        for s in range(dp):
            rows = slice(s * per, (s + 1) * per)
            sols = [jm.compute_coarse_Rt(
                jax.random.fold_in(key, d), atten[rows], p1[rows], p2[rows],
                m[rows], n_proposal1=ln1, n_proposal2=ln2,
                score_chunk=min(50, ln2), return_score=True, dist_field=df,
                n_refine=lr) for d in range(n_dev)]
            best = np.argmax(np.stack([np.asarray(x[2]) for x in sols]), 0)
            R += [np.asarray(sols[d][0])[b] for b, d in enumerate(best)]
            t += [np.asarray(sols[d][1])[b] for b, d in enumerate(best)]
        return jax.numpy.asarray(np.stack(R)), jax.numpy.asarray(np.stack(t))

    return solve, ln1


def port_inputs(tiny, shape, axes, uniforms):
    inst = {k: v[:3] for k, v in tiny["inst"].items()}
    return inst, dict(shape=shape, axes=axes, cfg=tiny["tcfg"],
                      state={k: v.numpy() for k, v in tiny["state"].items()},
                      tem_pts=tiny["tem_pts"], tem_feat=tiny["tem_feat"],
                      inst=inst, uniforms=uniforms)


def check(results, want, tiny):
    radius = np.asarray(tiny["jrun"].template_bank["radius"])
    for got in results:
        assert got["bucket"] == 4
        close_poses(got, want, radius)
        np.testing.assert_allclose(got["score"], want["score"], atol=1e-6)


def test_runner_on_dp2_equals_jax(tiny, tmp_path):
    inst, inp = port_inputs(
        tiny, (2,), ("dp",),
        coarse_uniforms(jax.random.PRNGKey(0), 4,
                        tiny["tcfg"].coarse_point_matching.nproposal1))
    ranks = start_launch(tmp_path, 2, {"runner": inp})
    jrun = jax_runner(tiny, (2,), ("dp",))
    assert jrun._min_bucket == 2
    with jax.disable_jit():
        want = jrun.infer(dict(inst))
    check(ranks()["runner"], want, tiny)


def test_runner_on_dp2_x_hyp2_equals_jax(tiny, tmp_path):
    jrun = jax_runner(tiny, (2, 2), ("dp", "hyp"))
    assert jrun._coarse_solver is not None
    jrun._coarse_solver, ln1 = emulated_hyp_solver(tiny["jcfg"], 2, 2)
    k_coarse, _ = jax.random.split(jax.random.PRNGKey(0))
    per_hyp = []
    for d in range(2):
        k1, k2 = jax.random.split(jax.random.fold_in(k_coarse, d))
        per_hyp.append(tuple(np.array(jax.random.uniform(k, (2, 3 * ln1, 1)))
                             for k in (k1, k2)))
    inst, inp = port_inputs(tiny, (2, 2), ("dp", "hyp"), per_hyp)
    ranks = start_launch(tmp_path, 4, {"runner": inp})
    with jax.disable_jit():
        want = jrun.infer(dict(inst))
    check(ranks()["runner"], want, tiny)


@pytest.mark.parametrize("dp", [pytest.param(4, id="mesh_dp4"),
                                pytest.param(None, id="one_card")])
def test_runner_bucket_rule_follows_the_mesh(tiny, dp):
    """The JAX runner's bucket: on a dp mesh (`MeshPEMRunner`) at least
    the dp size, a power of two times it, capped at max(max_bucket, dp);
    without a mesh (`PEMRunner`) the same with dp 1."""
    from sam6d_tpu_torch.parallel.pem_serving import MeshPEMRunner
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    class Mesh:  # what MeshPEMRunner reads of a DeviceMesh to size buckets
        mesh_dim_names = ("dp", "hyp")

        def size(self, i):
            return (4, 2)[i]

    cfg = dataclasses.replace(tiny["tcfg"])
    if dp is None:
        run, jrun = PEMRunner(cfg, device="cpu"), JRunner(tiny["jcfg"])
        assert jrun._min_bucket == 1
    else:
        run = MeshPEMRunner(cfg, Mesh(), device="cpu")
        jrun = jax_runner(tiny, (4, 2), ("dp", "hyp"))
        assert jrun._min_bucket == run.dp == dp
    for max_bucket in (None, 1, 8):
        run.max_bucket = jrun.max_bucket = max_bucket
        # The bucket loop of sam6d_tpu/pipeline/pem_runner.py:infer.
        cap = (max(jrun.max_bucket, jrun._min_bucket) if jrun.max_bucket
               else None)
        for n in (1, 3, 4, 5, 9):
            want = jrun._min_bucket
            while want < n and (cap is None or want < cap):
                want *= 2
            assert run.bucket_for(n) == want, (max_bucket, n)
