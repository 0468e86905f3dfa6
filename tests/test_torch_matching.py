"""Port pose solvers (models/pem/matching.py) against the JAX package on
the CPU.

The coarse solver is held on both rescoring paths: the exact chunked
path (no distance field, 4 chunks here) and the serving path that
pre-scores every kept hypothesis on a voxel field and rescores the
leading `n_refine` exactly.  Both sides get the same attention, points
and field (numpy, seeded), and the port gets the uniforms that the JAX
key draws (`weighted_sample_2d` splits the key into the row and column
draws).

Tolerance: 1e-4 on R and t -- one Procrustes solve of the same sampled
triplets, float32 rounding only; the fine pose score is an inlier
fraction, 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.models.pem import matching as jm
from sam6d_tpu.ops.distance_field import build_min_dist_field
from sam6d_tpu_torch.models.pem import matching as tm

torch.set_num_threads(2)

B, N1, N2, M = 2, 40, 40, 30


def _inputs(seed):
    rng = np.random.RandomState(seed)
    atten = (3.0 * rng.randn(B, 1 + N1, 1 + N2)).astype(np.float32)
    pts1 = (0.3 * rng.randn(B, N1, 3)).astype(np.float32)
    pts2 = (0.3 * rng.randn(B, N2, 3)).astype(np.float32)
    model = (0.3 * rng.randn(B, M, 3)).astype(np.float32)
    return atten, pts1, pts2, model


@pytest.mark.parametrize("with_field", [False, True])
def test_coarse_Rt_matches(with_field):
    atten, pts1, pts2, model = _inputs(0)
    n1, n2 = 64, 16
    field = (np.array(build_min_dist_field(jnp.asarray(model),
                                           resolution=24))
             if with_field else None)
    key = jax.random.PRNGKey(3)
    R, t = jm.compute_coarse_Rt(
        key, jnp.asarray(atten), jnp.asarray(pts1), jnp.asarray(pts2),
        jnp.asarray(model), n_proposal1=n1, n_proposal2=n2, score_chunk=4,
        dist_field=None if field is None else jnp.asarray(field), n_refine=8)
    k1, k2 = jax.random.split(key)
    u = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (B, 3 * n1, 1))))
              for k in (k1, k2))
    Rt, tt = tm.compute_coarse_Rt(
        torch.from_numpy(atten), torch.from_numpy(pts1),
        torch.from_numpy(pts2), torch.from_numpy(model), n_proposal1=n1,
        n_proposal2=n2, score_chunk=4,
        dist_field=None if field is None else torch.from_numpy(field),
        n_refine=8, uniforms=u)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(R), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(Rt.numpy()), 1.0, atol=1e-4)


def test_fine_Rt_matches():
    atten, pts1, pts2, model = _inputs(1)
    R, t, s = (np.asarray(x) for x in jm.compute_fine_Rt(
        jnp.asarray(atten), jnp.asarray(pts1), jnp.asarray(pts2),
        jnp.asarray(model), dis_thres=0.3))
    Rt, tt, st = (x.numpy() for x in tm.compute_fine_Rt(
        torch.from_numpy(atten), torch.from_numpy(pts1),
        torch.from_numpy(pts2), torch.from_numpy(model), dis_thres=0.3))
    np.testing.assert_allclose(Rt, R, atol=1e-4)
    np.testing.assert_allclose(tt, t, atol=1e-4)
    np.testing.assert_allclose(st, s, atol=1e-6)
    assert 0.0 < s.min()  # some inliers: the score is not trivially 0
