"""Port pose solvers (models/pem/matching.py) against the JAX package on
the CPU.

The coarse solver is held on both rescoring paths: the exact chunked
path (no distance field, 4 chunks here) and the serving path that
pre-scores every kept hypothesis on a voxel field and rescores the
leading `n_refine` exactly.  Both sides get the same attention, points
and field (numpy, seeded), and the port gets the uniforms that the JAX
key draws (`weighted_sample_2d` splits the key into the row and column
draws).

What float32 determines is held, not more.  The sampler draws with
replacement, so some triplets hold only two distinct points on a side;
their cross-covariance has rank 1 and the rotation about the line
through the two points is set by float32 noise in the SVD's null space
(up to 1.66 apart between two hosts' square roots).  So the test holds:
the sampled indices exactly; R and t of every hypothesis with three
distinct points on both sides at 1e-4 (one Procrustes solve, float32
rounding only); the winner's index exactly; and the final R, t at 1e-4
when the winner is non-degenerate, else the winner's map of its two
distinct template points at 1e-4 (points on the undetermined axis map
alike under every rotation about it).  The fine pose score is an
inlier fraction, 1e-6.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.models.pem import matching as jm
from sam6d_tpu.ops import pointcloud as jpc
from sam6d_tpu.ops import procrustes as jpr
from sam6d_tpu.ops import sampling as jsm
from sam6d_tpu.ops.distance_field import build_min_dist_field
from sam6d_tpu_torch.models.pem import matching as tm
from sam6d_tpu_torch.ops import pointcloud as tpc
from sam6d_tpu_torch.ops import procrustes as tpr
from sam6d_tpu_torch.ops import sampling as tsm
from sam6d_tpu_torch.ops import svd3 as tsvd

torch.set_num_threads(2)

B, N1, N2, M = 2, 40, 40, 30


def _inputs(seed):
    rng = np.random.RandomState(seed)
    atten = (3.0 * rng.randn(B, 1 + N1, 1 + N2)).astype(np.float32)
    pts1 = (0.3 * rng.randn(B, N1, 3)).astype(np.float32)
    pts2 = (0.3 * rng.randn(B, N2, 3)).astype(np.float32)
    model = (0.3 * rng.randn(B, M, 3)).astype(np.float32)
    return atten, pts1, pts2, model


def _hypotheses_jax(key, atten, pts1, pts2, n1):
    """The coarse solver's sampled triplets and their Procrustes poses:
    idx1, idx2 (B, n1, 3), template triplets (B, n1, 3, 3), Rs, ts."""
    ps = jax.nn.softmax(atten, axis=2) * jax.nn.softmax(atten, axis=1)
    w1 = (jnp.argmax(ps[:, 1:, :], axis=2) > 0).astype(ps.dtype)
    w2 = (jnp.argmax(ps[:, :, 1:], axis=1) > 0).astype(ps.dtype)
    scores = ps[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    i1, i2 = jsm.weighted_sample_2d(key, scores ** 1.5, 3 * n1)
    p1 = jpc.gather_points(pts1, i1).reshape(B, n1, 3, 3)
    p2 = jpc.gather_points(pts2, i2).reshape(B, n1, 3, 3)
    Rs, ts = jpr.weighted_procrustes(p2, p1)
    return tuple(np.asarray(x) for x in (i1.reshape(B, n1, 3),
                                         i2.reshape(B, n1, 3), p2, Rs, ts))


def _hypotheses_torch(atten, pts1, pts2, n1, u):
    ps = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    w1 = (torch.argmax(ps[:, 1:, :], dim=2) > 0).to(ps.dtype)
    w2 = (torch.argmax(ps[:, :, 1:], dim=1) > 0).to(ps.dtype)
    scores = ps[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    i1, i2 = tsm.weighted_sample_2d(scores ** 1.5, 3 * n1, *u)
    p1 = tpc.gather_points(pts1, i1).reshape(B, n1, 3, 3)
    p2 = tpc.gather_points(pts2, i2).reshape(B, n1, 3, 3)
    Rs, ts = tpr.weighted_procrustes(p2, p1)
    return tuple(x.numpy() for x in (i1.reshape(B, n1, 3),
                                     i2.reshape(B, n1, 3), p2, Rs, ts))


def _winner(Rs, ts, R, t):
    """Indices of the hypotheses whose pose the solver returned (bit
    for bit: the final pose is a row of Rs, ts; repeats of one triplet
    solve alike)."""
    return [np.nonzero((Rs[b] == R[b]).all(axis=(1, 2))
                       & (ts[b] == t[b]).all(axis=1))[0].tolist()
            for b in range(B)]


def _distinct(idx):
    return np.array([[len(set(tri)) for tri in row] for row in idx])


def _check_coarse(with_field):
    atten, pts1, pts2, model = _inputs(0)
    n1, n2 = 64, 16
    field = (np.array(build_min_dist_field(jnp.asarray(model),
                                           resolution=24))
             if with_field else None)
    key = jax.random.PRNGKey(3)
    R, t = (np.asarray(x) for x in jm.compute_coarse_Rt(
        key, jnp.asarray(atten), jnp.asarray(pts1), jnp.asarray(pts2),
        jnp.asarray(model), n_proposal1=n1, n_proposal2=n2, score_chunk=4,
        dist_field=None if field is None else jnp.asarray(field), n_refine=8))
    k1, k2 = jax.random.split(key)
    u = tuple(torch.from_numpy(np.array(jax.random.uniform(k, (B, 3 * n1, 1))))
              for k in (k1, k2))
    Rt, tt = (x.numpy() for x in tm.compute_coarse_Rt(
        torch.from_numpy(atten), torch.from_numpy(pts1),
        torch.from_numpy(pts2), torch.from_numpy(model), n_proposal1=n1,
        n_proposal2=n2, score_chunk=4,
        dist_field=None if field is None else torch.from_numpy(field),
        n_refine=8, uniforms=u))

    i1, i2, p2, Rs, ts = _hypotheses_jax(key, jnp.asarray(atten),
                                         jnp.asarray(pts1), jnp.asarray(pts2),
                                         n1)
    i1t, i2t, p2t, Rst, tst = _hypotheses_torch(
        torch.from_numpy(atten), torch.from_numpy(pts1),
        torch.from_numpy(pts2), n1, u)
    np.testing.assert_array_equal(i1t, i1)
    np.testing.assert_array_equal(i2t, i2)
    full = (_distinct(i1) == 3) & (_distinct(i2) == 3)
    np.testing.assert_allclose(Rst[full], Rs[full], atol=1e-4)
    np.testing.assert_allclose(tst[full], ts[full], atol=1e-4)

    win = _winner(Rs, ts, R, t)
    assert all(win), win
    assert _winner(Rst, tst, Rt, tt) == win
    for b in range(B):
        k = win[b][0]
        if full[b, k]:
            np.testing.assert_allclose(Rt[b], R[b], atol=1e-4)
            np.testing.assert_allclose(tt[b], t[b], atol=1e-4)
        else:
            # Two distinct points on each side (a repeated draw): their
            # images are what the solve fixes.
            assert _distinct(i1)[b, k] == _distinct(i2)[b, k] == 2
            pts = p2[b, k]
            np.testing.assert_allclose(pts @ Rt[b].T + tt[b],
                                       pts @ R[b].T + t[b], atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-4)
    return full, win


@pytest.mark.parametrize("with_field", [False, True])
def test_coarse_Rt_matches(with_field):
    full, win = _check_coarse(with_field)
    # These inputs reach both branches of the checks: 32 of the 128
    # triplets have fewer than three distinct points on a side, and the
    # winning triplets (8 and 47) are repeated draws.
    assert int((~full).sum()) == 32
    assert [w[0] for w in win] == [8, 47]


def _sqrt_one_ulp_up_at_odd(x):
    """The correctly rounded root, moved one ulp up wherever its last
    bit is set: a host-independent stand-in for a library sqrt that is
    one ulp off."""
    y = _sqrt_rn(x)
    odd = (y.view(torch.int32) & 1) == 1
    return torch.where(odd, torch.nextafter(y, torch.full_like(y, 2e38)), y)


_sqrt_rn = tsvd._sqrt


@pytest.mark.parametrize("with_field", [False, True])
def test_coarse_Rt_holds_what_float32_determines_under_sqrt_noise(
        with_field, monkeypatch):
    # One ulp of square-root noise in the port's SVD (as a host whose
    # library sqrt does not round to nearest gives it) moves the
    # two-point hypotheses' axial rotation, not what the test holds.
    monkeypatch.setattr(tsvd, "_sqrt", _sqrt_one_ulp_up_at_odd)
    _check_coarse(with_field)


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
