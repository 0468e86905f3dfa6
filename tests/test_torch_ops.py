"""Port ops (sam6d_tpu_torch.ops) against the JAX package on the CPU.

Inputs come from numpy with a seed and go through both sides.  The
port's entry points take the kernels' plain PyTorch versions here
because the tensors lie on the CPU.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.ops import distance_field as jdf
from sam6d_tpu.ops import geometry as jgeo
from sam6d_tpu.ops import pointcloud as jpc
from sam6d_tpu.ops import procrustes as jpr
from sam6d_tpu.ops import sampling as jsm
from sam6d_tpu.ops import svd3 as jsvd
from sam6d_tpu.ops.fps import furthest_point_sample as jfps
from sam6d_tpu_torch.ops import distance_field as tdf
from sam6d_tpu_torch.ops import geometry as tgeo
from sam6d_tpu_torch.ops import pointcloud as tpc
from sam6d_tpu_torch.ops import procrustes as tpr
from sam6d_tpu_torch.ops import sampling as tsm
from sam6d_tpu_torch.ops import svd3 as tsvd
from sam6d_tpu_torch.ops.fps import furthest_point_sample, sample_pts_feats

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
from procrustes_cases import CASES as PROCRUSTES_CASES  # noqa: E402
from procrustes_cases import procrustes_case  # noqa: E402

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def random_rotation(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("B,N,npoint", [(1, 300, 64), (3, 300, 64),
                                        (1, 2048, 196), (3, 2048, 196)])
def test_fps_matches_xla_oracle_index_for_index(B, N, npoint):
    # Exact: both pick the argmax of the same float32 field; ties and
    # near-ties resolve alike only if d2 is summed in the same order.
    pts = np.random.RandomState(B * 7 + N).randn(B, N, 3).astype(np.float32)
    want = np.asarray(jfps(jnp.asarray(pts), npoint, use_pallas=False))
    got = furthest_point_sample(_t(pts), npoint).numpy()
    np.testing.assert_array_equal(got, want)


def _lattice(spacing, jitter):
    g = np.stack(np.meshgrid(*[np.arange(7.0)] * 3, indexing="ij"), -1)
    g = g.reshape(1, -1, 3)
    jit = np.random.RandomState(0).randint(0, 3, g.shape) * jitter
    return (g * spacing + jit).astype(np.float32)


def test_fps_on_a_grid_breaks_ties_to_the_lowest_index():
    # An integer lattice has many exactly equal distances: every tie must
    # go to the lowest index, as jnp.argmax does.
    pts = _lattice(1.0, 0.0)
    want = np.asarray(jfps(jnp.asarray(pts), 40, use_pallas=False))
    np.testing.assert_array_equal(furthest_point_sample(_t(pts), 40).numpy(),
                                  want)


def test_fps_near_ties_follow_the_written_summation_order():
    # A 0.1 lattice with 1e-7 jitter has near-ties that different
    # roundings of d2 break apart.  The port (and its CUDA kernel) sums
    # (dx^2 + dy^2) + dz^2 with every step rounded, as `_fps_xla` is
    # written and as it runs op by op.  Compiled XLA on the CPU contracts
    # the sum into fused multiply-adds and picks other indices here, so
    # the oracle runs with jit disabled.
    pts = _lattice(0.1, 1e-7)
    with jax.disable_jit():
        want = np.asarray(jfps(jnp.asarray(pts), 40, use_pallas=False))
    got = furthest_point_sample(_t(pts), 40).numpy()
    np.testing.assert_array_equal(got, want)
    # The case has teeth: the other association order picks other points.
    p = _t(pts)[0]
    d2 = torch.full((p.shape[0],), float("inf"))
    last, picks = 0, [0]
    for _ in range(39):
        dx, dy, dz = (p - p[last]).unbind(-1)
        d2 = torch.minimum(d2, dx * dx + (dy * dy + dz * dz))
        last = int(torch.argmax(d2))
        picks.append(last)
    assert picks != got[0].tolist()


def test_sample_pts_feats_gathers_the_selected_rows():
    rng = np.random.RandomState(0)
    pts = rng.randn(2, 128, 3).astype(np.float32)
    feats = rng.randn(2, 128, 8).astype(np.float32)
    p, f, idx = sample_pts_feats(_t(pts), _t(feats), 16, return_index=True)
    for b in range(2):
        np.testing.assert_array_equal(p[b].numpy(), pts[b][idx[b].numpy()])
        np.testing.assert_array_equal(f[b].numpy(), feats[b][idx[b].numpy()])


@pytest.mark.parametrize("radius,nsample", [(0.3, 8), (0.6, 16), (1e-4, 4)])
def test_ball_query_from_d2_matches_exactly(radius, nsample):
    # Exact: the same d2 goes to both, the first-k selection is discrete
    # (the last case has rows with no hit besides the point itself and
    # checks the first-hit backfill and the index-0 rule).
    rng = np.random.RandomState(1)
    pts = rng.rand(2, 96, 3).astype(np.float32)
    d2 = np.array(jgeo.pairwise_distance(jnp.asarray(pts), jnp.asarray(pts)))
    d2[1, 5] = 1.0  # a row with no point in range at all
    want = np.asarray(jpc.ball_query_from_d2(jnp.asarray(d2), radius, nsample))
    got = tpc.ball_query_from_d2(_t(d2), radius, nsample).numpy()
    np.testing.assert_array_equal(got, want)


def test_pairwise_distance_and_similarity_match():
    # float32 rounding only: 1e-5 absolute on O(1) values.
    rng = np.random.RandomState(2)
    x = rng.randn(2, 20, 3).astype(np.float32)
    y = rng.randn(2, 30, 3).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.pairwise_distance(_t(x), _t(y)).numpy(),
        np.asarray(jgeo.pairwise_distance(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-5)
    f1 = rng.randn(2, 20, 16).astype(np.float32)
    f2 = rng.randn(2, 30, 16).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.compute_feature_similarity(_t(f1), _t(f2), temp=0.1).numpy(),
        np.asarray(jgeo.compute_feature_similarity(
            jnp.asarray(f1), jnp.asarray(f2), temp=0.1)),
        atol=1e-5)


def test_svd3x3_matches_jax_conventions():
    # Same Jacobi schedule and formulas: U, s, V agree to float32
    # rounding (1e-4 absolute), signs and column order included.  Rank-2
    # and rank-1 inputs exercise the cross-product completion of U.
    rng = np.random.RandomState(3)
    H = rng.randn(64, 3, 3).astype(np.float32)
    a, b = rng.randn(16, 3), rng.randn(16, 3)
    H[:16] = (a[:, :, None] * b[:, None, :]).astype(np.float32)  # rank 1
    c = rng.randn(16, 3, 2) @ rng.randn(16, 2, 3)
    H[16:32] = c.astype(np.float32)  # rank 2
    U, s, V = (np.asarray(x) for x in jsvd.svd3x3(jnp.asarray(H)))
    Ut, st, Vt = (x.numpy() for x in tsvd.svd3x3(_t(H)))
    np.testing.assert_allclose(st, s, atol=1e-4)
    np.testing.assert_allclose(Ut[16:], U[16:], atol=1e-4)
    np.testing.assert_allclose(Vt[16:], V[16:], atol=1e-4)
    # Rank 1: the null space is a plane whose basis float32 noise picks
    # (s2, s3 ~ 1e-4 * s1), so only the leading columns are determined.
    np.testing.assert_allclose(Ut[:16, :, 0], U[:16, :, 0], atol=1e-4)
    np.testing.assert_allclose(Vt[:16, :, 0], V[:16, :, 0], atol=1e-4)
    eye = np.broadcast_to(np.eye(3), Ut.shape)
    np.testing.assert_allclose(np.swapaxes(Ut, 1, 2) @ Ut, eye, atol=1e-4)
    np.testing.assert_allclose(np.swapaxes(Vt, 1, 2) @ Vt, eye, atol=1e-4)


def test_svd_sqrt_rounds_to_nearest():
    # The SVD's square root is the correctly rounded one (float64
    # reference, then one rounding), whatever the host's library sqrt:
    # at rank-deficient H one ulp moves the null singular values.
    rng = np.random.RandomState(11)
    x = (np.abs(rng.randn(20000)) * 10.0 ** rng.randint(-30, 30, 20000)
         ).astype(np.float32)
    x[:4] = [0.0, 1e-45, np.finfo(np.float32).max, np.inf]
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(tsvd._sqrt(_t(x)).numpy(), ref)


def test_weighted_procrustes_matches_and_is_proper():
    # float32 rounding through the SVD: 1e-4 absolute on R and t; det(R)
    # must be +1 (reflections are corrected by the det-sign fix).
    rng = np.random.RandomState(4)
    B, N = 32, 3  # three-point hypotheses, as the coarse stage solves
    src = rng.randn(B, N, 3).astype(np.float32)
    R0 = np.stack([random_rotation(rng) for _ in range(B)])
    ref = src @ np.swapaxes(R0, 1, 2) + rng.randn(B, 1, 3).astype(np.float32)
    ref[:8] = -ref[:8]  # reflected sets: the sign fix has work to do
    w = rng.rand(B, N).astype(np.float32)
    R, t = (np.asarray(x) for x in jpr.weighted_procrustes(
        jnp.asarray(src), jnp.asarray(ref), jnp.asarray(w)))
    Rt, tt = (x.numpy() for x in tpr.weighted_procrustes(_t(src), _t(ref),
                                                         _t(w)))
    np.testing.assert_allclose(Rt, R, atol=1e-4)
    np.testing.assert_allclose(tt, t, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-4)


def test_weighted_procrustes_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    # CPU tensors take the plain version: a launch (or a build) of K8
    # would raise here, and the result is still the JAX package's.
    def refuse(*args, **kwargs):
        raise AssertionError("CPU tensors reached the CUDA kernel")

    monkeypatch.setattr(tpr, "launch", refuse)
    monkeypatch.setattr(tpr, "procrustes_cuda", refuse)
    launches = tpr.KERNEL.launches
    rng = np.random.RandomState(6)
    src = rng.randn(4, 2, 3, 3).astype(np.float32)
    ref = src[..., ::-1, :] * 2.0 + rng.randn(4, 2, 3, 3).astype(np.float32)
    w = rng.rand(4, 2, 3).astype(np.float32)
    for weights in (None, w):
        R, t = (np.asarray(x) for x in jpr.weighted_procrustes(
            jnp.asarray(src), jnp.asarray(ref),
            None if weights is None else jnp.asarray(weights), 0.2))
        Rt, tt = (x.numpy() for x in tpr.weighted_procrustes(
            _t(src), _t(ref), None if weights is None else _t(weights),
            0.2))
        np.testing.assert_allclose(Rt, R, atol=1e-4)
        np.testing.assert_allclose(tt, t, atol=1e-4)
    assert tpr.KERNEL.launches == launches


@pytest.mark.parametrize("case", PROCRUSTES_CASES)
def test_weighted_procrustes_matches_jax_at_the_solves_shapes(case):
    # The plain version against the JAX package at the pose solves' shapes
    # (the coarse (4, 6000) triplets, the fine 3 x 2048 weighted points)
    # and on the cases the card tests hold K8 to it on: R and t within
    # 1e-5 on every problem (the CPU sums as XLA does, so the triplets
    # agree bit for bit).  A rank-1 H leaves R free about the line: there
    # the line's image and t are held.
    src, ref, w, thresh = procrustes_case(
        case, np.random.RandomState(len(case)))
    R, t = (np.asarray(x) for x in jpr.weighted_procrustes(
        jnp.asarray(src), jnp.asarray(ref),
        None if w is None else jnp.asarray(w), thresh))
    Rt, tt = (x.numpy() for x in tpr.weighted_procrustes(
        _t(src), _t(ref), None if w is None else _t(w), thresh))
    np.testing.assert_allclose(tt, t, atol=1e-5, rtol=0)
    if case == "fine_rank1":
        line = src[..., 1, :] - src[..., 0, :]
        line = (line / np.linalg.norm(line, axis=-1, keepdims=True))[..., None]
        np.testing.assert_allclose(Rt @ line, R @ line, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(Rt, R, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,route", [(3, "thread"), (2048, "block")])
def test_procrustes_route_of_the_coarse_and_fine_solves(n, route):
    # The coarse stage's three-point hypotheses take one thread each, the
    # fine stage's 2048 correspondences one block each.
    assert tpr.procrustes_route(n) == route
    assert route in tpr.ROUTES


def test_weighted_sample_2d_matches_with_injected_uniforms():
    # Exact: the same uniforms meet the same float16 CDFs.
    rng = np.random.RandomState(5)
    B, N, M, S = 2, 24, 20, 300
    scores = rng.rand(B, N, M).astype(np.float32) ** 3
    key = jax.random.PRNGKey(7)
    jn, jm = jsm.weighted_sample_2d(key, jnp.asarray(scores), S)
    k1, k2 = jax.random.split(key)
    u1 = np.asarray(jax.random.uniform(k1, (B, S, 1)))
    u2 = np.asarray(jax.random.uniform(k2, (B, S, 1)))
    tn, tm = tsm.weighted_sample_2d(_t(scores), S, _t(u1), _t(u2))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_weighted_sample_2d_needs_uniforms_or_a_generator():
    with pytest.raises(ValueError):
        tsm.weighted_sample_2d(torch.ones(1, 3, 3), 4)
    g = torch.Generator().manual_seed(0)
    n, m = tsm.weighted_sample_2d(torch.ones(1, 3, 3), 4, generator=g)
    assert n.shape == m.shape == (1, 4)


def test_distance_field_build_and_sample_match():
    # The field is a min of float32 distances: 1e-5 absolute.  Lookups of
    # the same field are exact (same voxel, same out-of-grid correction).
    rng = np.random.RandomState(6)
    pts = (rng.randn(2, 50, 3) * 0.4).astype(np.float32)
    fj = np.asarray(jdf.build_min_dist_field(jnp.asarray(pts), resolution=24))
    ft = tdf.build_min_dist_field(_t(pts), resolution=24, chunk=4096).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-5)
    q = (rng.randn(3, 2, 40) * 1.0).astype(np.float32)  # some outside
    want = np.asarray(jdf.sample_min_dist(jnp.asarray(fj), *map(jnp.asarray, q)))
    got = tdf.sample_min_dist(_t(fj), *map(_t, q)).numpy()
    np.testing.assert_array_equal(got, want)
    shared = np.asarray(jdf.sample_min_dist(jnp.asarray(fj[:1]),
                                            *map(jnp.asarray, q)))
    np.testing.assert_array_equal(
        tdf.sample_min_dist(_t(fj[:1]), *map(_t, q)).numpy(), shared)


def test_cuda_entry_points_refuse_without_a_card(monkeypatch):
    from sam6d_tpu_torch.config import PEMConfig, ViTConfig
    from sam6d_tpu_torch.device import resolve_device
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # The entry points default to the card and do not fall back.
    cfg = PEMConfig(feature_extraction=ViTConfig(embed_dim=48, depth=4,
                                                 num_heads=4, img_size=32,
                                                 patch_size=8))
    with pytest.raises(RuntimeError):
        PEM(cfg)
    with pytest.raises(RuntimeError):
        PEMRunner(cfg)
    assert next(PEM(cfg, device="cpu").parameters()).device.type == "cpu"
