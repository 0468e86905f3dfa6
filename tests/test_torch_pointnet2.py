"""The port's pointnet2 surface against the JAX package on the CPU: the
grouping ops of `ops/pointcloud.py`, `PointnetSAModule` and
`PointnetFPModule` (`ops/pointnet2_modules.py`) and the geometry
helpers of `ops/geometry.py`.

Same numpy inputs on both sides (seeded), the JAX module variables
carried across by `params.flax_to_state_dict`.  The JAX side runs
eagerly (no jit).  Tolerances, float32: indices exact, including planted
ties (three_nn: equal distances lowest index first, as jax.lax.top_k)
and rows with no hit (index 0); grouped and interpolated values and
interpolation weights 1e-6; the modules' outputs 1e-5 relative and
absolute (a SharedMLP of Dense + BatchNorm + ReLU over them: outputs of
size 1-3 differ by up to 2e-5, 6e-6 relative, where train-mode
BatchNorm's variance, mean(x^2) - mean(x)^2 on both sides, sums in
another order) and their batch statistics 1e-6; the geometry helpers
1e-6.  The SA centres come from FPS, which the port
computes on the CPU with its plain version (on the card: the kernel K1,
held to it by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam6d_tpu.ops.geometry as jg
import sam6d_tpu.ops.pointcloud as jpc
import sam6d_tpu_torch.ops.geometry as tg
import sam6d_tpu_torch.ops.pointcloud as tpc
from sam6d_tpu.ops.pointnet2_modules import (
    PointnetFPModule as JFP,
    PointnetSAModule as JSA,
)
from sam6d_tpu_torch.ops.pointnet2_modules import (
    PointnetFPModule as TFP,
    PointnetSAModule as TSA,
)
from sam6d_tpu_torch.params import flax_to_state_dict

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.asarray(x))


def clouds(seed=0, B=2, N=96, M=24):
    rng = np.random.RandomState(seed)
    xyz = (0.5 * rng.randn(B, N, 3)).astype(np.float32)
    centres = (0.5 * rng.randn(B, M, 3)).astype(np.float32)
    centres[:, -2:] += 10.0  # far from every point: no hit
    return xyz, centres


# -- the grouping ops ----------------------------------------------------------

def test_ball_query_and_group_match():
    xyz, centres = clouds()
    feats = np.random.RandomState(1).randn(2, 96, 5).astype(np.float32)
    for radius, ns in ((0.4, 8), (0.9, 16)):
        want = np.asarray(jpc.ball_query(jnp.asarray(centres),
                                         jnp.asarray(xyz), radius, ns))
        got = tpc.ball_query(T(centres), T(xyz), radius, ns).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, -2:] == 0).all()  # zero-hit rows give index 0
        for f, use_xyz in ((feats, True), (feats, False), (None, True)):
            w = jpc.query_and_group(jnp.asarray(xyz), jnp.asarray(centres),
                                    None if f is None else jnp.asarray(f),
                                    radius, ns, use_xyz=use_xyz)
            g = tpc.query_and_group(T(xyz), T(centres),
                                    None if f is None else T(f), radius, ns,
                                    use_xyz=use_xyz)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError, match="neither"):
        tpc.query_and_group(T(xyz), T(centres), None, 0.4, 8, use_xyz=False)


def _rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], axis=1).astype(np.float32)


def test_cylinder_query_matches():
    xyz, centres = clouds(2)
    rng = np.random.RandomState(3)
    rot = _rotations(rng, 2 * 24).reshape(2, 24, 9)
    for radius, hmin, hmax, ns in ((0.3, -0.2, 0.6, 8), (0.5, 0.0, 1.0, 16)):
        want = np.asarray(jpc.cylinder_query(
            jnp.asarray(centres), jnp.asarray(xyz), jnp.asarray(rot), radius,
            hmin, hmax, ns))
        got = tpc.cylinder_query(T(centres), T(xyz), T(rot), radius, hmin,
                                 hmax, ns).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[:, -2:] == 0).all()
        assert (got[:, :-2] > 0).any()  # some neighbourhoods are not empty


def test_three_nn_and_interpolation_match_with_ties():
    rng = np.random.RandomState(4)
    known = (0.5 * rng.randn(2, 20, 3)).astype(np.float32)
    known[:, 7] = known[:, 3]  # duplicates: equal distances to every point
    known[:, 12] = known[:, 3]
    unknown = (0.5 * rng.randn(2, 50, 3)).astype(np.float32)
    unknown[:, :5] = known[:, 3:4] + 1e-3  # nearest: the three copies
    dist_j, idx_j = jpc.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    dist_t, idx_t = tpc.three_nn(T(unknown), T(known))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert (idx_t.numpy()[:, :5] == [3, 7, 12]).all()  # ties: lowest first
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), atol=1e-6)

    w_j = jpc.interpolation_weights(dist_j)
    w_t = tpc.interpolation_weights(dist_t)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)
    zero = np.zeros((1, 1, 3), np.float32)  # a point on a known one
    np.testing.assert_allclose(
        tpc.interpolation_weights(T(zero)).numpy(),
        np.asarray(jpc.interpolation_weights(jnp.asarray(zero))), atol=1e-6)
    feats = rng.randn(2, 20, 6).astype(np.float32)
    got = tpc.three_interpolate(T(feats), idx_t, w_t)
    want = jpc.three_interpolate(jnp.asarray(feats), idx_j, w_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- the modules -------------------------------------------------------------------

def seeded_variables(module, *args, seed=5):
    """JAX variables of `module`'s shapes filled from a seed: LeCun-normal
    kernels, non-trivial BatchNorm scales, biases and statistics."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return (rng.randn(*s.shape) / np.sqrt(s.shape[0])).astype(
                np.float32)
        if "'var'" in name:
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def check_module(jmod, tmod, args, targs, atol=1e-5):
    variables = seeded_variables(jmod, *args)
    tmod.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, variables)))
    for train in (False, True):
        want, upd = jmod.apply(variables, *args, train=train,
                               mutable=["batch_stats"])
        got = tmod(*targs, train=train)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=atol, atol=atol)
        if train:  # the running statistics after one train call
            want_sd = flax_to_state_dict(
                {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                       upd["batch_stats"])})
            sd = tmod.state_dict()
            for k, v in want_sd.items():
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           atol=1e-6, err_msg=k)
    return got


@pytest.mark.parametrize("npoint,with_feats,use_xyz", [
    (16, True, True), (16, False, True), (16, True, False),
    (None, True, True), (None, False, True), (None, True, False)])
def test_sa_module_matches(npoint, with_feats, use_xyz):
    rng = np.random.RandomState(6)
    xyz = (0.3 * rng.randn(2, 128, 3)).astype(np.float32)
    feats = rng.randn(2, 128, 8).astype(np.float32) if with_feats else None
    jmod = JSA(mlp=[16, 32], npoint=npoint, radius=0.25, nsample=12,
               use_xyz=use_xyz)
    tmod = TSA([16, 32], npoint=npoint, radius=0.25, nsample=12,
               use_xyz=use_xyz, in_channels=8 if with_feats else 0)
    jf = None if feats is None else jnp.asarray(feats)
    tf = None if feats is None else T(feats)
    new_xyz, new_feats = check_module(jmod, tmod, (jnp.asarray(xyz), jf),
                                      (T(xyz), tf))
    assert new_feats.shape == (2, npoint or 1, 32)
    if npoint:  # the centres are the FPS picks of the cloud
        from sam6d_tpu.ops.fps import furthest_point_sample

        idx = np.asarray(furthest_point_sample(jnp.asarray(xyz), npoint))
        np.testing.assert_array_equal(
            new_xyz.numpy(), np.take_along_axis(xyz, idx[..., None], 1))


@pytest.mark.parametrize("with_unknown_feats", [False, True])
def test_fp_module_matches(with_unknown_feats):
    rng = np.random.RandomState(7)
    unknown = (0.3 * rng.randn(2, 96, 3)).astype(np.float32)
    known = (0.3 * rng.randn(2, 24, 3)).astype(np.float32)
    kf = rng.randn(2, 24, 10).astype(np.float32)
    uf = rng.randn(2, 96, 4).astype(np.float32) if with_unknown_feats else None
    jmod = JFP(mlp=[16, 8])
    tmod = TFP([16, 8], in_channels=10 + (4 if with_unknown_feats else 0))
    out = check_module(
        jmod, tmod,
        (jnp.asarray(unknown), jnp.asarray(known),
         None if uf is None else jnp.asarray(uf), jnp.asarray(kf)),
        (T(unknown), T(known), None if uf is None else T(uf), T(kf)))
    assert out.shape == (2, 96, 8)


# -- geometry ---------------------------------------------------------------------

def test_geometry_helpers_match():
    rng = np.random.RandomState(8)
    pts = rng.randn(3, 40, 3).astype(np.float32)
    R = _rotations(rng, 3).reshape(3, 3, 3)
    t = rng.randn(3, 3).astype(np.float32)
    for fn in ("transform_points", "inverse_transform_points"):
        want = getattr(jg, fn)(jnp.asarray(pts), jnp.asarray(R), jnp.asarray(t))
        got = getattr(tg, fn)(T(pts), T(R), T(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    back = tg.inverse_transform_points(tg.transform_points(T(pts), T(R), T(t)),
                                       T(R), T(t))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    depth = (0.5 + rng.rand(12, 16)).astype(np.float32)
    K = np.array([[20.0, 0, 7.5], [0, 22.0, 5.5], [0, 0, 1]], np.float32)
    want = jg.depth_to_pointcloud(jnp.asarray(depth), jnp.asarray(K))
    got = tg.depth_to_pointcloud(T(depth), T(K))
    assert got.shape == (12, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
