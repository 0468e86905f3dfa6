"""Port geometric-structure embedding against the JAX package on the CPU.

The fused path (`fused="on"`) of the port runs the plain PyTorch version
of its CUDA kernel here (the tensors lie on the CPU); it is held to the
JAX Pallas kernel in interpret mode.  The unfused Chebyshev path and
the exact path are held to their JAX counterparts, in float32 and
bfloat16.  Points: N = 33 with the bg sentinel at index 0 (at 100, far
outside the Chebyshev domain), hidden 32.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.config import GeoEmbeddingConfig as JCfg
from sam6d_tpu.models.pem.geo_embedding import (
    GeometricStructureEmbedding as JGeo,
    _cheb_sinusoid_coeffs,
)
from sam6d_tpu.ops.pallas.geo_embed import geo_embed_maxk as j_geo_embed_maxk
from sam6d_tpu_torch.config import GeoEmbeddingConfig as TCfg
from sam6d_tpu_torch.models.pem.geo_embedding import (
    GeometricStructureEmbedding as TGeo,
)
from sam6d_tpu_torch.ops.geo_embed import geo_embed_maxk
from sam6d_tpu_torch.params import flax_to_state_dict

torch.set_num_threads(2)

# float32 sin/cos of the sentinel's arguments (up to ~500 rad) differ
# between XLA's and PyTorch's range reductions by up to ~1e-3 after the
# projection; every other entry differs by summation order only.
SENTINEL_ATOL = 3e-3


def _points(B=2, N=33, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.randn(B, N - 1, 3).astype(np.float32)
    pts /= np.abs(pts).max()
    bg = np.full((B, 1, 3), 100.0, np.float32)
    return np.concatenate([bg, pts], axis=1)


@pytest.fixture(scope="module")
def variables():
    # Non-trivial biases so the bias paths are exercised.
    rng = np.random.RandomState(11)
    d = 32
    return {"params": {
        name: {"kernel": (rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
               "bias": (0.1 * rng.randn(d)).astype(np.float32)}
        for name in ("proj_d", "proj_a")
    }}


def _port(variables, dtype=torch.float32, **cfg):
    mod = TGeo(TCfg(hidden_dim=32, **cfg), dtype=dtype)
    mod.load_state_dict(flax_to_state_dict(variables))
    return mod.eval()


def _run_port(mod, pts):
    with torch.no_grad():
        return mod(torch.from_numpy(pts)).float().numpy()


def _check(got, want, atol):
    np.testing.assert_allclose(got[:, 1:, 1:], want[:, 1:, 1:], atol=atol)
    s_atol = max(atol, SENTINEL_ATOL)
    np.testing.assert_allclose(got[:, :1], want[:, :1], atol=s_atol)
    np.testing.assert_allclose(got[:, :, :1], want[:, :, :1], atol=s_atol)


def test_fused_plain_matches_pallas_interpret(variables):
    # Identical float32 bases; the products are summed in another order:
    # 1e-5 absolute on O(1) outputs.
    pts = _points()
    jmod = JGeo(dataclasses.replace(JCfg(hidden_dim=32), fused="on"),
                interpret=True)
    want = np.asarray(jmod.apply(variables, jnp.asarray(pts)))
    got = _run_port(_port(variables, fused="on"), pts)
    _check(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [
    (torch.float32, 1e-5),
    # bfloat16 output: one rounding step at |x| < 4 is 2^-6; the two
    # sides may land on neighbouring bf16 values.
    (torch.bfloat16, 3e-2),
])
def test_unfused_matches_xla_path(variables, dtype, atol):
    pts = _points(seed=3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmod = JGeo(dataclasses.replace(JCfg(hidden_dim=32), fused="off"),
                dtype=jdt)
    want = np.asarray(jmod.apply(variables, jnp.asarray(pts)), np.float32)
    got = _run_port(_port(variables, dtype, fused="off"), pts)
    _check(got, want, atol=atol)


def test_exact_path_matches(variables):
    # *_cheb_terms = 0: sinusoids everywhere; the large distance indices
    # of the sentinel bound the agreement (see SENTINEL_ATOL).
    pts = _points(seed=5)
    cfg = dict(dist_cheb_terms=0, angle_cheb_terms=0)
    jmod = JGeo(JCfg(hidden_dim=32, **cfg))
    want = np.asarray(jmod.apply(variables, jnp.asarray(pts)))
    got = _run_port(_port(variables, **cfg), pts)
    _check(got, want, atol=1e-4)


def test_fused_and_unfused_agree(variables):
    # The two port formulations: the fused one clamps the recurrence
    # argument and adds the sentinel as a delta; 2e-4 as the JAX
    # package holds its own pair (tests/test_geo_embed_fused.py).
    pts = _points(seed=7)
    a = _run_port(_port(variables, fused="on"), pts)
    b = _run_port(_port(variables, fused="off"), pts)
    np.testing.assert_allclose(a, b, atol=2e-4)


def test_auto_takes_the_plain_xla_path_on_cpu(variables, monkeypatch):
    import sam6d_tpu_torch.models.pem.geo_embedding as tg

    def boom(*a, **k):
        raise AssertionError("fused kernel called for CPU points")

    monkeypatch.setattr(tg, "geo_embed_maxk", boom)
    _run_port(_port(variables), _points())


def test_kernel_plain_version_matches_pallas_bf16():
    # The op itself in bfloat16: bases rounded to bf16, products summed
    # in float32, output rounded to bf16 (one bf16 step: 3e-2 at |x|<4).
    rng = np.random.RandomState(9)
    B, N, d = 1, 17, 32
    hi_d, hi_a = 20.0, 12.0
    d_idx = (rng.rand(B, N, N) * hi_d).astype(np.float32)
    a_idx = (rng.rand(B, N, N, 3) * hi_a).astype(np.float32)
    kd = rng.randn(d, d).astype(np.float32) / np.sqrt(d)
    ka = rng.randn(d, d).astype(np.float32) / np.sqrt(d)
    Md = (_cheb_sinusoid_coeffs(40, d, hi_d) @ kd).astype(np.float32)
    Ma = (_cheb_sinusoid_coeffs(28, d, hi_a) @ ka).astype(np.float32)
    bias = (0.1 * rng.randn(1, d)).astype(np.float32)
    want = np.asarray(j_geo_embed_maxk(
        jnp.asarray(d_idx), jnp.asarray(a_idx),
        jnp.asarray(Md, jnp.bfloat16), jnp.asarray(Ma, jnp.bfloat16),
        jnp.asarray(bias), hi_d, hi_a, jnp.bfloat16, True,
    ), np.float32)
    got = geo_embed_maxk(
        torch.from_numpy(d_idx), torch.from_numpy(a_idx),
        torch.from_numpy(Md).bfloat16(), torch.from_numpy(Ma).bfloat16(),
        torch.from_numpy(bias[0]), hi_d, hi_a, torch.bfloat16,
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=3e-2)
    assert np.mean(got == want) > 0.9  # mostly bit-identical
