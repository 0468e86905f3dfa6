"""The row scatter-add and the neighbour gather's gradient, port against
the JAX package on the CPU.

`scatter_rows_plain` (the plain version of the CUDA kernel K7) is held to
the JAX XLA scatter and to the Pallas kernel in interpret mode, with
negative indices dropped; the port's `gather_neighbors` gradient to
`jax.grad` of the JAX `gather_neighbors` (whose CPU backward is the XLA
scatter).  Sums are float32 over at most a few rows per target, so the
only difference is summation order: 1e-6 absolute on O(1) values.  In
bfloat16 the gradient is cast back to bfloat16 on both sides and may land
one bf16 step apart (2^-8 relative).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sam6d_tpu.ops.pallas.scatter_rows import (
    scatter_rows_pallas,
    scatter_rows_xla,
)
from sam6d_tpu.ops.pointcloud import gather_neighbors as j_gather_neighbors
from sam6d_tpu_torch.ops.pointcloud import gather_neighbors
from sam6d_tpu_torch.ops.scatter_rows import scatter_rows, scatter_rows_plain

torch.set_num_threads(2)


def _inputs(B=2, Q=300, N=24, C=8, seed=0, drop=0.1):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, N, (B, Q)).astype(np.int64)
    idx[rng.rand(B, Q) < drop] = -1
    dy = rng.randn(B, Q, C).astype(np.float32)
    return idx, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_and_pallas(dtype):
    idx, dy = _inputs()
    N = 24
    jdy = jnp.asarray(dy, dtype)
    want_xla = np.asarray(scatter_rows_xla(jnp.asarray(idx, jnp.int32), jdy, N))
    want_pl = np.asarray(scatter_rows_pallas(jnp.asarray(idx, jnp.int32), jdy,
                                             N, interpret=True))
    tdy = torch.from_numpy(dy).to(getattr(torch, dtype))
    got = scatter_rows(torch.from_numpy(idx), tdy, N)
    assert got.dtype == torch.float32 and got.shape == (2, N, 8)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_pl, atol=1e-6)


def test_negative_rows_are_dropped():
    idx = torch.tensor([[0, -1, 0, 2]])
    dy = torch.arange(8, dtype=torch.float32).reshape(1, 4, 2)
    got = scatter_rows_plain(idx, dy, 3)
    np.testing.assert_array_equal(
        got.numpy(), [[[0 + 4, 1 + 5], [0, 0], [6, 7]]])


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6),
                                        ("bfloat16", 2 ** -8)])
def test_gather_neighbors_grad_matches_jax(dtype, rtol):
    rng = np.random.RandomState(3)
    B, N, M, S, C = 2, 20, 20, 6, 8
    feats = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, (B, M, S)).astype(np.int64)
    cot = rng.randn(B, M, S, C).astype(np.float32)

    def jloss(f):
        g = j_gather_neighbors(f, jnp.asarray(idx, jnp.int32))
        return jnp.sum(g.astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(feats, dtype)), np.float32)
    tf = torch.from_numpy(feats).to(getattr(torch, dtype)).requires_grad_()
    out = gather_neighbors(tf, torch.from_numpy(idx))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  tf.detach().float().numpy()[
                                      np.arange(B)[:, None, None], idx])
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tf.grad.dtype == tf.dtype
    np.testing.assert_allclose(tf.grad.float().numpy(), want, rtol=rtol,
                               atol=1e-5)
