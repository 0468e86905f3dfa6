"""K7's inverse index, its order of sums and its launch plan, on the CPU.

The CUDA kernel `csrc/scatter_rows.cu` sorts the rows by target (a stable
counting sort: `offsets`, `perm`) and sums each target's rows in ascending
q from 0.0f.  Here `inverse_index_plain` (what the card test holds the
kernel's integers to) is held to numpy's stable argsort; a sum taken by
plain PyTorch in the kernel's order over `perm` is held to
`scatter_rows_plain` bit for bit (both are sequential float32 sums in q
order); `scatter_rows_plain` is held to the JAX scatter and the Pallas
kernel on the positional encoding's own ball-query indices, whose busiest
targets are hit 6-15 times as often as the mean one here; and `scatter_plan` to the H100's limits at
the training step's shapes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sam6d_tpu.ops.pallas.scatter_rows import (
    scatter_rows_pallas,
    scatter_rows_xla,
)
from sam6d_tpu_torch.ops import scatter_rows as sr
from sam6d_tpu_torch.ops.pointcloud import ball_query_from_d2, gather_neighbors

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from ball_query_clouds import (  # noqa: E402
    ball_query_rows,
    hits,
    synthetic_clouds,
)

torch.set_num_threads(2)

SMEM_LIMIT = 232448  # dynamic shared memory a block may have (H100)
STATIC_SMEM_LIMIT = 48 * 1024


def _idx(case):
    """(idx (B, Q) int64, N) for each case the kernel must sort."""
    rng = np.random.RandomState(7)
    if case == "uniform":
        N = 64
        idx = rng.randint(0, N, (2, 900))
        idx[rng.rand(2, 900) < 0.05] = -1
    elif case in ("ball_query_32", "ball_query_64"):
        N, S = 256, int(case[-2:])
        pts = torch.from_numpy(synthetic_clouds(2, N, seed=S))
        return ball_query_rows(pts, 0.1 if S == 32 else 0.2, S), N
    elif case == "all_dropped":
        N = 16
        idx = np.where(rng.rand(2, 300) < 0.5, -1, N + 3)
    elif case == "one_target":
        N = 40
        idx = np.full((1, 2000), 17)
    elif case == "empty_targets":  # only even targets hit
        N = 50
        idx = 2 * rng.randint(0, N // 2, (2, 400))
    elif case == "batch_4":
        N = 32
        idx = rng.randint(-2, N + 2, (4, 500))
    else:  # "n_37": N not a multiple of 8, indices past N dropped too
        N = 37
        idx = rng.randint(-1, N + 1, (3, 777))
    return torch.from_numpy(idx.astype(np.int64)), N


CASES = ["uniform", "ball_query_32", "ball_query_64", "all_dropped",
         "one_target", "empty_targets", "batch_4", "n_37"]


def _ordered_sum(dy, offsets, perm, N):
    """Each target's rows summed one after another in ascending q from
    0.0f in float32: the kernel's order, in plain PyTorch."""
    B, Q, C = dy.shape
    start = offsets[:, :-1].long()
    count = offsets[:, 1:].long() - start
    out = torch.zeros(B, N, C)
    dyf = dy.float()
    for k in range(int(count.max()) if count.numel() else 0):
        rows = torch.gather(perm.long(), 1, (start + k).clamp(max=Q - 1))
        vals = torch.gather(dyf, 1, rows.clamp(min=0)[..., None]
                            .expand(-1, -1, C))
        out = torch.where((count > k)[..., None], out + vals, out)
    return out


@pytest.mark.parametrize("case", CASES)
def test_inverse_index_plain_matches_numpy_stable_argsort(case):
    idx, N = _idx(case)
    offsets, perm = sr.inverse_index_plain(idx, N)
    assert offsets.dtype == perm.dtype == torch.int32
    assert offsets.shape == (idx.shape[0], N + 1) and perm.shape == idx.shape
    for b, row in enumerate(idx.numpy()):
        key = np.where((row >= 0) & (row < N), row, N)
        want_off = np.concatenate(
            [[0], np.cumsum(np.bincount(key, minlength=N + 1)[:N])])
        order = np.argsort(key, kind="stable")[:want_off[-1]]
        np.testing.assert_array_equal(offsets[b].numpy(), want_off)
        np.testing.assert_array_equal(perm[b, :want_off[-1]].numpy(), order)
        assert (perm[b, want_off[-1]:] == -1).all()
        # Each target's rows in ascending q.
        for n in range(N):
            seg = perm[b, want_off[n]:want_off[n + 1]].numpy()
            assert (np.diff(seg) > 0).all() and (row[seg] == n).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_sum_in_the_kernels_order_equals_plain_bit_for_bit(case, dtype):
    idx, N = _idx(case)
    rng = np.random.RandomState(1)
    dy = torch.from_numpy(rng.randn(*idx.shape, 8).astype(np.float32)).to(
        getattr(torch, dtype))
    offsets, perm = sr.inverse_index_plain(idx, N)
    # scatter_rows_plain drops negative indices; the kernel also drops
    # those past N, so they are handed to it as -1.
    want = sr.scatter_rows_plain(idx.where(idx < N, -1), dy, N)
    assert torch.equal(_ordered_sum(dy, offsets, perm, N), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 64])
def test_plain_matches_xla_and_pallas_on_ball_query_indices(S, dtype):
    B, N, C = 2, 256, 8
    pts = torch.from_numpy(synthetic_clouds(B, N, seed=S))
    idx = ball_query_rows(pts, 0.1 if S == 32 else 0.2, S)
    h = hits(idx, N)
    assert int(h.max()) > 4 * S  # the skew the kernel must cope with
    dy = np.random.RandomState(S).randn(B, N * S, C).astype(np.float32)
    jdy = jnp.asarray(dy, dtype)
    jidx = jnp.asarray(idx.numpy(), jnp.int32)
    want_xla = np.asarray(scatter_rows_xla(jidx, jdy, N))
    want_pl = np.asarray(scatter_rows_pallas(jidx, jdy, N, interpret=True))
    got = sr.scatter_rows(idx, torch.from_numpy(dy).to(getattr(torch, dtype)),
                          N).numpy()
    # The XLA scatter adds in index order, as index_add_ does: the same
    # bits.  The Pallas kernel sums each 1024-row tile as a product, then
    # the tiles in order: float32 sums of up to ~1000 unit-normal terms
    # (magnitudes up to ~60, an ulp 4e-6) taken in another order, 3e-5
    # apart here; K7's tolerance against another order, 1e-4.
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_allclose(got, want_pl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("S", [32, 64])
def test_plan_fits_the_card_at_the_training_shapes(S):
    B, N, C, Q = 28, 2048, 32, 2048 * S
    plan = sr.scatter_plan(B, Q, N, C, 2, 0)
    assert plan.place_warps == 8 and plan.tile == 8192
    assert plan.tiles * plan.tile >= Q > (plan.tiles - 1) * plan.tile
    assert plan.tile % (32 * plan.place_warps) == 0
    assert plan.place_smem == 4 * (2 * plan.tile + N) + 2 * 8 * N
    assert 2 * plan.place_smem <= SMEM_LIMIT  # two blocks an SM
    assert plan.count_smem == 4 * N <= STATIC_SMEM_LIMIT
    # 16-byte copies of 64-byte rows: 4 a row, 32 rows a round of 4 a
    # lane; a ring of three rounds a warp, two blocks an SM.
    assert plan.vec == 16 and plan.rows == 32
    assert plan.sum_smem == 8 * 3 * 32 * 4 * 16
    assert 2 * plan.sum_smem <= SMEM_LIMIT
    assert plan.units * plan.unit_rows >= Q
    assert plan.scratch_ints == (B * plan.tiles * N + B * (N + 1) + B * Q
                                 + B * (plan.units + 1))
    # A warp a unit of 1024 perm positions (32 rounds): 64 or 128 units a
    # batch item, at least a block of 8 warps for each of 132 SMs.
    assert plan.units == Q // 1024 and B * plan.units >= 132 * 8


@pytest.mark.parametrize("B,Q,N,C,itemsize,align", [
    (1, 1, 1, 2, 2, 0), (2, 300, 24, 8, 4, 8), (3, 777, 37, 6, 2, 8),
    (1, 100000, 6000, 128, 4, 0), (2, 5000, 20000, 2, 2, 8),
    (1, 0, 10, 4, 4, 0), (4, 2 ** 20, 30000, 32, 2, 0)])
def test_plan_limits_hold_across_shapes(B, Q, N, C, itemsize, align):
    plan = sr.scatter_plan(B, Q, N, C, itemsize, align)
    row = C * itemsize
    assert plan.tile % (32 * plan.place_warps) == 0
    assert plan.tiles * plan.tile >= Q
    assert plan.place_smem == (4 * (2 * plan.tile + N)
                               + 2 * plan.place_warps * (N + N % 2))
    assert plan.place_smem + 128 <= SMEM_LIMIT
    assert plan.count_smem <= SMEM_LIMIT
    assert row % plan.vec == 0 and align % plan.vec == 0
    # A row's vectors spread over a power of two of lanes.
    lanes = 1 << (row // plan.vec - 1).bit_length()
    assert lanes >= row // plan.vec
    assert 1 <= plan.rows == 32 * sr.SUM_UNITS // lanes
    assert plan.sum_smem <= SMEM_LIMIT


@pytest.mark.parametrize("B,Q,N,C", [(1, 10, 4, 130), (1, 10, 60000, 4), (1, 10, 40000, 4),
                                     (1, 10, 4, 0)])
def test_plan_refuses_what_the_kernel_cannot_take(B, Q, N, C):
    with pytest.raises(ValueError):
        sr.scatter_plan(B, Q, N, C, 4, 0)


def test_gather_neighbors_saves_contiguous_int64_indices():
    """The kernel takes contiguous int64 indices: what the positional
    encoding's gather saves for its backward is that already."""
    pts = torch.from_numpy(synthetic_clouds(2, 64))
    nbr = ball_query_from_d2(torch.cdist(pts, pts) ** 2, 0.2, 16)
    feats = torch.randn(2, 64, 8, requires_grad=True)
    out = gather_neighbors(feats, nbr)
    (saved,) = out.grad_fn.saved_tensors
    assert saved.dtype == torch.int64 and saved.is_contiguous()
    assert saved.reshape(2, -1).is_contiguous()
