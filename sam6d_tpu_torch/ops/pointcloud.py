"""Point-cloud gathers and grouping primitives, channel-last.

Counterpart of `sam6d_tpu/ops/pointcloud.py`: features are (B, N, C) and
indices int64 tensors of any trailing shape.  `gather_neighbors` carries
its own backward (`ops/scatter_rows.py`).  Ball and cylinder queries,
`query_and_group` and the three-neighbour interpolation are the pointnet2
surface (`ops/pointnet2_modules.py`; reference pointnet2_utils.py).
"""

from __future__ import annotations

import torch

from sam6d_tpu_torch.ops.geometry import pairwise_distance
from sam6d_tpu_torch.ops.scatter_rows import scatter_rows
from sam6d_tpu_torch.ops.topk import top_k_indices


def batched_row_gather(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B, N, C = feats.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(feats, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(*idx.shape, C)


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, M) -> (B, M, C)."""
    return batched_row_gather(feats, idx)


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    return batched_row_gather(feats, idx)


class _GatherNeighbors(torch.autograd.Function):
    """Row gather whose backward is the row scatter-add `scatter_rows`
    (the CUDA kernel K7 on the card), cast back to the cotangent's dtype,
    as the JAX `gather_neighbors` custom VJP (ops/pointcloud.py:84-100).
    The indices get no gradient."""

    @staticmethod
    def forward(ctx, feats, idx):
        ctx.save_for_backward(idx)
        ctx.n_targets = feats.shape[1]
        return batched_row_gather(feats, idx)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        B, C = idx.shape[0], dy.shape[-1]
        df = scatter_rows(idx.reshape(B, -1), dy.reshape(B, -1, C).contiguous(),
                          ctx.n_targets)
        return df.to(dy.dtype), None


def gather_neighbors(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather for the fine-stage positional encoding:
    feats (B, N, C), idx (B, ...) int64 -> (B, ..., C), differentiable in
    feats through the row scatter-add."""
    return _GatherNeighbors.apply(feats, idx.long())


def _first_k_true(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k True entries of each row, in scan order;
    N where a row has fewer than k."""
    N = mask.shape[-1]
    order = torch.arange(N, device=mask.device, dtype=torch.int32)
    key = torch.where(mask, order, torch.full_like(order, N))
    # The key is its own payload and every real key is unique, so the
    # k smallest are the first k hits whatever the tie order of the N
    # sentinels.
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def ball_query_from_d2(d2: torch.Tensor, radius: float,
                       nsample: int) -> torch.Tensor:
    """Fixed-size radius neighborhoods from a squared-distance matrix.

    The first `nsample` in-radius points in scan order; short rows
    repeat their first hit, and rows with no hit give index 0
    (reference ball_query.cpp:46-131).
    """
    return _backfill(_first_k_true(d2 < radius * radius, nsample),
                     d2.shape[-1])


def _backfill(idx: torch.Tensor, N: int) -> torch.Tensor:
    """Short rows repeat their first hit; rows with no hit give index 0."""
    valid = idx < N
    first = torch.where(valid[..., :1], idx[..., :1],
                        torch.zeros_like(idx[..., :1]))
    return torch.where(valid, idx, first).long()


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """Centres (B, M, 3), points (B, N, 3) -> (B, M, nsample) int64: the
    first `nsample` points in scan order with squared distance below
    radius^2, backfilled as `ball_query_from_d2`."""
    return ball_query_from_d2(pairwise_distance(new_xyz, xyz), radius,
                              nsample)


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    feats: torch.Tensor | None, radius: float, nsample: int,
                    use_xyz: bool = True) -> torch.Tensor:
    """Ball query, gather and centre-subtract (reference `QueryAndGroup`,
    pointnet2_utils.py:303-403): (B, M, nsample, 3 + C) with features
    and use_xyz, else (B, M, nsample, C) or (B, M, nsample, 3)."""
    idx = ball_query(new_xyz, xyz, radius, nsample)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is not None:
        grouped_feats = group_points(feats, idx)
        if use_xyz:
            return torch.cat([grouped_xyz, grouped_feats], dim=-1)
        return grouped_feats
    if not use_xyz:
        raise ValueError("cannot have neither features nor xyz")
    return grouped_xyz


def cylinder_query(new_xyz: torch.Tensor, xyz: torch.Tensor,
                   rot: torch.Tensor, radius: float, hmin: float, hmax: float,
                   nsample: int) -> torch.Tensor:
    """Fixed-size cylinder neighbourhoods (reference ov_pointnet2_op/
    cylinder_query.cpp:74-158).

    rot (B, M, 9): each centre's row-major cylinder-to-world rotation R.
    A point is a hit when its offset, taken to the cylinder frame by
    R^T, has y^2 + z^2 < radius^2 and hmin < x < hmax.  The first
    `nsample` hits in scan order, backfilled as `ball_query` (rows with
    no hit give index 0).  Component by component: no (B, M, N, 3)
    tensor is built.  Returns (B, M, nsample) int64."""
    d = [xyz[:, None, :, c] - new_xyz[:, :, None, c] for c in range(3)]
    r = rot.reshape(rot.shape[:-1] + (3, 3))

    def local(i):  # l_i = sum_j R[j, i] d_j
        return (r[..., 0, i][..., None] * d[0]
                + r[..., 1, i][..., None] * d[1]
                + r[..., 2, i][..., None] * d[2])

    lx, ly, lz = local(0), local(1), local(2)
    mask = (ly * ly + lz * lz < radius * radius) & (lx > hmin) & (lx < hmax)
    return _backfill(_first_k_true(mask, nsample), xyz.shape[1])


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest `known` (B, M, 3) points of each `unknown` (B, N, 3)
    point -> (distances (B, N, 3), not squared; int64 indices (B, N, 3)),
    nearest first, equal distances lowest index first (`jax.lax.top_k`'s
    order, `ops/topk.py`)."""
    d2 = pairwise_distance(unknown, known)
    idx = top_k_indices(-d2, 3)
    dist = torch.sqrt(torch.clamp_min(torch.gather(d2, -1, idx), 0.0))
    return dist, idx


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Features (B, M, C) of the known points, their indices (B, N, 3) and
    weights (B, N, 3) -> (B, N, C) weighted sums."""
    return torch.einsum("bnkc,bnk->bnc", group_points(feats, idx), weight)


def interpolation_weights(dist: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights of `three_nn`'s distances, normalised over
    the last axis (the pointnet2 FP module's)."""
    recip = 1.0 / torch.clamp_min(dist, eps)
    return recip / recip.sum(dim=-1, keepdim=True)
