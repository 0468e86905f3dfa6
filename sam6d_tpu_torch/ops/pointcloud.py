"""Point-cloud gathers and ball query, channel-last.

Counterpart of `sam6d_tpu/ops/pointcloud.py`: features are (B, N, C) and
indices int64 tensors of any trailing shape.  `gather_neighbors` carries
its own backward (`ops/scatter_rows.py`).
"""

from __future__ import annotations

import torch

from sam6d_tpu_torch.ops.scatter_rows import scatter_rows


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
    N = d2.shape[-1]
    idx = _first_k_true(d2 < radius * radius, nsample)
    valid = idx < N
    first = torch.where(valid[..., :1], idx[..., :1],
                        torch.zeros_like(idx[..., :1]))
    return torch.where(valid, idx, first).long()
