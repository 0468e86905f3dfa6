"""Collectives with the backward each use needs, as autograd functions.

Megatron's pair around a tensor-parallel block: `copy_in` (identity
forward, all-reduce backward) where a replicated activation or parameter
enters the sharded computation, `reduce_out` (all-reduce forward,
identity backward) where the row-parallel partial sums leave it.
`all_reduce_sum` sums in both directions: for a sum of per-rank parts
that every rank then uses (BatchNorm moments over `dp`, vector norms
over `tp`), each rank's gradient of the shared sum is the sum of the
ranks' gradients.  Sums run in float32 and return the input's dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().float().contiguous().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceOut.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (n, ...) tensor stacked in rank order -> (size, n,
    ...) (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)
