"""Top-k with ties in `jax.lax.top_k`'s order.

`jax.lax.top_k` returns equal scores lowest index first; `torch.topk`
leaves their order unspecified, and on the CPU returns another one.  The
host NMS that follows breaks ties by input order, so the kept set
depends on it.  A stable descending sort keeps equal scores in index
order.
"""

from __future__ import annotations

import torch


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the min(k, n) largest entries along the last axis of
    `score`, largest first, equal scores lowest index first."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    return order[..., :k]
