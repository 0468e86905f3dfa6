"""Batched point-cloud geometry.

Counterpart of `sam6d_tpu/ops/geometry.py`
(reference utils/model_utils.py:101-153).  Coordinate contractions run
in float32; the package disables TF32 so they are full precision on the
card as well.
"""

from __future__ import annotations

import torch


def pairwise_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances between (*, N, C) and (*, M, C) -> (*, N, M),
    clamped at 0 (channel-last only)."""
    xy = torch.matmul(x, y.transpose(-1, -2))
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    return torch.clamp_min(x2[..., :, None] - 2.0 * xy + y2[..., None, :],
                           0.0)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, eps)


def compute_feature_similarity(feat1, feat2, sim_type: str = "cosine",
                               temp: float = 1.0,
                               normalize_feat: bool = True):
    """(B, N, C) x (B, M, C) -> (B, N, M) float32 similarity / temp."""
    if normalize_feat:
        feat1 = l2_normalize(feat1)
        feat2 = l2_normalize(feat2)
    if sim_type == "cosine":
        atten = torch.matmul(feat1, feat2.transpose(-1, -2))
    elif sim_type == "L2":
        atten = torch.sqrt(pairwise_distance(feat1, feat2))
    else:
        raise ValueError(f"unknown sim_type {sim_type}")
    # The pose solvers and their scores consume float32 attention.
    return atten.float() / temp
