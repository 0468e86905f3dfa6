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


def transform_points(pts: torch.Tensor, R: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
    """Rigid transform p' = R p + t of (..., N, 3) points by R (..., 3, 3)
    and t (..., 3)."""
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def inverse_transform_points(pts: torch.Tensor, R: torch.Tensor,
                             t: torch.Tensor) -> torch.Tensor:
    """Inverse rigid transform p' = R^T (p - t), the reference's
    `(pts - t) @ R` with points as row vectors (model_utils.py:267,
    fine_point_matching.py:45), R mapping the model frame to the camera
    frame."""
    return torch.einsum("...nj,...ji->...ni", pts - t[..., None, :], R)


def depth_to_pointcloud(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Metric depth (H, W) and intrinsics (3, 3) -> the organised (H, W, 3)
    float32 cloud (reference utils/data_utils.py:92-110)."""
    H, W = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xmap = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    ymap = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    z = depth.float()
    x = (xmap - cx) * z / fx
    y = (ymap - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def project_points(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., N, 3) and intrinsics (3, 3) -> (..., N, 2)
    (u, v) pixel coordinates."""
    homo = torch.einsum("ij,...nj->...ni", K, pts)
    return homo[..., :2] / torch.clamp_min(homo[..., 2:3], 1e-9)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim, eps: float = 1e-8):
    """Mean of `x` over `dim` counting only entries where mask != 0."""
    m = mask.to(x.dtype)
    return torch.sum(x * m, dim=dim) / (torch.sum(m, dim=dim) + eps)
