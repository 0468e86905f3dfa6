"""Batched weighted Procrustes (rigid alignment by weighted 3x3 SVD).

Plain copy of `sam6d_tpu_torch/ops/procrustes.py` (SAM-6D
utils/model_utils.py:343-455).  Departure: the 3x3 SVD is
`torch.linalg.svd` in float64, where the port runs its own
structure-of-arrays Jacobi solve in float32.  `dtype` is the precision of
the centroids and the covariance: float32 (the covariance then in
float64), or the control's bfloat16.  Returns (R, t) with
ref ~= src @ R^T + t.
"""

from __future__ import annotations

import torch


def weighted_procrustes(src_points, ref_points, weights=None,
                        weight_thresh: float = 0.0, eps: float = 1e-5,
                        dtype: torch.dtype = torch.float32):
    """src/ref (..., N, 3), weights (..., N) -> R (..., 3, 3), t (..., 3)."""
    src = src_points.to(dtype)
    ref = ref_points.to(dtype)
    if weights is None:
        weights = torch.ones(src.shape[:-1], device=src.device)
    weights = weights.to(dtype)
    weights = torch.where(weights < weight_thresh,
                          torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]
    src_centroid = (src * w).sum(dim=-2)
    ref_centroid = (ref * w).sum(dim=-2)
    src_c = src - src_centroid[..., None, :]
    ref_cw = (ref - ref_centroid[..., None, :]) * w
    if dtype == torch.float32:
        H = src_c.double().transpose(-1, -2) @ ref_cw.double()
    else:
        H = (src_c.transpose(-1, -2) @ ref_cw).double()
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V) * torch.linalg.det(U))
    d = torch.where(d == 0, torch.ones_like(d), d)
    D = torch.ones(d.shape + (3,), dtype=d.dtype, device=d.device)
    D[..., 2] = d
    R = (V * D[..., None, :]) @ U.transpose(-1, -2)
    t = ref_centroid.double() - (R @ src_centroid.double()[..., None])[..., 0]
    return R.float(), t.float()
