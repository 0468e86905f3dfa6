"""Batched weighted Procrustes (rigid alignment by weighted 3x3 SVD).

Counterpart of `sam6d_tpu/ops/procrustes.py` (reference
utils/model_utils.py:343-455).  Returns (R, t) with
ref ~= src @ R^T + t.
"""

from __future__ import annotations

import torch

from sam6d_tpu_torch.ops.svd3 import svd3x3_soa


def weighted_procrustes(src_points, ref_points, weights=None,
                        weight_thresh: float = 0.0, eps: float = 1e-5):
    """src/ref (..., N, 3), weights (..., N) -> R (..., 3, 3), t (..., 3)."""
    src_points = src_points.float()
    ref_points = ref_points.float()
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], device=src_points.device)
    weights = torch.where(weights < weight_thresh,
                          torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]

    src_centroid = (src_points * w).sum(dim=-2)
    ref_centroid = (ref_points * w).sum(dim=-2)
    src_c = src_points - src_centroid[..., None, :]
    ref_c = ref_points - ref_centroid[..., None, :]
    ref_cw = ref_c * w

    h = [[(src_c[..., i] * ref_cw[..., j]).sum(dim=-1) for j in range(3)]
         for i in range(3)]
    (u1, u2, u3), _, (v1, v2, v3) = svd3x3_soa(h)

    def det_cols(c1, c2, c3):
        return (
            c1[0] * (c2[1] * c3[2] - c2[2] * c3[1])
            - c2[0] * (c1[1] * c3[2] - c1[2] * c3[1])
            + c3[0] * (c1[1] * c2[2] - c1[2] * c2[1])
        )

    d = torch.sign(det_cols(v1, v2, v3) * det_cols(u1, u2, u3))
    d = torch.where(d == 0, torch.ones_like(d), d)
    v3 = tuple(x * d for x in v3)

    # R = V U^T -> R[i][j] = v1_i u1_j + v2_i u2_j + v3_i u3_j.
    R_rows = [[v1[i] * u1[j] + v2[i] * u2[j] + v3[i] * u3[j]
               for j in range(3)] for i in range(3)]
    R = torch.stack([torch.stack(row, dim=-1) for row in R_rows], dim=-2)
    sc = [src_centroid[..., i] for i in range(3)]
    t = torch.stack([
        ref_centroid[..., i]
        - (R_rows[i][0] * sc[0] + R_rows[i][1] * sc[1] + R_rows[i][2] * sc[2])
        for i in range(3)
    ], dim=-1)
    return R, t
