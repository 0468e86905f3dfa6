"""Farthest point sampling, plain PyTorch.

Copy of `sam6d_tpu_torch/ops/fps.py:fps_plain`, the function the port's
kernel K1 computes, and `sample_pts_feats`.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.pointcloud import gather_points


def fps_plain(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min selection; (B, N, 3) -> (B, npoint) int64.

    The first index is 0, the field starts at +inf, and argmax ties go
    to the lowest index.
    """
    B, N, _ = pts.shape
    pts = pts.float()
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    rows = torch.arange(B, device=pts.device)
    dists = torch.full((B, N), float("inf"), device=pts.device)
    out = torch.zeros((B, npoint), dtype=torch.long, device=pts.device)
    last = out[:, 0]
    for i in range(1, npoint):
        dx = px - px[rows, last][:, None]
        dy = py - py[rows, last][:, None]
        dz = pz - pz[rows, last][:, None]
        d2 = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, d2)
        last = torch.argmax(dists, dim=1)
        out[:, i] = last
    return out


def sample_pts_feats(pts, feats, npoint: int, return_index: bool = False):
    """FPS-downsample a cloud (B, N, 3) and its features (B, N, C)."""
    idx = fps_plain(pts, npoint)
    pts_s = gather_points(pts, idx)
    feats_s = gather_points(feats, idx)
    if return_index:
        return pts_s, feats_s, idx
    return pts_s, feats_s
