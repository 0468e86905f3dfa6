"""Radius-normalised point clouds and the fine-stage positional encoding's
ball-query indices on them, shared by the CPU tests, the card tests and
`chip_smoke.py` (each loads this file by its path)."""

import numpy as np
import torch

from sam6d_tpu_torch.ops.geometry import pairwise_distance
from sam6d_tpu_torch.ops.pointcloud import ball_query_from_d2


def synthetic_clouds(B, N, seed=0):
    """(B, N, 3) float32 clouds drawn as `SyntheticPoseDataset` draws an
    observed cloud: N picks, with 1 mm noise, from a random object of 256
    points about 5 cm across; each divided by its object's radius, as the
    PEM normalises its clouds (`models/pem/model.py:_radius`)."""
    rng = np.random.RandomState(seed)
    out = np.empty((B, N, 3), np.float32)
    for b in range(B):
        obj = rng.randn(256, 3).astype(np.float32)
        obj *= 0.05 / np.abs(obj).max()
        pts = obj[rng.randint(0, 256, N)] + 0.001 * rng.randn(N, 3)
        out[b] = pts / np.linalg.norm(obj, axis=1).max()
    return out


def ball_query_rows(pts, radius, nsample):
    """The positional encoding's neighbour indices for (B, N, 3) points, as
    its gather's backward sees them: (B, N * nsample) int64 on pts'
    device."""
    d2 = pairwise_distance(pts, pts)
    return ball_query_from_d2(d2, radius, nsample).reshape(pts.shape[0], -1)


def hits(idx, n_targets):
    """Rows a target, (B, N) int64: how skewed the indices are."""
    counts = torch.zeros(idx.shape[0], n_targets + 1, dtype=torch.long,
                         device=idx.device)
    key = torch.where((idx >= 0) & (idx < n_targets), idx, n_targets)
    counts.scatter_add_(1, key, torch.ones_like(key))
    return counts[:, :-1]
