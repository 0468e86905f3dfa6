"""Precomputed min-distance voxel field over a model point cloud.

Counterpart of `sam6d_tpu/ops/distance_field.py`: built once per object
at onboarding, it pre-scores coarse pose hypotheses by nearest-voxel
lookups instead of a (hypotheses, points, model points) reduction.
"""

from __future__ import annotations

import torch

FIELD_EXTENT = 1.2


def build_min_dist_field(points: torch.Tensor, resolution: int = 96,
                         chunk: int = 16384) -> torch.Tensor:
    """points (B, M, 3) -> (B, G, G, G) float32 distances, axes (x, y, z);
    voxel (i, j, k) is centred at -E + (idx + 0.5) * 2E / G, E =
    FIELD_EXTENT."""
    B = points.shape[0]
    G = resolution
    dev = points.device
    step = 2.0 * FIELD_EXTENT / G
    idx = torch.arange(G, dtype=torch.float32, device=dev)
    centers = -FIELD_EXTENT + (idx + 0.5) * step
    gx = centers.repeat_interleave(G * G)
    gy = centers.repeat_interleave(G).repeat(G)
    gz = centers.repeat(G * G)
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    p2 = px * px + py * py + pz * pz
    out = []
    for lo in range(0, G * G * G, chunk):
        cx, cy, cz = gx[lo:lo + chunk], gy[lo:lo + chunk], gz[lo:lo + chunk]
        # d2[b, v, m] = |c_v|^2 - 2 c_v . p_m + |p_m|^2, componentwise.
        cross = (cx[:, None] * px[:, None, :] + cy[:, None] * py[:, None, :]
                 + cz[:, None] * pz[:, None, :])
        c2 = cx * cx + cy * cy + cz * cz
        d2 = c2[None, :, None] - 2.0 * cross + p2[:, None, :]
        out.append(d2.amin(dim=-1))
    d2 = torch.cat(out, dim=1)
    return torch.sqrt(torch.clamp_min(d2, 0.0)).reshape(B, G, G, G)


def sample_min_dist(field: torch.Tensor, qx, qy, qz) -> torch.Tensor:
    """Nearest-voxel lookup of the field at query components (B, ...).

    Out-of-grid queries clamp to the boundary voxel plus their distance
    to the grid cube.  A (1, G, G, G) field is shared by every batch row.
    """
    B = qx.shape[0]
    Bf, G = field.shape[0], field.shape[1]
    if Bf not in (1, B):
        raise ValueError(
            f"field batch {Bf} must be 1 (shared) or match query batch {B}"
        )
    step = 2.0 * FIELD_EXTENT / G

    def to_idx(q):
        return torch.clamp(torch.floor((q + FIELD_EXTENT) / step).long(), 0,
                           G - 1)

    flat = (to_idx(qx) * G + to_idx(qy)) * G + to_idx(qz)
    vals = field.reshape(Bf, -1)
    gathered = torch.gather(vals.expand(B, -1), 1,
                            flat.reshape(B, -1)).reshape(qx.shape)

    def overshoot(q):
        return torch.clamp_min(torch.abs(q) - FIELD_EXTENT, 0.0)

    ox, oy, oz = overshoot(qx), overshoot(qy), overshoot(qz)
    return gathered + torch.sqrt(ox * ox + oy * oy + oz * oz)
