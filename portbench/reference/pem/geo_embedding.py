"""Geometric structure embedding (GeoTransformer-style RPE tensors).

Plain copy of `sam6d_tpu_torch/models/pem/geo_embedding.py` (SAM-6D
transformer.py:259-363): pairwise-distance and k-NN triplet-angle
sinusoidal embeddings, projected, max over the k angles.  Departure: the
exact transcendentals throughout, where the port expands every column in
Chebyshev terms (`dist_cheb_terms`, `angle_cheb_terms`) and folds the
projection into them (its kernel K2 on the card).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from portbench.reference.config import GeoEmbeddingConfig
from portbench.reference.layers import Dense
from portbench.reference.ops.geometry import pairwise_distance
from portbench.reference.ops.pointcloud import group_points


def _div_term(d_model: int) -> np.ndarray:
    div_indices = np.arange(0, d_model, 2).astype(np.float32)
    return np.exp(div_indices * (-np.log(10000.0) / d_model))


def sinusoidal_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """Interleaved [sin, cos] embedding (reference transformer.py:269-285)."""
    div = torch.as_tensor(_div_term(d_model), dtype=indices.dtype,
                          device=indices.device)
    omegas = indices[..., None] * div
    emb = torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1)
    return emb.reshape(*indices.shape, d_model)


def geometric_embedding_indices(points, sigma_d: float, sigma_a: float,
                                angle_k: int):
    """points (B, N, 3) -> d_indices (B, N, N), a_indices (B, N, N, k)."""
    dist2 = pairwise_distance(points, points)
    d_indices = torch.sqrt(dist2) / sigma_d
    # k nearest neighbours excluding self; a stable sort breaks distance
    # ties towards the lower index, as lax.top_k does.
    knn_idx = torch.sort(dist2, dim=-1, stable=True).indices[:, :, 1:angle_k + 1]
    knn_points = group_points(points, knn_idx)  # (B, N, k, 3)
    ref = knn_points - points[:, :, None, :]  # (B, N, k, 3)
    anc = points[:, None, :, :] - points[:, :, None, :]  # (B, N, M, 3)

    def outer(rc, ac):  # (B, N, k), (B, N, M) -> (B, N, M, k)
        return ac[..., :, None] * rc[..., None, :]

    rx, ry, rz = ref[..., 0], ref[..., 1], ref[..., 2]
    ax, ay, az = anc[..., 0], anc[..., 1], anc[..., 2]
    cx = outer(ry, az) - outer(rz, ay)
    cy = outer(rz, ax) - outer(rx, az)
    cz = outer(rx, ay) - outer(ry, ax)
    sin_values = torch.sqrt(cx * cx + cy * cy + cz * cz)
    cos_values = torch.matmul(anc, ref.transpose(-1, -2))  # (B, N, M, k)
    eps = 1e-8
    sin_values = torch.clamp_min(sin_values, eps)
    cos_values = torch.clamp(cos_values, -1.0 + eps, 1.0 - eps)
    angles = torch.atan2(sin_values, cos_values)
    return d_indices, angles * (180.0 / (sigma_a * np.pi))


class GeometricStructureEmbedding(nn.Module):
    def __init__(self, cfg: GeoEmbeddingConfig, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_dim
        self.cfg = cfg
        self.dtype = dtype
        self.proj_d = Dense(d, d, dtype=dtype)
        self.proj_a = Dense(d, d, dtype=dtype)

    def _exact_proj(self, idx, layer: Dense):
        emb = sinusoidal_embedding(idx, layer.weight.shape[1])
        return layer(emb.to(self.dtype))

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points (B, N, 3) -> embeddings (B, N, N, hidden_dim)."""
        cfg = self.cfg
        d_idx, a_idx = geometric_embedding_indices(
            points, cfg.sigma_d, cfg.sigma_a, cfg.angle_k
        )
        d_emb = self._exact_proj(d_idx, self.proj_d)
        a_emb = self._exact_proj(a_idx, self.proj_a)
        if cfg.reduction_a == "max":
            a_emb = a_emb.amax(dim=3)
        else:
            a_emb = a_emb.mean(dim=3)
        return d_emb + a_emb
