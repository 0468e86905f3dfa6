"""Geometric structure embedding (GeoTransformer-style RPE tensors).

Counterpart of `sam6d_tpu/models/pem/geo_embedding.py` (reference
transformer.py:259-363): pairwise-distance and k-NN triplet-angle
sinusoidal embeddings, projected.  Three formulations:

* exact transcendentals (`*_cheb_terms = 0`);
* a Chebyshev expansion of every embedding column with the projection
  folded into a (P, d) matrix (`_cheb_proj`), the distance branch's bg
  sentinel row/col 0 overwritten with exact values;
* the fused kernel `ops/geo_embed.py` (Chebyshev bases + max over k in
  one pass), the sentinel fixed by an additive exact-minus-Chebyshev
  delta on row/col 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from sam6d_tpu_torch.config import GeoEmbeddingConfig
from sam6d_tpu_torch.models.layers import Dense
from sam6d_tpu_torch.ops.geometry import pairwise_distance
from sam6d_tpu_torch.ops.geo_embed import geo_embed_maxk
from sam6d_tpu_torch.ops.pointcloud import group_points


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


@functools.lru_cache(maxsize=8)
def _cheb_sinusoid_coeffs(P: int, d_model: int, hi: float) -> np.ndarray:
    """Chebyshev coefficients (P, d_model) of every embedding column over
    u in [0, hi], x = 2u/hi - 1, fit in float64 at Chebyshev-Gauss nodes."""
    nodes = np.cos(np.pi * (np.arange(512) + 0.5) / 512)
    u = (nodes + 1.0) * (hi / 2.0)
    div_indices = np.arange(0, d_model, 2).astype(np.float64)
    omegas = np.exp(div_indices * (-np.log(10000.0) / d_model))
    args = u[:, None] * omegas[None, :]
    cols = np.stack([np.sin(args), np.cos(args)], axis=-1).reshape(len(u),
                                                                  d_model)
    return np.polynomial.chebyshev.chebfit(nodes, cols, P - 1)


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

    def _fold(self, P: int, hi: float, layer: Dense) -> torch.Tensor:
        """(P, d) coefficient matrix with the projection folded in."""
        w = layer.weight
        coeffs = torch.as_tensor(_cheb_sinusoid_coeffs(P, w.shape[1], hi),
                                 dtype=torch.float32, device=w.device)
        return (coeffs @ w.float().t()).to(self.dtype)

    def _cheb_proj(self, idx, hi: float, P: int, layer: Dense):
        """Projected embedding of a bounded index field: a float32
        Chebyshev recurrence, the basis stacked in the compute dtype,
        times the folded (P, d) matrix."""
        M = self._fold(P, hi, layer)
        x = idx.float() * (2.0 / hi) - 1.0
        t_prev = torch.ones_like(x)
        t_cur = x
        terms = [t_prev.to(self.dtype), t_cur.to(self.dtype)]
        for _ in range(P - 2):
            t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
            terms.append(t_cur.to(self.dtype))
        T = torch.stack(terms, dim=-1)
        return T @ M + layer.bias.to(self.dtype)

    def _exact_proj(self, idx, layer: Dense):
        emb = sinusoidal_embedding(idx, layer.weight.shape[1])
        return layer(emb.to(self.dtype))

    def _fused_call(self, d_idx, a_idx):
        cfg = self.cfg
        hi_d, hi_a = cfg.dist_cheb_hi, 180.0 / cfg.sigma_a
        Pd, Pa = cfg.dist_cheb_terms, cfg.angle_cheb_terms
        Md = self._fold(Pd, hi_d, self.proj_d).contiguous()
        Ma = self._fold(Pa, hi_a, self.proj_a).contiguous()
        bias = (self.proj_d.bias.float() + self.proj_a.bias.float()).contiguous()
        out = geo_embed_maxk(
            torch.clamp_max(d_idx, hi_d).contiguous(), a_idx.contiguous(),
            Md, Ma, bias, hi_d, hi_a, self.dtype,
        )

        # Sentinel row/col 0: add exact-minus-Chebyshev distance deltas
        # (the (0, 0) corner only once, through the column).
        def delta(idx_slice):
            return (self._exact_proj(idx_slice, self.proj_d)
                    - self._cheb_proj(torch.clamp_max(idx_slice, hi_d), hi_d,
                                      Pd, self.proj_d)).to(out.dtype)

        row_delta = delta(d_idx[:, :1, :])  # (B, 1, N, d)
        col_delta = delta(d_idx[:, :, :1])  # (B, N, 1, d)
        row_delta[:, :, 0] = 0.0
        # In place on the kernel's output: legal under autograd because
        # its Function saves only its inputs for the backward (K3).
        out[:, :1, :] += row_delta
        out[:, :, :1] += col_delta
        return out

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """points (B, N, 3) -> embeddings (B, N, N, hidden_dim)."""
        cfg = self.cfg
        d_idx, a_idx = geometric_embedding_indices(
            points, cfg.sigma_d, cfg.sigma_a, cfg.angle_k
        )
        Pd, Pa = cfg.dist_cheb_terms, cfg.angle_cheb_terms
        # "auto" takes the fused kernel whenever the points lie on the
        # card, at every batch size.  (The JAX package's rule, B >= 8,
        # tunes for the TPU's 8-sublane blocks and means nothing here.)
        use_fused = (
            cfg.fused == "on"
            or (cfg.fused == "auto" and points.device.type == "cuda")
        ) and Pd and Pa and cfg.reduction_a == "max"
        if use_fused:
            return self._fused_call(d_idx, a_idx)
        if Pd:
            # Every real pair is inside the Chebyshev domain; only the bg
            # sentinel point (at 100) is not, so its row and column are
            # overwritten with exact values.
            hi_d = cfg.dist_cheb_hi
            d_emb = self._cheb_proj(torch.clamp_max(d_idx, hi_d), hi_d, Pd,
                                    self.proj_d)
            d_emb[:, :1, :] = self._exact_proj(d_idx[:, :1, :],
                                               self.proj_d).to(d_emb.dtype)
            d_emb[:, :, :1] = self._exact_proj(d_idx[:, :, :1],
                                               self.proj_d).to(d_emb.dtype)
        else:
            d_emb = self._exact_proj(d_idx, self.proj_d)
        if Pa:
            a_emb = self._cheb_proj(a_idx, 180.0 / cfg.sigma_a, Pa, self.proj_a)
        else:
            a_emb = self._exact_proj(a_idx, self.proj_a)
        if cfg.reduction_a == "max":
            a_emb = a_emb.amax(dim=3)
        else:
            a_emb = a_emb.mean(dim=3)
        return d_emb + a_emb
