"""PEM feature extraction: MAE ViT pyramid features -> per-pixel features
gathered at the observed / template pixels.

Counterpart of `sam6d_tpu/models/pem/feature_extraction.py` with the
linear upscaling head.  `choose` indexes the row-major flattened H*W
pixel grid of the crop.
"""

from __future__ import annotations

import torch
from torch import nn

from sam6d_tpu_torch.config import ViTConfig
from sam6d_tpu_torch.models.layers import Dense
from sam6d_tpu_torch.models.vit import ViT
from sam6d_tpu_torch.ops.fps import sample_pts_feats
from sam6d_tpu_torch.ops.pointcloud import batched_row_gather


class ViTAE(nn.Module):
    """ViT backbone + linear head: each patch token predicts a 4x4 grid
    of out_dim pixels (reference feature_extraction.py:109-112)."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        if cfg.up_type != "linear":
            raise NotImplementedError(f"up_type {cfg.up_type}")
        self.cfg = cfg
        self.vit = ViT(cfg.patch_size, cfg.embed_dim, cfg.depth,
                       cfg.num_heads, cfg.mlp_ratio, cfg.img_size, dtype,
                       remat=cfg.remat)
        n_taps = 4 if cfg.use_pyramid_feat else 1
        self.output_upscaling = Dense(n_taps * cfg.embed_dim,
                                      16 * cfg.out_dim, dtype=dtype)

    def forward(self, x):
        """x (B, H, W, 3) -> ((B, 4H/p, 4W/p, out_dim) map, (B, D) cls).

        The map is the pre-resize one: callers gather it with folded
        bilinear weights (ViTEncoder.get_img_feats)."""
        cfg = self.cfg
        B, H = x.shape[:2]
        taps = self.vit(x)
        cls_tokens = taps[-1][:, 0, :]
        patch_taps = [t[:, 1:, :] for t in taps]
        feats = (torch.cat(patch_taps, dim=-1) if cfg.use_pyramid_feat
                 else patch_taps[-1])
        hp = H // cfg.patch_size
        y = self.output_upscaling(feats)
        y = y.reshape(B, hp, hp, 4, 4, cfg.out_dim).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, hp * 4, hp * 4, cfg.out_dim), cls_tokens


class ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig, npoint: int = 2048,
                 dtype=torch.float32):
        super().__init__()
        self.rgb_net = ViTAE(cfg, dtype)
        self.npoint = npoint

    def forward(self, pts, rgb, rgb_choose, dense_po, dense_fo):
        """Observed-crop branch and radius normalisation (reference
        feature_extraction.py:133-136): pts (B, N, 3), rgb (B, S, S, 3),
        rgb_choose (B, N), template cloud dense_po (B, M, 3) and features
        dense_fo (B, M, C) -> (dense_pm, dense_fm, dense_po, dense_fo,
        radius), the clouds divided by the template radius + 1e-6."""
        dense_fm = self.get_img_feats(rgb, rgb_choose)
        radius = torch.linalg.vector_norm(dense_po, dim=2).amax(dim=1)
        denom = radius[:, None, None] + 1e-6
        return pts / denom, dense_fm, dense_po / denom, dense_fo, radius

    def get_img_feats(self, rgb, choose):
        """Per-pixel features (B, N, C) at `choose` (B, N), as a bilinear
        upscale of the 4x-per-patch map to the crop size followed by a
        gather: the 4 source neighbours of each chosen pixel are gathered
        and blended with the resize weights (half-pixel centres,
        edge-clamped, as jax.image.resize 'bilinear')."""
        feat, _ = self.rgb_net(rgb)
        B, g, _, C = feat.shape
        H, W = rgb.shape[1:3]
        row = torch.div(choose, W, rounding_mode="floor")
        col = choose % W

        def axis_weights(q, size_out):
            c = (q.float() + 0.5) * (g / size_out) - 0.5
            c = torch.clamp(c, 0.0, g - 1.0)
            c0 = torch.floor(c)
            i0 = c0.long()
            return i0, torch.clamp_max(i0 + 1, g - 1), (c - c0).to(feat.dtype)

        y0, y1, wy = axis_weights(row, H)
        x0, x1, wx = axis_weights(col, W)
        idx4 = torch.stack(
            [y0 * g + x0, y0 * g + x1, y1 * g + x0, y1 * g + x1], dim=-1
        )
        w4 = torch.stack(
            [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx],
            dim=-1,
        )
        gathered = batched_row_gather(feat.reshape(B, g * g, C), idx4)
        return torch.matmul(w4[..., None, :], gathered)[..., 0, :]

    def get_obj_feats(self, tem_rgb, tem_pts, tem_choose):
        """Template views (T, H, W, 3), (T, Np, 3), (T, Np) -> FPS'd
        (1, npoint, 3) points and (1, npoint, C) features."""
        feat = self.get_img_feats(tem_rgb, tem_choose)
        all_pts = tem_pts.reshape(1, -1, 3).contiguous()
        all_feat = feat.reshape(1, -1, feat.shape[-1])
        return sample_pts_feats(all_pts, all_feat, self.npoint)
