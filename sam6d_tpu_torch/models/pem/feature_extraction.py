"""PEM feature extraction: MAE ViT pyramid features -> per-pixel features
gathered at the observed / template pixels.

Counterpart of `sam6d_tpu/models/pem/feature_extraction.py`, with both
upscaling heads (`ViTConfig.up_type` "linear" and "deconv").  `choose`
indexes the row-major flattened H*W pixel grid of the crop.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.config import ViTConfig
from sam6d_tpu_torch.models.layers import Dense, LayerNorm
from sam6d_tpu_torch.models.vit import ViT
from sam6d_tpu_torch.ops.fps import sample_pts_feats
from sam6d_tpu_torch.ops.pointcloud import batched_row_gather


class ViTAE(nn.Module):
    """ViT backbone + an upscaling head from each patch token to a 4x4
    grid of out_dim pixels.

    * "linear" (reference feature_extraction.py:109-112): one Dense.
    * "deconv" (reference :66-74): ConvTranspose(k2 s2) -> LayerNorm2d ->
      GELU -> ConvTranspose(k2 s2).  A ConvTranspose with kernel =
      stride = 2 is a per-pixel Dense whose output holds the 2x2 block in
      its channels, so both stages stay in that block-channel form (the
      first nests (a, b, 2C), the second (c, d, C)) and one shuffle at the
      end puts pixel (a, b, c, d) of patch (i, j) at row i*4 + a*2 + c,
      column j*4 + b*2 + d, as the JAX package does."""

    def __init__(self, cfg: ViTConfig, dtype=torch.float32):
        super().__init__()
        if cfg.up_type not in ("linear", "deconv"):
            raise NotImplementedError(f"up_type {cfg.up_type}")
        self.cfg = cfg
        self.vit = ViT(cfg.patch_size, cfg.embed_dim, cfg.depth,
                       cfg.num_heads, cfg.mlp_ratio, cfg.img_size, dtype,
                       remat=cfg.remat)
        n_taps = 4 if cfg.use_pyramid_feat else 1
        d_in, C = n_taps * cfg.embed_dim, cfg.out_dim
        if cfg.up_type == "linear":
            self.output_upscaling = Dense(d_in, 16 * C, dtype=dtype)
        else:
            self.upscale_deconv1 = Dense(d_in, 4 * 2 * C, dtype=dtype)
            self.upscale_ln = LayerNorm(2 * C, dtype)
            self.upscale_deconv2 = Dense(2 * C, 4 * C, dtype=dtype)

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
        hp, C = H // cfg.patch_size, cfg.out_dim
        if cfg.up_type == "linear":
            y = self.output_upscaling(feats)
            y = y.reshape(B, hp, hp, 4, 4, C).permute(0, 1, 3, 2, 4, 5)
            return y.reshape(B, hp * 4, hp * 4, C), cls_tokens
        y = self.upscale_deconv1(feats).reshape(B, hp, hp, 2, 2, 2 * C)
        y = self.upscale_deconv2(F.gelu(self.upscale_ln(y)))
        # (i, j, a, b, c, d, C) -> rows i*4 + a*2 + c, cols j*4 + b*2 + d.
        y = y.reshape(B, hp, hp, 2, 2, 2, 2, C)
        y = y.permute(0, 1, 3, 5, 2, 4, 6, 7)
        return y.reshape(B, hp * 4, hp * 4, C), cls_tokens


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
