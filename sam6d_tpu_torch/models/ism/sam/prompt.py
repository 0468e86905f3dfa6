"""SAM prompt encoder: point, box and dense-mask prompts.

Counterpart of `sam6d_tpu/models/ism/sam/prompt.py` (reference
segment_anything/modeling/prompt_encoder.py :16): random-Fourier
positional encoding of the point and box-corner coordinates plus learned
point-type embeddings, the dense positional encoding of the embedding
grid, the no-mask dense embedding, and the mask-downscaling stack
(Conv 2x2/2 -> LayerNorm2d -> GELU twice, then a 1x1 conv) for
SamPredictor-style mask prompts.  The automatic mask generator uses the
point path only; `SAM.decode_prompts` takes them all.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.ism.sam.encoder import LayerNorm2d
from sam6d_tpu_torch.models.layers import Dense


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, num_pos_feats))

    def forward(self, coords_normalized: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2, (..., 2) -> (..., 2 * num_pos_feats)."""
        coords = 2.0 * coords_normalized - 1.0
        coords = coords @ self.positional_encoding_gaussian_matrix
        coords = 2.0 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class Conv2x2Down(nn.Module):
    """Conv2d(kernel 2, stride 2): the 2x2 windows do not overlap, so it
    is a matmul 4*C -> features over the blocks, whose channels nest
    (dy, dx, c).  Kernel (2, 2, C, features), computed in `dtype`."""

    def __init__(self, in_ch: int, features: int, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, in_ch, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x):
        B, H, W, C = x.shape
        xb = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        xb = xb.reshape(B, H // 2, W // 2, 4 * C).to(self.dtype)
        k = self.kernel.reshape(4 * C, -1).to(self.dtype)
        return xb @ k + self.bias.to(self.dtype)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16, dtype=torch.float32):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2/3: box corners.
        for i in range(4):
            setattr(self, f"point_embed_{i}",
                    nn.Parameter(torch.zeros(1, embed_dim)))
        self.not_a_point_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, embed_dim))
        # The reference's mask_downscaling Sequential, indices 0/1/3/4/6.
        c = mask_in_chans
        self.mask_downscaling_0 = Conv2x2Down(1, c // 4, dtype)
        self.mask_downscaling_1 = LayerNorm2d(c // 4)
        self.mask_downscaling_3 = Conv2x2Down(c // 4, c, dtype)
        self.mask_downscaling_4 = LayerNorm2d(c)
        self.mask_downscaling_6 = Dense(c, embed_dim, dtype=dtype)
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size

    def _input_size(self, ref: torch.Tensor) -> torch.Tensor:
        return ref.new_tensor([self.input_image_size[1],
                               self.input_image_size[0]])

    def encode_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool = True) -> torch.Tensor:
        """points (B, N, 2) pixel coords, labels (B, N) in {-1, 0, 1} ->
        (B, N + 1, D) sparse embeddings (a "not a point" appended when
        pad, as SAM does without a box prompt), or (B, N, D)."""
        B = points.shape[0]
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(B, 1, 2)], dim=1)
            labels = torch.cat([labels, labels.new_full((B, 1), -1)], dim=1)
        pe = self.pe_layer(points / self._input_size(points))
        lab = labels[..., None]
        pe = torch.where(lab == -1, 0.0, pe)
        return (pe + (lab == -1) * self.not_a_point_embed
                + (lab == 0) * self.point_embed_0
                + (lab == 1) * self.point_embed_1)

    def dense_pe(self) -> torch.Tensor:
        """(1, h, w, D) positional encoding of the image-embedding grid."""
        h, w = self.image_embedding_size
        dev = self.no_mask_embed.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.pe_layer(torch.stack([gx, gy], dim=-1))[None]

    def no_mask_dense(self, B: int) -> torch.Tensor:
        h, w = self.image_embedding_size
        return self.no_mask_embed.reshape(1, 1, 1, -1).expand(
            B, h, w, self.embed_dim)

    def encode_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (B, 4) xyxy pixel coords -> (B, 2, D) corner embeddings
        (reference prompt_encoder._embed_boxes)."""
        coords = boxes.reshape(-1, 2, 2) + 0.5
        pe = self.pe_layer(coords / self._input_size(coords))
        return pe + torch.cat([self.point_embed_2, self.point_embed_3])[None]

    def encode_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (B, 4h, 4w, 1) low-resolution mask logits -> (B, h, w, D)
        dense embeddings."""
        x = F.gelu(self.mask_downscaling_1(self.mask_downscaling_0(masks)))
        x = F.gelu(self.mask_downscaling_4(self.mask_downscaling_3(x)))
        return self.mask_downscaling_6(x)

    def forward(self, points, labels, boxes=None, masks=None):
        """The full prompt set (reference PromptEncoder.forward) -> (sparse
        (B, N', D): the points, padded only without boxes, then the box
        corners; dense: the mask embedding (B, h, w, D), or the no-mask
        embedding at batch 1, which the decoder broadcasts; the dense
        positional encoding (1, h, w, D))."""
        sparse = self.encode_points(points, labels, pad=boxes is None)
        if boxes is not None:
            sparse = torch.cat([sparse, self.encode_boxes(boxes)], dim=1)
        dense = (self.encode_masks(masks) if masks is not None
                 else self.no_mask_dense(1))
        return sparse, dense, self.dense_pe()
