"""SAM prompt encoder: the point path of the automatic mask generator.

Counterpart of the point-prompt part of `sam6d_tpu/models/ism/sam/
prompt.py` (reference segment_anything/modeling/prompt_encoder.py :16):
random-Fourier positional encoding of the point coordinates plus learned
point-type embeddings, the dense positional encoding of the embedding
grid and the no-mask dense embedding.  Box and mask prompts
(`encode_boxes`, `encode_masks`) are not ported yet; the JAX tree's
`mask_downscaling_*` weights are therefore not loaded (`params.py`).
"""

from __future__ import annotations

import math

import torch
from torch import nn


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


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: tuple[int, int] = (64, 64),
                 input_image_size: tuple[int, int] = (1024, 1024)):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2/3: box corners.
        for i in range(4):
            setattr(self, f"point_embed_{i}",
                    nn.Parameter(torch.zeros(1, embed_dim)))
        self.not_a_point_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size

    def encode_points(self, points: torch.Tensor, labels: torch.Tensor,
                      pad: bool = True) -> torch.Tensor:
        """points (B, N, 2) pixel coords, labels (B, N) in {-1, 0, 1} ->
        (B, N + 1, D) sparse embeddings (a "not a point" appended when
        pad, as SAM does without a box prompt)."""
        B = points.shape[0]
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(B, 1, 2)], dim=1)
            labels = torch.cat([labels, labels.new_full((B, 1), -1)], dim=1)
        size = points.new_tensor([self.input_image_size[1],
                                  self.input_image_size[0]])
        pe = self.pe_layer(points / size)
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
