"""DINOv2 ViT and the descriptor heads of proposal/template matching.

Counterpart of `sam6d_tpu/models/ism/dinov2.py` (reference Instance_
Segmentation_Model/model/dinov2.py CustomDINOv2 :115-327 and model/
vision_transformer.py): LayerScale blocks, cls + patch tokens, and the
CLS (semantic) and masked-patch (appearance) descriptors from one
forward.  Module names follow the JAX parameter tree.

With `use_flash` (the default) the attention takes the flash kernel K5
(`ops/flash_rpe.py`) when the tensors lie on a CUDA device, and the
wrapper's materialized plain version on the CPU.  The JAX package never
uses flash here, for a reason of the TPU: at N = 257 its Pallas grid
degenerates into thousands of tiny programs.  On the card the kernel
keeps the (Q * 16, 257, 257) float32 logits (1.1 GB at a bucket of 256)
from existing.  K5 is forward-only, so a descriptor that is trained is
built with `use_flash=False`: the materialized, differentiable attention
on every device, as the JAX DinoBlock always computes it.
"""

from __future__ import annotations

import torch
from torch import nn

from sam6d_tpu_torch.config import DescriptorConfig
from sam6d_tpu_torch.models.layers import LayerNorm
from sam6d_tpu_torch.models.vit import Attention, MlpBlock, PatchEmbed
from sam6d_tpu_torch.ops.geometry import l2_normalize


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        # The float32 parameter is cast, not the activations, so the
        # residual stream stays in the compute dtype.
        return x * self.gamma.to(x.dtype)


class DinoBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, use_flash: bool = True):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype, use_flash=use_flash)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    """DINOv2-style ViT returning (cls token, patch tokens).  use_flash:
    K5 on the card (serving); False for training (see the module
    docstring)."""

    def __init__(self, patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                 mlp_ratio=4.0, img_size=224, dtype=torch.float32,
                 use_flash: bool = True):
        super().__init__()
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}",
                            DinoBlock(embed_dim, num_heads, mlp_ratio, dtype,
                                      use_flash))
        self.norm = LayerNorm(embed_dim, dtype)
        self.depth = depth
        self.embed_dim = embed_dim
        self.dtype = dtype

    def forward(self, x):
        """x (B, H, W, 3) -> ((B, D) cls, (B, N, D) patches)."""
        B = x.shape[0]
        x = self.patch_embed(x).reshape(B, -1, self.embed_dim)
        cls = self.cls_token.to(x.dtype).expand(B, -1, -1)
        x = (torch.cat([cls, x], dim=1) + self.pos_embed).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        x = self.norm(x)
        return x[:, 0], x[:, 1:]


def patch_validity_mask(masks: torch.Tensor, patch_size: int,
                        thresh: float = 0.5) -> torch.Tensor:
    """(B, H, W) pixel mask -> (B, hp * wp) patch validity by average
    pooling (reference dinov2.py:267)."""
    B, H, W = masks.shape
    hp, wp = H // patch_size, W // patch_size
    pooled = masks[:, :hp * patch_size, :wp * patch_size].float().reshape(
        B, hp, patch_size, wp, patch_size).mean(dim=(2, 4))
    return (pooled > thresh).reshape(B, hp * wp)


class DescriptorModel(nn.Module):
    """CLS (semantic) and masked-patch (appearance) descriptor heads over
    one DINOv2 forward; `vit` holds the JAX DescriptorModel's variables.
    use_flash=False for training (`DinoViT`)."""

    def __init__(self, cfg: DescriptorConfig, dtype=torch.float32,
                 use_flash: bool = True):
        super().__init__()
        self.cfg = cfg
        self.vit = DinoViT(patch_size=cfg.patch_size,
                           embed_dim=cfg.embed_dim, depth=cfg.depth,
                           num_heads=cfg.num_heads, img_size=cfg.image_size,
                           dtype=dtype, use_flash=use_flash)

    def compute_cls_and_patch(self, images: torch.Tensor,
                              masks: torch.Tensor):
        """(Q, S, S, 3) normalised images + (Q, S, S) masks -> (Q, D) CLS
        descriptors and (Q, Np, D) L2-normalised patch descriptors, zero
        at invalid patches (reference dinov2.py:176-189, 257-271)."""
        cls, patches = self.vit(images)
        valid = patch_validity_mask(masks, self.cfg.patch_size,
                                    self.cfg.validpatch_thresh)
        return cls, l2_normalize(patches) * valid[..., None]
