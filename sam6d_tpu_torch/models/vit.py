"""Vision Transformer backbone, timm/MAE layout.

Counterpart of `sam6d_tpu/models/vit.py`: PatchEmbed as a matmul with a
(p, p, C, D) kernel, exact-erf GELU, LayerNorm eps 1e-6 in float32, and
attention logits and softmax in float32.  Module names follow the JAX
parameter tree (`blocks_0.attn.qkv`, ...).  Channel-last images.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.layers import Dense, LayerNorm, f32_matmul
from sam6d_tpu_torch.ops.flash_rpe import flash_attention


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int, patch_size: int,
                 dtype=torch.float32):
        super().__init__()
        p = patch_size
        self.kernel = nn.Parameter(torch.zeros(p, p, in_ch, embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.patch_size = p
        self.dtype = dtype

    def forward(self, img):
        """(B, H, W, C) -> (B, H/p, W/p, D)."""
        B, H, W, C = img.shape
        p = self.patch_size
        x = img.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, H // p, W // p, p * p * C).to(self.dtype)
        k = self.kernel.reshape(p * p * C, -1).to(self.dtype)
        return x @ k + self.bias.to(self.dtype)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """use_flash: the online-softmax kernel K5 (`ops/flash_rpe.py`)
    instead of the materialized (B, H, N, N) attention; the same function
    (on the CPU the wrapper computes the materialized form)."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 use_flash: bool = False):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.num_heads = num_heads
        self.use_flash = use_flash

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, N, hd)
        if self.use_flash:
            def flat(t):
                return t.reshape(B * H, N, hd).contiguous()

            out = flash_attention(flat(q), flat(k), flat(v))
            out = out.reshape(B, H, N, hd).transpose(1, 2).reshape(B, N, C)
            return self.proj(out)
        attn = f32_matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Encoder returning the final-norm'd outputs of blocks
    [d-1, d-n-1, d-2n-1, d-3n-1] (n = d // 4), ascending."""

    def __init__(self, patch_size=16, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, img_size=224, dtype=torch.float32):
        super().__init__()
        n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        for i in range(depth):
            self.add_module(f"blocks_{i}",
                            ViTBlock(embed_dim, num_heads, mlp_ratio, dtype))
        self.norm = LayerNorm(embed_dim, dtype)
        self.depth = depth
        self.embed_dim = embed_dim
        self.dtype = dtype

    def forward(self, x, out_indices: Sequence[int] | None = None):
        """x (B, H, W, 3) -> list of (B, 1 + N_patches, D) taps."""
        B = x.shape[0]
        x = self.patch_embed(x).reshape(B, -1, self.embed_dim)
        # The float32 cls token promotes the concat, as jnp.concatenate
        # does; the sum with pos_embed returns to the compute dtype.
        cls = self.cls_token.expand(B, -1, -1)
        x = (torch.cat([cls, x.float()], dim=1) + self.pos_embed).to(self.dtype)
        if out_indices is None:
            n = self.depth // 4
            out_indices = sorted(self.depth - 1 - i * n for i in range(4))
        taps = []
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
            if i in out_indices:
                taps.append(self.norm(x))
        return taps
