"""SAM image encoder: ViT with windowed attention and the decomposed
relative-position bias.

Counterpart of `sam6d_tpu/models/ism/sam/encoder.py` (reference
segment_anything/modeling/image_encoder.py: ImageEncoderViT :17, Block
:119, Attention :185, add_decomposed_rel_pos :325).  Channel-last maps;
module names follow the JAX parameter tree.

Attention runs through `ops/flash_rpe.flash_rpe_attention` (K4) in
windowed and global blocks alike: the CUDA kernel on the card, its plain
version on the CPU.  Logits and softmax are float32 on both routes (the
JAX package's unfused XLA path runs them in the compute dtype).  Windows
pad the token grid with zero q, k and v (64 -> 70 at 14 x 14 windows);
the padded tokens take part in attention as real keys, as in SAM.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.layers import Dense, LayerNorm
from sam6d_tpu_torch.models.vit import PatchEmbed
from sam6d_tpu_torch.ops.flash_rpe import flash_rpe_attention


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B * nw, window, window, C), zero-padded."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)
    return x, (Hp, Wp)


def window_unpartition(x: torch.Tensor, window: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = x.shape[0] // ((Hp // window) * (Wp // window))
    x = x.reshape(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


class WindowAttention(nn.Module):
    """Attention over a (h, w) token grid with the decomposed rel-pos
    bias, optionally within window_size x window_size windows.  K4 takes
    the tables in the compute dtype: `cast_dense_weights` stores them so,
    and the forward's cast is then a no-op."""

    cast_with_dense = True

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 grid: tuple[int, int], dtype=torch.float32):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        h, w = (window_size, window_size) if window_size > 0 else grid
        hd = dim // num_heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, hd))
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.dtype = dtype

    def forward(self, x):
        """x (B, gh, gw, C) -> (B, gh, gw, C)."""
        B, gh, gw, C = x.shape
        H = self.num_heads
        hd = self.dim // H
        qkv = self.qkv(x)
        ws = self.window_size
        if ws > 0:
            qkv, pad_hw = window_partition(qkv, ws)
            h = w = ws
        else:
            h, w = gh, gw
        nB = qkv.shape[0]
        qkv = qkv.reshape(nB, h * w, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(nB * H, h * w, hd).contiguous() for t in qkv)
        out = flash_rpe_attention(q, k, v, self.rel_pos_h.to(q.dtype),
                                  self.rel_pos_w.to(q.dtype), (h, w))
        out = out.reshape(nB, H, h, w, hd).permute(0, 2, 3, 1, 4)
        out = out.reshape(nB, h, w, C)
        if ws > 0:
            out = window_unpartition(out, ws, pad_hw, (gh, gw))
        return self.proj(out)


class SAMBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 window_size: int, grid: tuple[int, int],
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, num_heads, window_size, grid, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp_lin1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype)
        self.mlp_lin2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp_lin2(F.gelu(self.mlp_lin1(self.norm2(x))))


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over the last axis (reference model_utils.py
    LayerNorm2d), eps 1e-6.  Float32 out: the JAX module's float32 weight
    promotes its output to float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.weight + self.bias


class Conv2d(nn.Module):
    """Bias-free stride-1 'same' convolution with a flax (kh, kw, C, O)
    kernel, channel-last in and out, computed in `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, size: int,
                 dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(size, size, in_ch, out_ch))
        self.dtype = dtype

    def forward(self, x):
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        pad = self.kernel.shape[0] // 2
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w, padding=pad)
        return y.permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16,
                 embed_dim: int = 1280, depth: int = 32, num_heads: int = 16,
                 mlp_ratio: float = 4.0, out_chans: int = 256,
                 window_size: int = 14,
                 global_attn_indexes: Sequence[int] = (7, 15, 23, 31),
                 dtype=torch.float32, flash: bool | None = None,
                 flash_windowed: bool | None = None):
        """`flash` and `flash_windowed` are taken for the JAX signature's
        sake (there they pick the Pallas kernel or XLA, tuned for TPU
        grids) and choose nothing here: every block runs K4 on the card
        and its plain version on the CPU."""
        super().__init__()
        g = img_size // patch_size
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, embed_dim))
        for i in range(depth):
            is_global = i in global_attn_indexes
            self.add_module(f"blocks_{i}", SAMBlock(
                embed_dim, num_heads, mlp_ratio,
                0 if is_global else window_size, (g, g), dtype))
        self.neck_0 = Conv2d(embed_dim, out_chans, 1, dtype)
        self.neck_1 = LayerNorm2d(out_chans)
        self.neck_2 = Conv2d(out_chans, out_chans, 3, dtype)
        self.neck_3 = LayerNorm2d(out_chans)
        self.depth = depth
        self.dtype = dtype

    def forward(self, x):
        """x (B, S, S, 3) -> (B, S/16, S/16, 256) float32 embedding."""
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        x = (x + self.pos_embed[:, :h, :w]).to(self.dtype)
        for i in range(self.depth):
            x = getattr(self, f"blocks_{i}")(x)
        x = self.neck_1(self.neck_0(x))
        return self.neck_3(self.neck_2(x))
