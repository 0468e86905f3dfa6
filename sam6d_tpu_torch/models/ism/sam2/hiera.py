"""SAM 2's image encoder: the Hiera trunk and the FPN neck.

Port of sam2/modeling/backbones/hieradet.py (Hiera :170,
MultiScaleBlock :94, MultiScaleAttention :41) and image_encoder.py
(ImageEncoder :14, FpnNeck :44) for the image path, channel-last.
Module names follow the released checkpoint (`trunk.blocks.{i}.attn.qkv`,
`neck.convs.{j}.conv`, ...); the convolutions keep flax-layout kernels
(kh, kw, in, out) as the port's other convolutions do, and the 1 x 1
ones are Dense layers (a converter transposes and reshapes).

A block: shortcut = x; x = LN1(x); where the width changes, shortcut =
maxpool2x2(proj(x)); attention in windows of the block's size (0:
global), q max-pooled 2 x 2 in the pooling blocks; x = shortcut +
attention; x = x + MLP(LN2(x)).  Every block's attention runs through
`ops/flash_rpe.flash_attention` (K5 on the card at head width 72, its
plain version on the CPU).  qkv is one product over the whole token map
(it is pointwise, so cutting windows before or after it is the same);
one copy then cuts k and v into windows and heads, and one cuts the
(pooled) q: pooling q 2 x 2 inside each window is pooling the map, as
every window side is even.  LayerNorm eps 1e-6 and GELU (erf), as
published.  The neck's sine position encodings feed only SAM 2's video
memory and are not computed.

Spans (`utils/timer.stage`, recorded while spans are): `hiera.stage1` ..
`hiera.stage4` around each stage's blocks (`sam2/model.py` opens
`sam2.neck` around the neck and the decoder's 1 x 1 convolutions); counters
`hiera.attn_rows_window`, `hiera.attn_rows_pooled`,
`hiera.attn_rows_global` (query rows x heads a K5 call served, by the
block's kind) and `hiera.attn_rows_plain` (rows of the plain version).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.layers import Dense, LayerNorm
from sam6d_tpu_torch.ops.flash_rpe import flash_attention
from sam6d_tpu_torch.utils.timer import count, stage


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 max pooling, stride 2, of a (B, H, W, C) map (nn.MaxPool2d(2,
    2) on the channel-first map; H and W even)."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax((2, 4))


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of a (B, H, W, C) map."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


class PatchEmbed(nn.Module):
    """Conv2d(3, embed_dim, 7, stride 4, padding 3), channel-last out."""

    cast_with_dense = True

    def __init__(self, embed_dim: int, kernel: int = 7, stride: int = 4,
                 padding: int = 3, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, 3, embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        """(B, S, S, 3) -> (B, S / 4, S / 4, embed_dim)."""
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2), w,
                     self.bias.to(self.dtype), stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)


class MLP(nn.Module):
    """sam2_utils.MLP with two layers and GELU: `layers.0`, `layers.1`."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([Dense(dim, hidden, dtype=dtype),
                                     Dense(hidden, dim, dtype=dtype)])

    def forward(self, x):
        return self.layers[1](F.gelu(self.layers[0](x)))


class MultiScaleAttention(nn.Module):
    """qkv and proj of a block (the attention itself is the block's)."""

    def __init__(self, dim: int, dim_out: int, dtype=torch.float32):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim_out, dtype=dtype)
        self.proj = Dense(dim_out, dim_out, dtype=dtype)


def _windows(x: torch.Tensor, wh: int, ww: int, heads: int) -> torch.Tensor:
    """(B, H, W, [S,] heads * hd) -> (S, B * nw * heads, wh * ww, hd) (S
    stacked tensors, or none): windows of wh x ww in row-major order, each
    window's heads adjacent."""
    stacked = x.dim() == 5
    if not stacked:
        x = x[..., None, :]
    B, H, W, S, C = x.shape
    hd = C // heads
    x = x.reshape(B, H // wh, wh, W // ww, ww, S, heads, hd)
    x = x.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(S, -1, wh * ww, hd)
    x = x.contiguous()  # the one copy (a view where a window is the map)
    return x if stacked else x[0]


def _unwindow(x: torch.Tensor, B: int, H: int, W: int, wh: int, ww: int,
              heads: int) -> torch.Tensor:
    """The inverse of `_windows` for one tensor: (B * nw * heads, wh * ww,
    hd) -> (B, H, W, heads * hd)."""
    hd = x.shape[-1]
    x = x.reshape(B, H // wh, W // ww, heads, wh, ww, hd)
    return x.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, heads * hd)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 window_size: int, q_pool: bool, mlp_ratio: float = 4.0,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = MultiScaleAttention(dim, dim_out, dtype)
        self.norm2 = LayerNorm(dim_out, dtype)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dtype)
        if dim != dim_out:
            self.proj = Dense(dim, dim_out, dtype=dtype)
        self.dim, self.dim_out = dim, dim_out
        self.num_heads, self.window_size, self.q_pool = (num_heads,
                                                         window_size, q_pool)
        self.kind = ("pooled" if q_pool else
                     "global" if window_size == 0 else "window")

    def forward(self, x):
        """x (B, H, W, dim) -> (B, H', W', dim_out), halved in a pooling
        block."""
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_pool:
                shortcut = max_pool2(shortcut)
        B, H, W, _ = x.shape
        ws = self.window_size
        wh, ww = (ws, ws) if ws > 0 else (H, W)
        pad_h, pad_w = (-H) % wh, (-W) % ww
        if pad_h or pad_w:  # as window_partition pads the normed map
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        qkv = self.attn.qkv(x).reshape(B, Hp, Wp, 3, self.dim_out)
        q = qkv[..., 0, :]
        kv = _windows(qkv[..., 1:, :], wh, ww, self.num_heads)
        if self.q_pool:
            q = max_pool2(q)
            Hp, Wp, wh, ww = Hp // 2, Wp // 2, wh // 2, ww // 2
        q = _windows(q, wh, ww, self.num_heads)
        kind = "plain" if q.device.type == "cpu" else self.kind
        count(f"hiera.attn_rows_{kind}", q.shape[0] * q.shape[1])
        out = flash_attention(q, kv[0], kv[1])
        out = _unwindow(out, B, Hp, Wp, wh, ww, self.num_heads)
        Ho, Wo = shortcut.shape[1:3]
        x = shortcut + self.attn.proj(out[:, :Ho, :Wo])
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    """The trunk: patch embedding, position embedding, the blocks; the
    outputs of the four stages, high resolution first."""

    def __init__(self, embed_dim: int = 144, num_heads: int = 2,
                 stages: Sequence[int] = (2, 6, 36, 4),
                 global_att_blocks: Sequence[int] = (23, 33, 43),
                 window_spec: Sequence[int] = (8, 4, 16, 8),
                 window_pos_embed_bkg_spatial_size: Sequence[int] = (7, 7),
                 q_pool: int = 3, dim_mul: float = 2.0, head_mul: float = 2.0,
                 dtype=torch.float32):
        super().__init__()
        depth = sum(stages)
        self.stage_ends = [sum(stages[:i]) - 1
                           for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:q_pool]
        self.patch_embed = PatchEmbed(embed_dim, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, embed_dim, *window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, embed_dim, window_spec[0], window_spec[0]))
        blocks, cur = [], 1
        for i in range(depth):
            dim_out = embed_dim
            # The first block of a stage keeps the previous stage's window.
            window = 0 if i in global_att_blocks else window_spec[cur - 1]
            if i - 1 in self.stage_ends:
                dim_out = int(embed_dim * dim_mul)
                num_heads = int(num_heads * head_mul)
                cur += 1
            blocks.append(MultiScaleBlock(embed_dim, dim_out, num_heads,
                                          window, i in q_pool_blocks,
                                          dtype=dtype))
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.channel_list = [self.blocks[i].dim_out
                             for i in self.stage_ends[::-1]]
        self.dtype = dtype

    def pos_embed_at(self, h: int, w: int) -> torch.Tensor:
        """(1, h, w, C) float32: the background table resized bicubically
        to the token grid, plus the window table tiled over it."""
        pe = F.interpolate(self.pos_embed.float(), size=(h, w),
                           mode="bicubic")
        win = self.pos_embed_window.float()
        pe = pe + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        return pe.permute(0, 2, 3, 1)

    def forward(self, x):
        """x (B, S, S, 3) -> [(B, S/4, S/4, C), (B, S/8, S/8, 2C), (B,
        S/16, S/16, 4C), (B, S/32, S/32, 8C)]."""
        x = self.patch_embed(x)
        x = (x + self.pos_embed_at(*x.shape[1:3])).to(self.dtype)
        outs, start = [], 0
        for s, end in enumerate(self.stage_ends):
            with stage(None, f"hiera.stage{s + 1}"):
                for i in range(start, end + 1):
                    x = self.blocks[i](x)
            outs.append(x)
            start = end + 1
        return outs


class FpnNeckConv(nn.Module):
    """One lateral 1 x 1 convolution (`convs.{j}.conv`)."""

    def __init__(self, dim: int, d_model: int, dtype=torch.float32):
        super().__init__()
        self.conv = Dense(dim, d_model, dtype=dtype)


class FpnNeck(nn.Module):
    """Lateral 1 x 1 convolutions to d_model; top-down (nearest 2x, summed)
    into the levels `fpn_top_down_levels`, lowest resolution first."""

    def __init__(self, d_model: int, backbone_channel_list: Sequence[int],
                 fpn_top_down_levels: Sequence[int] = (2, 3),
                 dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([FpnNeckConv(c, d_model, dtype)
                                    for c in backbone_channel_list])
        self.fpn_top_down_levels = tuple(fpn_top_down_levels)

    def forward(self, xs):
        """xs: the trunk's outputs, high resolution first -> the same
        levels at d_model channels."""
        n = len(self.convs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i].conv(xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                prev = lateral + upsample2(prev)
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    """Trunk and neck; `scalp` lowest-resolution levels dropped."""

    def __init__(self, trunk: Hiera, neck: FpnNeck, scalp: int = 1):
        super().__init__()
        self.trunk = trunk
        self.neck = neck
        self.scalp = scalp

    def forward(self, x):
        """x (B, S, S, 3) -> the neck's levels, high resolution first."""
        return self.levels(self.trunk(x))

    def levels(self, feats):
        """The neck on the trunk's outputs, less the scalp."""
        out = self.neck(feats)
        return out[:len(out) - self.scalp]
