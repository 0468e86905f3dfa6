"""SAM 2.1 with the Hiera image encoder, image path only, plain.

Written from the published code (facebookresearch/sam2: modeling/
backbones/hieradet.py, image_encoder.py, sam/mask_decoder.py,
sam2_base.py forward_image, sam2_image_predictor.py set_image and
_predict, utils/transforms.py SAM2Transforms, automatic_mask_generator.py)
and sam2/configs/sam2.1/sam2.1_hiera_l.yaml, in float32 (TF32 off where
the caller turns it off), independent of the port's code: windows are
cut by reshape and permute before qkv, q is pooled inside each window by
`F.max_pool2d`, every attention is materialised, the upscaling
ConvTransposes run as `F.conv_transpose2d` on the spatial maps and the
high-resolution features are added there.  SAM's prompt encoder and
two-way transformer are the reference's own (`prompt.py`, `decoder.py`),
unedited; their parameter names, and those of this file, are the port's,
so one state dict loads into both.

Departures from the published code, each the port's too:
* LayerNorm eps 1e-6 in the two-way transformer (the port's, from the
  JAX package; SAM 2's nn.LayerNorm there takes 1e-5); Hiera's LayerNorms
  and LayerNorm2d are 1e-6 as published.
* The generator's statistics at the 256 x 256 logit grid: stability and
  boxes from the logits (`candidate_stats` on `candidate_logits`), which
  the program's K6 computes with the sigmoid-form GELU x sigmoid(1.702 x)
  for its selection only; the published generator thresholds masks
  resized to the frame.  Boxes take the port's exclusive max (xmax + 1)
  and a stability of 0 where no pixel clears threshold - offset (the
  published score divides 0 by 0 there).  The judge takes the program's
  selection as given, compares every candidate's statistics with this
  file's, and compares its kept masks, resized straight to the frame
  (`upscale_logits`, as postprocess_masks resizes them), with this file's
  candidates.
* The object-score head (`pred_obj_score_head`) is built and not
  evaluated: SAM2ImagePredictor discards its output.
* No video path: memory encoder, memory attention, object pointers.

`dtype` computes the networks in another precision (the judge's control:
bfloat16 with float8 Dense products, `layers.use_fp8`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.ism.bbox import pil_bilinear_resize
from portbench.reference.ism.decoder import MLP as TokenMLP
from portbench.reference.ism.decoder import ConvTranspose2x2, TwoWayTransformer
from portbench.reference.ism.encoder import (
    LayerNorm2d,
    window_partition,
    window_unpartition,
)
from portbench.reference.ism.prompt import PromptEncoder
from portbench.reference.layers import Dense, LayerNorm, fake_fp8

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HIERA_L = dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
               global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8),
               window_pos_embed_bkg_spatial_size=(7, 7))


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """hieradet.do_pool with nn.MaxPool2d(2, 2): (B, H, W, C) in and out."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """Conv2d(3, C, kernel 7, stride 4, padding 3); kernel (7, 7, 3, C)."""

    def __init__(self, embed_dim: int, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(7, 7, 3, embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.dtype = dtype
        self.fp8 = False

    def forward(self, x):
        w = self.kernel.to(self.dtype).permute(3, 2, 0, 1)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if self.fp8:
            x, w = fake_fp8(x), fake_fp8(w)
        y = F.conv2d(x, w, self.bias.to(self.dtype), stride=4, padding=3)
        return y.permute(0, 2, 3, 1)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([Dense(dim, hidden, dtype=dtype),
                                     Dense(hidden, dim, dtype=dtype)])

    def forward(self, x):
        return self.layers[1](F.gelu(self.layers[0](x)))


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool,
                 dtype=torch.float32):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim_out, dtype=dtype)
        self.proj = Dense(dim_out, dim_out, dtype=dtype)
        self.num_heads, self.q_pool, self.dtype = num_heads, q_pool, dtype

    def forward(self, x):
        """x (B, H, W, C): a batch of windows (or the whole map)."""
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1)
        q, k, v = torch.unbind(qkv, 2)
        if self.q_pool:
            q = max_pool_2x2(q.reshape(B, H, W, -1))
            H, W = q.shape[1:3]
            q = q.reshape(B, H * W, self.num_heads, -1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(q.shape[-1])
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (p @ v).transpose(1, 2).reshape(B, H, W, -1)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 window_size: int, q_pool: bool, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool,
                                        dtype)
        self.norm2 = LayerNorm(dim_out, dtype)
        self.mlp = MLP(dim_out, 4 * dim_out, dtype)
        if dim != dim_out:
            self.proj = Dense(dim, dim_out, dtype=dtype)
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.window_size, self.q_pool = window_size, q_pool

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = self.proj(x)
            if self.q_pool:
                shortcut = max_pool_2x2(shortcut)
        window = self.window_size
        H, W = x.shape[1:3]
        if window > 0:
            x, pad_hw = window_partition(x, window)
        x = self.attn(x)
        if self.q_pool:
            window = self.window_size // 2
            H, W = shortcut.shape[1:3]
            pad_hw = (H + (window - H % window) % window,
                      W + (window - W % window) % window)
        if self.window_size > 0:
            x = window_unpartition(x, window, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    def __init__(self, embed_dim, num_heads, stages, global_att_blocks,
                 window_spec, window_pos_embed_bkg_spatial_size,
                 dtype=torch.float32):
        super().__init__()
        self.stage_ends = [sum(stages[:i]) - 1
                           for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]][:3]
        self.patch_embed = PatchEmbed(embed_dim, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(
            1, embed_dim, *window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(
            1, embed_dim, window_spec[0], window_spec[0]))
        blocks, cur = [], 1
        for i in range(sum(stages)):
            dim_out = embed_dim
            window = window_spec[cur - 1]
            if i in global_att_blocks:
                window = 0
            if i - 1 in self.stage_ends:
                dim_out, num_heads = 2 * embed_dim, 2 * num_heads
                cur += 1
            blocks.append(MultiScaleBlock(embed_dim, dim_out, num_heads,
                                          window, i in q_pool_blocks, dtype))
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)
        self.channel_list = [self.blocks[i].dim_out
                             for i in self.stage_ends[::-1]]
        self.dtype = dtype

    def forward(self, x):
        x = self.patch_embed(x)
        h, w = x.shape[1:3]
        pos = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic")
        win = self.pos_embed_window
        pos = pos + win.tile([a // b for a, b in zip(pos.shape, win.shape)])
        x = (x + pos.permute(0, 2, 3, 1)).to(self.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


class NeckConv(nn.Module):
    def __init__(self, dim: int, d_model: int, dtype=torch.float32):
        super().__init__()
        self.conv = Dense(dim, d_model, dtype=dtype)


class FpnNeck(nn.Module):
    def __init__(self, d_model: int, backbone_channel_list,
                 dtype=torch.float32):
        super().__init__()
        self.convs = nn.ModuleList([NeckConv(c, d_model, dtype)
                                    for c in backbone_channel_list])
        self.fpn_top_down_levels = (2, 3)

    def forward(self, xs):
        n = len(self.convs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i].conv(xs[i])
            if i in self.fpn_top_down_levels and prev is not None:
                top = F.interpolate(prev.permute(0, 3, 1, 2).float(),
                                    scale_factor=2.0, mode="nearest")
                prev = lateral + top.permute(0, 2, 3, 1).to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    def __init__(self, trunk: Hiera, neck: FpnNeck):
        super().__init__()
        self.trunk = trunk
        self.neck = neck

    def forward(self, x):
        return self.neck(self.trunk(x))[:-1]  # scalp 1


def conv_transpose_2x2(x: torch.Tensor, up: ConvTranspose2x2):
    """nn.ConvTranspose2d(kernel 2, stride 2) on a (B, h, w, C) map with
    the (2, 2, C, O) kernel -> (B, 2h, 2w, O)."""
    w = up.kernel.to(up.dtype).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.to(up.dtype).permute(0, 3, 1, 2), w,
                           up.bias.to(up.dtype), stride=2)
    return y.permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    """SAM 2's mask decoder with `pred_obj_scores`, `pred_obj_scores_mlp`,
    `iou_prediction_use_sigmoid` and `use_high_res_features`."""

    def __init__(self, embed_dim: int = 256, dtype=torch.float32):
        super().__init__()
        T = 4
        c4, c8 = embed_dim // 4, embed_dim // 8
        self.obj_score_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.pred_obj_score_head = TokenMLP(embed_dim, embed_dim, 1, 3, dtype)
        self.iou_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.mask_tokens = nn.Parameter(torch.zeros(T, embed_dim))
        self.transformer = TwoWayTransformer(embed_dim=embed_dim, dtype=dtype)
        self.output_upscaling_0 = ConvTranspose2x2(embed_dim, c4, dtype)
        self.output_upscaling_1 = LayerNorm2d(c4)
        self.output_upscaling_3 = ConvTranspose2x2(c4, c8, dtype)
        for i in range(T):
            self.add_module(f"output_hypernetworks_mlps_{i}",
                            TokenMLP(embed_dim, embed_dim, c8, 3, dtype))
        self.iou_prediction_head = TokenMLP(embed_dim, 256, T, 3, dtype)
        self.conv_s0 = Dense(embed_dim, c8, dtype=dtype)
        self.conv_s1 = Dense(embed_dim, c4, dtype=dtype)
        self.num_tokens = T

    def predict(self, embedding, image_pe, sparse, dense, feat_s0, feat_s1):
        """-> ((B, 4, 4h, 4w) mask logits, (B, 4) IoUs, (B, 8, C) the
        transformer's output tokens)."""
        B = sparse.shape[0]
        out_tok = torch.cat([self.obj_score_token, self.iou_token,
                             self.mask_tokens], dim=0)
        tokens = torch.cat([out_tok[None].expand(B, -1, -1), sparse], dim=1)
        hs, keys = self.transformer(embedding + dense, image_pe, tokens)
        h, w = embedding.shape[1:3]
        src = keys.reshape(B, h, w, -1)
        up = conv_transpose_2x2(src, self.output_upscaling_0) + feat_s1
        up = F.gelu(self.output_upscaling_1(up))
        up = conv_transpose_2x2(up, self.output_upscaling_3) + feat_s0
        up = F.gelu(up)  # (B, 4h, 4w, C / 8)
        hyper = torch.stack([
            getattr(self, f"output_hypernetworks_mlps_{i}")(hs[:, 2 + i])
            for i in range(self.num_tokens)], dim=1)
        masks = torch.einsum("btc,byxc->btyx", hyper.float(), up.float())
        iou = torch.sigmoid(self.iou_prediction_head(hs[:, 1]))
        return masks, iou, hs


class SAM2(nn.Module):
    def __init__(self, img_size: int = 1024, dtype=torch.float32,
                 trunk_kwargs: dict | None = None, device="cuda"):
        super().__init__()
        sizes = dict(HIERA_L, **(trunk_kwargs or {}))
        trunk = Hiera(**sizes, dtype=dtype)
        self.image_encoder = ImageEncoder(
            trunk, FpnNeck(256, trunk.channel_list, dtype))
        emb = img_size // 16
        self.sam_prompt_encoder = PromptEncoder(256, (emb, emb),
                                                (img_size, img_size),
                                                dtype=dtype)
        self.sam_mask_decoder = MaskDecoder(256, dtype)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, 256))
        self.input_size = img_size
        self.dtype = dtype
        self.to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self.no_mem_embed.device

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        """SAM2Transforms: uint8 (H, W, 3) -> ToTensor, Resize((S, S)),
        Normalize -> (S, S, 3) float32."""
        S = self.input_size
        x = image.permute(2, 0, 1)[None].float() / 255.0
        x = F.interpolate(x, size=(S, S), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = x.new_tensor(IMAGENET_MEAN)[:, None, None]
        std = x.new_tensor(IMAGENET_STD)[:, None, None]
        return ((x[0] - mean) / std).permute(1, 2, 0)

    @torch.no_grad()
    def encode(self, image: torch.Tensor) -> dict:
        """(1, S, S, 3) -> {"embedding" (1, h, w, 256) with no_mem_embed,
        "feat_s1" (1, 2h, 2w, 64), "feat_s0" (1, 4h, 4w, 32)}."""
        s0, s1, top = self.image_encoder(image)
        dec = self.sam_mask_decoder
        return {"embedding": top + self.no_mem_embed.to(top.dtype),
                "feat_s1": dec.conv_s1(s1), "feat_s0": dec.conv_s0(s0)}

    @torch.no_grad()
    def decode_points(self, feats: dict, points):
        """points (B, 1, 2) in input coordinates, each a positive point ->
        (logits (B, 4, 4h, 4w), IoUs (B, 4), tokens (B, 8, C))."""
        pr = self.sam_prompt_encoder
        labels = torch.ones(points.shape[:2], dtype=torch.long,
                            device=points.device)
        sparse = pr.encode_points(points, labels)
        return self.sam_mask_decoder.predict(
            feats["embedding"], pr.dense_pe(), sparse, pr.no_mask_dense(1),
            feats["feat_s0"], feats["feat_s1"])


def prepare(sam: SAM2, image: np.ndarray, width: int):
    """The frame as the generator feeds SAM 2: pre-resized to `width`
    (SAM-6D's segmentor_width_size), then SAM2Transforms.  Returns
    (input (S, S, 3), (mid_h, mid_w) or (None, None))."""
    H, W = image.shape[:2]
    work = torch.from_numpy(np.ascontiguousarray(image)).to(sam.device)
    mid = (None, None)
    if width and width != W:
        mid = (int(width * H / W), width)
        work = pil_bilinear_resize(work, *mid)
    return sam.preprocess(work), mid


def grid_points(n_per_side: int, size: int, device) -> torch.Tensor:
    """The 32 x 32 grid (build_point_grid) in input coordinates: the
    points at the work size, mapped by transform_coords to S x / W and
    S y / H, which is the grid times S; (1, P, 2)."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    pts = np.stack([xs.flatten(), ys.flatten()], axis=-1).astype(np.float32)
    return torch.from_numpy(pts * np.float32(size)).to(device)[None]


@torch.no_grad()
def candidate_logits(sam: SAM2, feats: dict, points, points_per_batch: int):
    """Every prompt's three multimask logits (3P, 4h, 4w), prompt-major
    (multimask_output: masks 1-3), and the transformer's output tokens
    (P, 8, C)."""
    logits, tokens = [], []
    for b in range(0, points.shape[1], points_per_batch):
        p = points[0, b:b + points_per_batch][:, None, :]
        lg, _, hs = sam.decode_points(feats, p)
        logits.append(lg[:, 1:].float().reshape(-1, *lg.shape[-2:]))
        tokens.append(hs.float())
    return torch.cat(logits), torch.cat(tokens)


@torch.no_grad()
def candidate_stats(logits, threshold: float, offset: float,
                    upscale: float):
    """(K, h, w) logits -> each candidate's stability score (K,)
    (calculate_stability_score: pixels above threshold + offset over
    pixels above threshold - offset, 0 where neither has one) and box (K,
    4) (batched_mask_to_box of logits > threshold with the port's
    exclusive max, [xmin, ymin, xmax + 1, ymax + 1], zeros for an empty
    mask) times `upscale`, both at the logit grid."""
    hi = (logits > threshold + offset).sum((-2, -1)).float()
    lo = (logits > threshold - offset).sum((-2, -1)).float()
    stability = hi / lo.clamp_min(1.0)
    mask = logits > threshold
    ends = []
    for occupied in (mask.any(-1), mask.any(-2)):  # rows (y), columns (x)
        idx = torch.arange(occupied.shape[-1], device=logits.device)
        ends.append((torch.where(occupied, idx, occupied.shape[-1]).amin(-1),
                     torch.where(occupied, idx, -1).amax(-1) + 1))
    (y0, y1), (x0, x1) = ends
    boxes = torch.stack([x0, y0, x1, y1], -1).float() * upscale
    return stability, torch.where(mask.flatten(1).any(1)[:, None], boxes,
                                  0.0)


def upscale_logits(logits, out_h: int, out_w: int, mid_h=None, mid_w=None):
    """(K, h, w) logits -> (K, out_h, out_w) float32: postprocess_masks'
    bilinear resize to the work size, then (a pre-resized frame) to the
    frame."""
    x = logits.float()[:, None]
    if mid_h is not None:
        x = F.interpolate(x, size=(mid_h, mid_w), mode="bilinear",
                          align_corners=False)
    x = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False)
    return x[:, 0]
