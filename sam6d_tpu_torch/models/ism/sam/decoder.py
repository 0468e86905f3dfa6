"""SAM mask decoder: two-way transformer and hypernetwork mask heads.

Counterpart of `sam6d_tpu/models/ism/sam/decoder.py` (reference
segment_anything/modeling/mask_decoder.py :16, transformer.py
TwoWayTransformer :16).  LayerNorms use flax's eps 1e-6.  The upscaling
ConvTransposes (kernel = stride = 2) are pointwise matmuls C -> 2*2*O
with torch ConvTranspose2d semantics (no spatial flip), and the 2 x 2
blocks stay flattened in the channel axis, nesting (dy, dx, feature),
until the single pixel shuffle at the end of `tail`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.ism.sam.encoder import LayerNorm2d
from sam6d_tpu_torch.models.layers import Dense, LayerNorm


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, dtype=torch.float32):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}",
                            Dense(dims[i], dims[i + 1], dtype=dtype))
        self.num_layers = num_layers

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class ConvTranspose2x2(nn.Module):
    """ConvTranspose(kernel=2, stride=2) as x @ K: (..., C) ->
    (..., 2*2*features), channel nesting (dy, dx, feature)."""

    def __init__(self, in_dim: int, features: int, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, in_dim, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def flat_kernel(self) -> torch.Tensor:
        C, O = self.kernel.shape[2:]
        return self.kernel.permute(2, 0, 1, 3).reshape(C, 4 * O)

    def forward(self, x):
        k = self.flat_kernel().to(self.dtype)
        return x.to(self.dtype) @ k + self.bias.repeat(4).to(self.dtype)


class CrossAttention(nn.Module):
    """Attention with optional channel downsampling.  q and k/v may carry
    batch sizes 1 and B: the singleton side broadcasts (the JAX module
    contracts it shared, with the same numbers)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1, dtype=torch.float32):
        super().__init__()
        internal = embed_dim // downsample_rate
        self.q_proj = Dense(embed_dim, internal, dtype=dtype)
        self.k_proj = Dense(embed_dim, internal, dtype=dtype)
        self.v_proj = Dense(embed_dim, internal, dtype=dtype)
        self.out_proj = Dense(internal, embed_dim, dtype=dtype)
        self.num_heads = num_heads
        self.internal = internal

    def forward(self, q, k, v):
        H = self.num_heads
        hd = self.internal // H

        def heads(t):  # (B, n, H * hd) -> (B, H, n, hd)
            return t.reshape(*t.shape[:-1], H, hd).transpose(-2, -3)

        qp, kp, vp = heads(self.q_proj(q)), heads(self.k_proj(k)), \
            heads(self.v_proj(v))
        # The JAX module divides by sqrt(hd) cast to the dtype of the
        # input q, which promotes bf16 logits when q is float32.
        attn = qp @ kp.transpose(-1, -2)
        attn = attn.to(torch.promote_types(attn.dtype, q.dtype))
        attn = torch.softmax(attn / math.sqrt(hd), dim=-1)
        out = (attn @ vp.to(attn.dtype)).transpose(-2, -3)
        return self.out_proj(out.reshape(*out.shape[:-2], self.internal))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8,
                 mlp_dim: int = 2048, skip_first_layer_pe: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.self_attn = CrossAttention(embed_dim, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(embed_dim, dtype)
        self.cross_attn_token_to_image = CrossAttention(
            embed_dim, num_heads, 2, dtype)
        self.norm2 = LayerNorm(embed_dim, dtype)
        self.mlp_lin1 = Dense(embed_dim, mlp_dim, dtype=dtype)
        self.mlp_lin2 = Dense(mlp_dim, embed_dim, dtype=dtype)
        self.norm3 = LayerNorm(embed_dim, dtype)
        self.cross_attn_image_to_token = CrossAttention(
            embed_dim, num_heads, 2, dtype)
        self.norm4 = LayerNorm(embed_dim, dtype)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        attn_out = self.cross_attn_token_to_image(
            queries + query_pe, keys + key_pe, keys)
        queries = self.norm2(queries + attn_out)
        mlp_out = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries + mlp_out)
        attn_out = self.cross_attn_image_to_token(
            keys + key_pe, queries + query_pe, queries)
        keys = self.norm4(keys + attn_out)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 256,
                 num_heads: int = 8, mlp_dim: int = 2048,
                 dtype=torch.float32):
        super().__init__()
        for i in range(depth):
            self.add_module(f"layers_{i}", TwoWayAttentionBlock(
                embed_dim, num_heads, mlp_dim, i == 0, dtype))
        self.final_attn_token_to_image = CrossAttention(
            embed_dim, num_heads, 2, dtype)
        self.norm_final_attn = LayerNorm(embed_dim, dtype)
        self.depth = depth

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding (Bk, h, w, C) with Bk in {1, B}, image_pe
        (1, h, w, C), point_embedding (B, N, C)."""
        Bk, h, w, C = image_embedding.shape
        keys = image_embedding.reshape(Bk, h * w, C)
        key_pe = image_pe.reshape(1, h * w, C)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(
                queries, keys, point_embedding, key_pe)
        attn_out = self.final_attn_token_to_image(
            queries + point_embedding, keys + key_pe, keys)
        return self.norm_final_attn(queries + attn_out), keys


class MaskDecoder(nn.Module):
    def __init__(self, embed_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 dtype=torch.float32):
        super().__init__()
        T = num_multimask_outputs + 1
        c4, c8 = embed_dim // 4, embed_dim // 8
        self.iou_token = nn.Parameter(torch.zeros(1, embed_dim))
        self.mask_tokens = nn.Parameter(torch.zeros(T, embed_dim))
        self.transformer = TwoWayTransformer(embed_dim=embed_dim, dtype=dtype)
        self.output_upscaling_0 = ConvTranspose2x2(embed_dim, c4, dtype)
        self.output_upscaling_1 = LayerNorm2d(c4)
        self.output_upscaling_3 = ConvTranspose2x2(c4, c8, dtype)
        for i in range(T):
            self.add_module(f"output_hypernetworks_mlps_{i}",
                            MLP(embed_dim, embed_dim, c8, 3, dtype))
        self.iou_prediction_head = MLP(embed_dim, iou_head_hidden_dim, T,
                                       iou_head_depth, dtype)
        self.embed_dim = embed_dim
        self.num_tokens = T

    def transformer_forward(self, image_embeddings, image_pe, sparse_prompt,
                            dense_prompt):
        """Everything up to the upscaling tail: keys (B, h*w, C) per-prompt
        image features, hyper (B, T, C/8), iou_pred (B, T)."""
        B = sparse_prompt.shape[0]
        T = self.num_tokens
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1),
                            sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        hs, keys = self.transformer(src, image_pe, tokens)
        hyper = torch.stack([
            getattr(self, f"output_hypernetworks_mlps_{i}")(hs[:, 1 + i])
            for i in range(T)], dim=1)
        iou_pred = self.iou_prediction_head(hs[:, 0])
        return keys, hyper, iou_pred

    def tail(self, keys, hyper, h: int, w: int):
        """Upscaling tail + hypernetwork contraction: keys (B, h*w, C),
        hyper (B, T, C/8) -> (B, T, 4h, 4w) mask logits."""
        B, N, _ = keys.shape
        T = hyper.shape[1]
        c4, c8 = self.embed_dim // 4, self.embed_dim // 8
        x = self.output_upscaling_0(keys)  # (B, N, 4 * c4), nest (a, d, c)
        x = F.gelu(self.output_upscaling_1(x.reshape(B, N, 4, c4)))
        x = F.gelu(self.output_upscaling_3(x))  # (B, N, 4, 4 * c8)
        blocks = x.reshape(B, N, 16, c8)  # j = (a, d, e, f)
        masks = torch.einsum("btc,bqjc->btqj", hyper, blocks)
        # output pixel (4y + 2a + e, 4x + 2d + f)
        masks = masks.reshape(B, T, h, w, 2, 2, 2, 2)
        return masks.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(B, T, 4 * h,
                                                             4 * w)

    def tail_kernel_params(self) -> dict:
        """The tail's weights in the layout of `ops/decode_tail.py`
        (float32): stage kernels flattened (C, 4 * O), biases and the
        LayerNorm's parameters tiled 4x to the flat columns."""
        up0, ln, up3 = (self.output_upscaling_0, self.output_upscaling_1,
                        self.output_upscaling_3)
        return {k: v.detach().float().contiguous() for k, v in dict(
            w1=up0.flat_kernel(), b1=up0.bias.repeat(4),
            ln_scale=ln.weight.repeat(4), ln_bias=ln.bias.repeat(4),
            w2=up3.flat_kernel(), b2=up3.bias.repeat(4)).items()}

    def forward(self, image_embeddings, image_pe, sparse_prompt,
                dense_prompt):
        """-> ((B, T, 4h, 4w) mask logits, (B, T) predicted IoUs)."""
        h, w = image_embeddings.shape[1:3]
        keys, hyper, iou_pred = self.transformer_forward(
            image_embeddings, image_pe, sparse_prompt, dense_prompt)
        return self.tail(keys, hyper, h, w), iou_pred
