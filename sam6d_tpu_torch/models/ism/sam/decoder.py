"""SAM mask decoder: two-way transformer and hypernetwork mask heads.

Counterpart of `sam6d_tpu/models/ism/sam/decoder.py` (reference
segment_anything/modeling/mask_decoder.py :16, transformer.py
TwoWayTransformer :16).  LayerNorms use flax's eps 1e-6.  The upscaling
ConvTransposes (kernel = stride = 2) are pointwise matmuls C -> 2*2*O
with torch ConvTranspose2d semantics (no spatial flip), and the 2 x 2
blocks stay flattened in the channel axis, nesting (dy, dx, feature),
until the single pixel shuffle at the end of `tail`.  Each two-way block
ends in `ops/two_way.two_way_keys` (K9 on the card): its image-to-token
attention, `norm4` and the next token-to-image attention's key and value
projections, which that attention then takes as they are.

SAM 2's decoder (sam2/modeling/sam/mask_decoder.py :15) is this one with
three construction options: `pred_obj_scores` puts an object-score token
ahead of the IoU and mask tokens (it takes part in every attention; its
head, `pred_obj_score_head`, is built for the checkpoint and left
unevaluated, as SAM2ImagePredictor discards its output), `iou_sigmoid`
ends the IoU head in a sigmoid, and `high_res` adds one image's
high-resolution features in the upscaling tail, conv_s1's before the
LayerNorm and conv_s0's before the second GELU (`tail`'s `res`).  The
1 x 1 convolutions `conv_s0` / `conv_s1` live here, as in the checkpoint,
and run once an image (`sam2/model.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.ism.sam.encoder import LayerNorm2d
from sam6d_tpu_torch.models.layers import Dense, LayerNorm
from sam6d_tpu_torch.ops.two_way import TwoWayWeights, two_way_keys


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

    @staticmethod
    def split_heads(t, num_heads: int = 8):
        """(..., n, H * hd) -> a (..., H, n, hd) view."""
        return t.reshape(*t.shape[:-1], num_heads, -1).transpose(-2, -3)

    @staticmethod
    def attention(qp, kh, vh, q_dtype):
        """Multi-head attention of a projected query qp (..., n, H * hd) on
        projected keys and values split into heads, kh and vh (..., H, m,
        hd) -> (..., n, H * hd), before the output projection.  The JAX
        module divides by sqrt(hd) cast to the dtype of the input q
        (`q_dtype`), which promotes bf16 logits when q is float32."""
        H, hd = kh.shape[-3], kh.shape[-1]
        attn = CrossAttention.split_heads(qp, H) @ kh.transpose(-1, -2)
        attn = attn.to(torch.promote_types(attn.dtype, q_dtype))
        attn = torch.softmax(attn / math.sqrt(hd), dim=-1)
        out = (attn @ vh.to(attn.dtype)).transpose(-2, -3)
        return out.reshape(*out.shape[:-2], H * hd)

    def forward(self, q, k, v):
        H = self.num_heads
        return self.attend(q, self.split_heads(self.k_proj(k), H),
                           self.split_heads(self.v_proj(v), H))

    def attend(self, q, kh, vh):
        """The attention of q on keys and values already projected by
        this module's k_proj and v_proj and split into heads (..., H, m,
        hd)."""
        return self.out_proj(self.attention(self.q_proj(q), kh, vh, q.dtype))


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

    def forward(self, queries, keys, query_pe, key_pe, kv, nxt):
        """keys (Bk, N, C); kv: this block's token-to-image keys and
        values, projected and split into heads by the previous block's
        `two_way_keys` (None in the first block); nxt: the next
        token-to-image attention.  -> (queries, keys (B, N, C), nxt's
        keys and values)."""
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        t2i = self.cross_attn_token_to_image
        if kv is None:
            attn_out = t2i(queries + query_pe, keys + key_pe, keys)
        else:
            attn_out = t2i.attend(queries + query_pe, *kv)
        queries = self.norm2(queries + attn_out)
        mlp_out = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries + mlp_out)
        i2t = self.cross_attn_image_to_token
        keys, kp, vp = two_way_keys(
            keys, key_pe, i2t.k_proj(queries + query_pe), i2t.v_proj(queries),
            self.key_weights(nxt), i2t.q_proj.dtype, self.norm4.eps)
        return queries, keys, (kp, vp)

    def key_weights(self, nxt: CrossAttention) -> TwoWayWeights:
        """The weights of `two_way_keys`: the image-to-token attention's
        q and out projections, norm4, nxt's k and v projections."""
        i2t = self.cross_attn_image_to_token
        return TwoWayWeights(
            i2t.q_proj.weight, i2t.q_proj.bias, i2t.out_proj.weight,
            i2t.out_proj.bias, self.norm4.weight, self.norm4.bias,
            nxt.k_proj.weight, nxt.k_proj.bias, nxt.v_proj.weight,
            nxt.v_proj.bias)


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
        queries, kv = point_embedding, None
        for i in range(self.depth):
            nxt = (getattr(self, f"layers_{i + 1}").cross_attn_token_to_image
                   if i + 1 < self.depth else self.final_attn_token_to_image)
            queries, keys, kv = getattr(self, f"layers_{i}")(
                queries, keys, point_embedding, key_pe, kv, nxt)
        attn_out = self.final_attn_token_to_image.attend(
            queries + point_embedding, *kv)
        return self.norm_final_attn(queries + attn_out), keys


class MaskDecoder(nn.Module):
    def __init__(self, embed_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 dtype=torch.float32, pred_obj_scores: bool = False,
                 iou_sigmoid: bool = False, high_res: bool = False):
        super().__init__()
        T = num_multimask_outputs + 1
        c4, c8 = embed_dim // 4, embed_dim // 8
        if pred_obj_scores:
            self.obj_score_token = nn.Parameter(torch.zeros(1, embed_dim))
            self.pred_obj_score_head = MLP(embed_dim, embed_dim, 1, 3, dtype)
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
        if high_res:
            self.conv_s0 = Dense(embed_dim, c8, dtype=dtype)
            self.conv_s1 = Dense(embed_dim, c4, dtype=dtype)
        self.embed_dim = embed_dim
        self.num_tokens = T
        self.pred_obj_scores = pred_obj_scores
        self.iou_sigmoid = iou_sigmoid

    def transformer_forward(self, image_embeddings, image_pe, sparse_prompt,
                            dense_prompt):
        """Everything up to the upscaling tail: keys (B, h*w, C) per-prompt
        image features, hyper (B, T, C/8), iou_pred (B, T) (of the mask
        tokens; an object-score token's output is not read)."""
        B = sparse_prompt.shape[0]
        T = self.num_tokens
        heads = [self.iou_token, self.mask_tokens]
        if self.pred_obj_scores:
            heads.insert(0, self.obj_score_token)
        s = int(self.pred_obj_scores)  # the IoU token's place
        output_tokens = torch.cat(heads, dim=0)
        tokens = torch.cat([output_tokens[None].expand(B, -1, -1),
                            sparse_prompt], dim=1)
        src = image_embeddings + dense_prompt
        hs, keys = self.transformer(src, image_pe, tokens)
        hyper = torch.stack([
            getattr(self, f"output_hypernetworks_mlps_{i}")(hs[:, s + 1 + i])
            for i in range(T)], dim=1)
        iou_pred = self.iou_prediction_head(hs[:, s])
        if self.iou_sigmoid:
            iou_pred = torch.sigmoid(iou_pred)
        return keys, hyper, iou_pred

    def tail(self, keys, hyper, h: int, w: int, res=None):
        """Upscaling tail + hypernetwork contraction: keys (B, h*w, C),
        hyper (B, T, C/8) -> (B, T, 4h, 4w) mask logits.  res: SAM 2's
        (res1 (h*w, 4 * C/4), res0 (h*w, 4, 4 * C/8)), one image's
        high-resolution features in the key rows' layout (`high_res`)."""
        B, N, _ = keys.shape
        T = hyper.shape[1]
        c4, c8 = self.embed_dim // 4, self.embed_dim // 8
        x = self.output_upscaling_0(keys)  # (B, N, 4 * c4), nest (a, d, c)
        if res is not None:
            x = x + res[0]
        x = F.gelu(self.output_upscaling_1(x.reshape(B, N, 4, c4)))
        x = self.output_upscaling_3(x)  # (B, N, 4, 4 * c8)
        if res is not None:
            x = x + res[1]
        x = F.gelu(x)
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
