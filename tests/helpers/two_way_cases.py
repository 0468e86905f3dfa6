"""Cases for K9 (`ops/two_way.py`) shared by the CPU and the card tests,
with the two-way transformer's arithmetic as it was written before K9 (a
frozen copy: the yardstick of the bit-for-bit tests).  Torch only, so the
card tests load it by path on a machine without JAX."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sam6d_tpu_torch.models.ism.sam.decoder import (
    CrossAttention,
    TwoWayAttentionBlock,
    TwoWayTransformer,
)
from sam6d_tpu_torch.models.layers import cast_dense_weights
from sam6d_tpu_torch.ops.two_way import TwoWayWeights


@torch.no_grad()
def fill_(module: torch.nn.Module, generator: torch.Generator):
    """Random weights with every parameter in play: Dense kernels with
    std 1/sqrt(fan_in), biases N(0, 0.1), LayerNorm scales 1 + N(0, 0.1)
    and shifts N(0, 0.1)."""
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=generator)
        if p.dim() == 2:
            p.copy_(r / math.sqrt(p.shape[1]))
        elif name.startswith("norm") or ".norm" in name:
            p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.1 * r)
        else:
            p.copy_(0.1 * r)
    return module


def parent_cross_attention(m: CrossAttention, q, k, v):
    """CrossAttention.forward as the port computed it before K9."""
    H = m.num_heads
    hd = m.internal // H

    def heads(t):
        return t.reshape(*t.shape[:-1], H, hd).transpose(-2, -3)

    qp, kp, vp = heads(m.q_proj(q)), heads(m.k_proj(k)), heads(m.v_proj(v))
    attn = qp @ kp.transpose(-1, -2)
    attn = attn.to(torch.promote_types(attn.dtype, q.dtype))
    attn = torch.softmax(attn / math.sqrt(hd), dim=-1)
    out = (attn @ vp.to(attn.dtype)).transpose(-2, -3)
    return m.out_proj(out.reshape(*out.shape[:-2], m.internal))


def parent_block(b: TwoWayAttentionBlock, queries, keys, query_pe, key_pe):
    """TwoWayAttentionBlock.forward before K9."""
    if b.skip_first_layer_pe:
        queries = parent_cross_attention(b.self_attn, queries, queries,
                                         queries)
    else:
        q = queries + query_pe
        queries = queries + parent_cross_attention(b.self_attn, q, q, queries)
    queries = b.norm1(queries)
    attn_out = parent_cross_attention(b.cross_attn_token_to_image,
                                      queries + query_pe, keys + key_pe, keys)
    queries = b.norm2(queries + attn_out)
    mlp_out = b.mlp_lin2(F.relu(b.mlp_lin1(queries)))
    queries = b.norm3(queries + mlp_out)
    attn_out = parent_cross_attention(b.cross_attn_image_to_token,
                                      keys + key_pe, queries + query_pe,
                                      queries)
    return queries, b.norm4(keys + attn_out)


def parent_transformer(t: TwoWayTransformer, image_embedding, image_pe,
                       point_embedding):
    """TwoWayTransformer.forward before K9: (tokens, keys)."""
    Bk, h, w, C = image_embedding.shape
    keys = image_embedding.reshape(Bk, h * w, C)
    key_pe = image_pe.reshape(1, h * w, C)
    queries = point_embedding
    for i in range(t.depth):
        queries, keys = parent_block(getattr(t, f"layers_{i}"), queries, keys,
                                     point_embedding, key_pe)
    attn_out = parent_cross_attention(t.final_attn_token_to_image,
                                      queries + point_embedding,
                                      keys + key_pe, keys)
    return t.norm_final_attn(queries + attn_out), keys


def transformer(dtype, seed: int = 0, device="cpu") -> TwoWayTransformer:
    """A two-way transformer at SAM's widths with `fill_` weights, stored
    in the compute dtype as the serving paths store them."""
    g = torch.Generator().manual_seed(seed)
    t = fill_(TwoWayTransformer(dtype=dtype), g)
    return cast_dense_weights(t.eval()).to(device)


def transformer_inputs(B: int, N: int, T: int, Bk: int, seed: int = 1,
                       device="cpu"):
    """image_embedding (Bk, h, w, 256), image_pe (1, h, w, 256) and tokens
    (B, T, 256), float32, for a square grid of N = h * w rows."""
    h = int(round(N ** 0.5))
    assert h * h == N
    g = torch.Generator().manual_seed(seed)
    out = (torch.randn(Bk, h, h, 256, generator=g),
           torch.randn(1, h, h, 256, generator=g),
           torch.randn(B, T, 256, generator=g))
    return tuple(x.to(device) for x in out)


def op_case(B: int, N: int, T: int, Bk: int, dtype, seed: int = 2,
            device="cpu", keys_dtype=None):
    """One `two_way_keys` call as the first block makes it (Bk = 1, or B
    with a mask prompt: float32 keys) or as the second does (keys of
    batch B in the compute dtype), unless `keys_dtype` says otherwise:
    (block, nxt, keys, key_pe, k_tok, v_tok, queries, query_pe, weights)."""
    t = transformer(dtype, seed, device)
    blk, nxt = t.layers_1, t.final_attn_token_to_image
    g = torch.Generator().manual_seed(seed + 1)
    if keys_dtype is None:
        keys_dtype = dtype if Bk == B and B > 1 else torch.float32
    keys = torch.randn(Bk, N, 256, generator=g).to(device, keys_dtype)
    key_pe = torch.randn(1, N, 256, generator=g).to(device)
    queries = torch.randn(B, T, 256, generator=g).to(device, dtype)
    query_pe = torch.randn(B, T, 256, generator=g).to(device)
    i2t = blk.cross_attn_image_to_token
    with torch.no_grad():
        k_tok, v_tok = i2t.k_proj(queries + query_pe), i2t.v_proj(queries)
    w = blk.key_weights(nxt)
    assert isinstance(w, TwoWayWeights)
    return blk, nxt, keys, key_pe, k_tok, v_tok, queries, query_pe, w
