"""PEM transformer stack.

Counterpart of `sam6d_tpu/models/pem/transformer.py` (reference
transformer.py): RPE multi-head attention with q pulled through proj_p,
the geometric transformer, focused linear attention, and the
sparse-to-dense transformer.  Scores and softmax run in float32; the
LayerNorms use flax's eps 1e-6 in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.models.layers import Dense, LayerNorm, f32_matmul


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.proj_q = Dense(d_model, d_model, dtype=dtype)
        self.proj_k = Dense(d_model, d_model, dtype=dtype)
        self.proj_v = Dense(d_model, d_model, dtype=dtype)
        self.num_heads = num_heads

    def _heads(self, x):  # (B, N, D) -> (B, H, N, hd)
        B, N, D = x.shape
        return x.reshape(B, N, self.num_heads, D // self.num_heads).transpose(1, 2)

    def forward(self, q_in, k_in, v_in):
        q = self._heads(self.proj_q(q_in))
        k = self._heads(self.proj_k(k_in))
        v = self._heads(self.proj_v(v_in))
        scores = f32_matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        out = attn @ v
        B, H, N, hd = out.shape
        return out.transpose(1, 2).reshape(B, N, H * hd)


class RPEMultiHeadAttention(MultiHeadAttention):
    """scores = (q.k + q.p) / sqrt(hd) with p = proj_p(embed): q is pulled
    through proj_p's kernel (q.p = (Wp^T q).embed + q.b_p), so the
    (B, N, M, H, hd) projected embedding never exists."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__(d_model, num_heads, dtype)
        self.proj_p = Dense(d_model, d_model, dtype=dtype)

    def forward(self, q_in, k_in, v_in, embed_qk):
        H = self.num_heads
        dt = self.proj_q.dtype
        q = self._heads(self.proj_q(q_in))  # (B, H, N, hd)
        k = self._heads(self.proj_k(k_in))
        v = self._heads(self.proj_v(v_in))
        B, _, N, hd = q.shape
        D = embed_qk.shape[-1]
        # Wp as (H, hd, D): q_p[b, h, n, :] = sum_d q[b, h, n, d] Wp[h, d, :].
        Wp_h = self.proj_p.weight.to(dt).reshape(H, hd, D)
        bp_h = self.proj_p.bias.to(dt).reshape(H, hd)
        scores_e = f32_matmul(q, k.transpose(-1, -2))
        q_p = torch.matmul(q, Wp_h[None])  # (B, H, N, D)
        # scores_p[b, h, n, m] = q_p[b, h, n, :] . embed[b, n, m, :]
        scores_p = f32_matmul(
            q_p.permute(0, 2, 1, 3), embed_qk.to(dt).transpose(-1, -2)
        ).permute(0, 2, 1, 3)
        scores_b = (q.float() * bp_h.float()[None, :, None, :]).sum(-1)
        scores = (scores_e + scores_p + scores_b[..., None]) / math.sqrt(hd)
        attn = torch.softmax(scores, dim=-1).to(q.dtype)
        out = attn @ v
        return out.transpose(1, 2).reshape(B, N, H * hd)


class AttentionOutput(nn.Module):
    """Post-attention FFN (expand 2x, ReLU, squeeze), residual + LN."""

    def __init__(self, d_model: int, dtype=torch.float32):
        super().__init__()
        self.expand = Dense(d_model, 2 * d_model, dtype=dtype)
        self.squeeze = Dense(2 * d_model, d_model, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, x):
        y = self.squeeze(F.relu(self.expand(x)))
        return self.norm(x + y)


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads, dtype)
        self.linear = Dense(d_model, d_model, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, memory):
        h = self.linear(self.attention(x, memory, memory))
        return self.output(self.norm(h + x))


class RPETransformerLayer(TransformerLayer):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__(d_model, num_heads, dtype)
        self.attention = RPEMultiHeadAttention(d_model, num_heads, dtype)

    def forward(self, x, memory, position):
        h = self.linear(self.attention(x, memory, memory, position))
        return self.output(self.norm(h + x))


class GeometricTransformer(nn.Module):
    """Alternating RPE-self / vanilla-cross blocks over two point sets.

    With `embeddings_both` ([embeddings0; embeddings1], (2B, N, N, D))
    and equal token counts, each self layer runs once on the stacked
    features (the layer weights are shared between the sides)."""

    def __init__(self, blocks: Sequence[str], d_model: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.blocks = tuple(blocks)
        for i, block in enumerate(self.blocks):
            if block == "self":
                layer = RPETransformerLayer(d_model, num_heads, dtype)
            elif block == "cross":
                layer = TransformerLayer(d_model, num_heads, dtype)
            else:
                raise ValueError(f"unknown block type {block}")
            self.add_module(f"layers_{i}", layer)

    def forward(self, feats0, embeddings0, feats1, embeddings1,
                embeddings_both=None):
        use_both = embeddings_both is not None and feats0.shape == feats1.shape
        B = feats0.shape[0]
        for i, block in enumerate(self.blocks):
            layer = getattr(self, f"layers_{i}")
            if block == "self":
                if use_both:
                    both = torch.cat([feats0, feats1], dim=0)
                    both = layer(both, both, embeddings_both)
                    feats0, feats1 = both[:B], both[B:]
                else:
                    feats0 = layer(feats0, feats0, embeddings0)
                    feats1 = layer(feats1, feats1, embeddings1)
            else:
                # Sequential cross (reference parallel=False): feats1
                # attends to the UPDATED feats0.
                feats0 = layer(feats0, feats1)
                feats1 = layer(feats1, feats0)
        return feats0, feats1


class LinearAttention(nn.Module):
    """Focused linear attention (reference transformer.py:532-578): the
    focusing kernel runs in float32, an integer focusing power as
    repeated multiplication."""

    def __init__(self, d_model: int, num_heads: int,
                 focusing_factor: float = 3.0, dtype=torch.float32):
        super().__init__()
        self.proj_q = Dense(d_model, d_model, dtype=dtype)
        self.proj_k = Dense(d_model, d_model, dtype=dtype)
        self.proj_v = Dense(d_model, d_model, dtype=dtype)
        self.scale = nn.Parameter(torch.zeros(1, 1, d_model))
        self.num_heads = num_heads
        self.focusing_factor = focusing_factor

    @staticmethod
    def _norm(x):  # over the channels
        return torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    def _focus(self, x, scale):
        x = (F.relu(x.float()) + 1e-6) / scale
        x_norm = self._norm(x)
        ff = self.focusing_factor
        if float(ff).is_integer() and 1 <= int(ff) <= 4:
            y = x
            for _ in range(int(ff) - 1):
                y = y * x
        else:
            y = x ** ff
        return y / self._norm(y) * x_norm

    def forward(self, q_in, k_in, v_in):
        H = self.num_heads
        q = self.proj_q(q_in)
        k = self.proj_k(k_in)
        v = self.proj_v(v_in)
        out_dtype = q.dtype
        scale = F.softplus(self.scale.float())
        q = self._focus(q, scale).to(out_dtype)
        k = self._focus(k, scale).to(out_dtype)
        B, N, D = q.shape
        M = k.shape[1]
        hd = D // H
        qh = q.reshape(B, N, H, hd)
        kh = k.reshape(B, M, H, hd)
        vh = v.reshape(B, M, H, hd)
        # Normaliser in float32.
        ksum = kh.float().sum(dim=1)  # (B, H, hd)
        z = 1.0 / ((qh.float() * ksum[:, None]).sum(-1) + 1e-6)  # (B, N, H)
        z = z.to(out_dtype)
        if N * M * (hd + hd) > hd * hd * (N + M):
            kv = torch.einsum("bmhc,bmhd->bhcd", kh, vh)
            out = torch.einsum("bnhc,bhcd->bnhd", qh, kv) * z[..., None]
        else:
            qk = torch.einsum("bnhc,bmhc->bhnm", qh, kh)
            out = torch.einsum("bhnm,bmhd->bnhd", qk, vh) * z[..., None]
        return out.reshape(B, N, D)


class LinearTransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 focusing_factor: float = 3.0, dtype=torch.float32):
        super().__init__()
        self.attention = LinearAttention(d_model, num_heads, focusing_factor,
                                         dtype)
        self.linear = Dense(d_model, d_model, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype)
        self.output = AttentionOutput(d_model, dtype)

    def forward(self, x, memory):
        h = self.linear(self.attention(x, memory, memory))
        return self.output(self.norm(h + x))


class SparseToDenseTransformer(nn.Module):
    """Geometric attention on FPS-selected sparse tokens, propagated to all
    dense tokens by one linear cross-attention layer."""

    def __init__(self, d_model: int, sparse_blocks: Sequence[str],
                 num_heads: int = 4, focusing_factor: float = 3.0,
                 dtype=torch.float32):
        super().__init__()
        self.sparse_layer = GeometricTransformer(sparse_blocks, d_model,
                                                 num_heads, dtype)
        self.dense_layer = LinearTransformerLayer(d_model, num_heads,
                                                  focusing_factor, dtype)

    @staticmethod
    def _sample(dense_feats, fps_idx):
        # The reference gathers with fps_idx (computed on the N points
        # without bg) from the array WITH the bg token at 0
        # (transformer.py:667-671): token j is dense point fps_idx[j] - 1.
        # The released checkpoints were trained with this off-by-one.
        C = dense_feats.shape[-1]
        body = torch.gather(dense_feats, 1,
                            fps_idx[..., None].expand(-1, -1, C))
        return torch.cat([dense_feats[:, :1], body], dim=1)

    def forward(self, dense_feats0, embeddings0, fps_idx0, dense_feats1,
                embeddings1, fps_idx1, embeddings_both=None):
        sparse0 = self._sample(dense_feats0, fps_idx0)
        sparse1 = self._sample(dense_feats1, fps_idx1)
        sparse0, sparse1 = self.sparse_layer(
            sparse0, embeddings0, sparse1, embeddings1,
            embeddings_both=embeddings_both,
        )
        B, N = dense_feats0.shape[:2]
        if dense_feats1.shape[1] == N:
            # Both sides share dense_layer: one stacked call.
            d_in = torch.cat([dense_feats0[:, 1:], dense_feats1[:, 1:]], 0)
            s_in = torch.cat([sparse0[:, 1:], sparse1[:, 1:]], 0)
            d_out = self.dense_layer(d_in, s_in)
            return (torch.cat([sparse0[:, :1], d_out[:B]], 1),
                    torch.cat([sparse1[:, :1], d_out[B:]], 1))
        dense0 = self.dense_layer(dense_feats0[:, 1:], sparse0[:, 1:])
        dense1 = self.dense_layer(dense_feats1[:, 1:], sparse1[:, 1:])
        return (torch.cat([sparse0[:, :1], dense0], 1),
                torch.cat([sparse1[:, :1], dense1], 1))
