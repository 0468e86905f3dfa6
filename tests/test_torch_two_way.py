"""K9's plain version and the two-way transformer that calls it, on the
CPU: `ops/two_way.two_way_keys_plain` against the modules' composition
(the image-to-token attention, norm4, the next attention's k and v
projections) as the port computed it before K9, and the transformer's
outputs against that transformer's, bit for bit.  The kernel itself is
held to the plain version on the card (`test_torch_kernels_cuda.py`)."""

import sys
from pathlib import Path

import pytest
import torch

from sam6d_tpu_torch.models.ism.sam import decoder
from sam6d_tpu_torch.models.ism.sam.decoder import CrossAttention, MaskDecoder
from sam6d_tpu_torch.models.layers import cast_dense_weights
from sam6d_tpu_torch.ops import two_way
from sam6d_tpu_torch.utils import timer

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from two_way_cases import (  # noqa: E402
    fill_,
    op_case,
    parent_cross_attention,
    parent_transformer,
    transformer,
    transformer_inputs,
)

torch.set_num_threads(2)
B = 3


# T = 7: a grid point (5 output tokens, the point, the pad); T = 8: a box
# prompt (5, the point, two corners).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [4096, 576])
@pytest.mark.parametrize("T", [7, 8])
@pytest.mark.parametrize("Bk", [1, B])
@torch.no_grad()
def test_plain_op_equals_the_modules_composition(dtype, N, T, Bk):
    blk, nxt, keys, key_pe, k_tok, v_tok, queries, query_pe, w = op_case(
        B, N, T, Bk, dtype)
    i2t = blk.cross_attn_image_to_token
    attn_out = parent_cross_attention(i2t, keys + key_pe, queries + query_pe,
                                      queries)
    want = blk.norm4(keys + attn_out)
    want_kp = CrossAttention.split_heads(nxt.k_proj(want + key_pe))
    want_vp = CrossAttention.split_heads(nxt.v_proj(want))
    got = two_way.two_way_keys_plain(keys, key_pe, k_tok, v_tok, w, dtype,
                                     blk.norm4.eps)
    assert [tuple(t.shape) for t in got] == [(B, N, 256), (B, 8, N, 16),
                                             (B, 8, N, 16)]
    assert all(t.dtype == dtype for t in got)
    for g, x in zip(got, (want, want_kp, want_vp)):
        assert torch.equal(g, x)


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@torch.no_grad()
def test_plain_op_keeps_the_residuals_rounding(keys_dtype):
    # bf16 keys add the attention's output in bf16 (the second block);
    # float32 keys in float32 (the first): both as the modules do.
    blk, nxt, keys, key_pe, k_tok, v_tok, queries, query_pe, w = op_case(
        B, 576, 7, B, torch.bfloat16, keys_dtype=keys_dtype)
    attn_out = parent_cross_attention(blk.cross_attn_image_to_token,
                                      keys + key_pe, queries + query_pe,
                                      queries)
    got = two_way.two_way_keys_plain(keys, key_pe, k_tok, v_tok, w,
                                     torch.bfloat16)
    assert torch.equal(got[0], blk.norm4(keys + attn_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,T,Bk", [(4096, 7, 1), (576, 7, 1),
                                    (576, 8, B), (256, 9, B)])
@torch.no_grad()
def test_transformer_equals_the_parent_bit_for_bit(dtype, N, T, Bk):
    t = transformer(dtype)
    emb, pe, tokens = transformer_inputs(B, N, T, Bk)
    got = t(emb, pe, tokens)
    want = parent_transformer(t, emb, pe, tokens)
    assert got[0].shape == (B, T, 256) and got[1].shape == (B, N, 256)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@torch.no_grad()
def test_the_transformer_hook_fires_once_a_call_with_the_tokens():
    g = torch.Generator().manual_seed(3)
    dec = cast_dense_weights(fill_(MaskDecoder(dtype=torch.bfloat16), g)
                             .eval())
    seen = []
    h = dec.transformer.register_forward_hook(
        lambda _m, _i, out: seen.append(out))
    emb, pe, _ = transformer_inputs(B, 256, 2, 1)
    sparse = torch.randn(B, 2, 256, generator=g)
    dense = torch.randn(1, 1, 1, 256, generator=g)
    keys, hyper, iou = dec.transformer_forward(emb, pe, sparse, dense)
    h.remove()
    assert len(seen) == 1
    tokens, hook_keys = seen[0]
    assert tokens.shape == (B, 1 + dec.num_tokens + 2, 256)
    assert hook_keys is keys and keys.shape == (B, 256, 256)
    assert hyper.shape == (B, 4, 32) and iou.shape == (B, 4)


@torch.no_grad()
def test_the_counters_count_every_prompts_rows_a_call(monkeypatch):
    t = transformer(torch.bfloat16)
    emb, pe, tokens = transformer_inputs(B, 576, 7, 1)
    with timer.recording() as rec:
        t(emb, pe, tokens)
    assert rec.counts and {c[0] for c in rec.counts} == {"sam.key_rows_plain"}
    assert [c[1] for c in rec.counts] == [B * 576] * t.depth

    # Tensors off the CPU take the kernel's route: on the meta device
    # (shapes only) with the launch replaced by the plain version.
    calls = []

    def fake_cuda(keys, key_pe, k_tok, v_tok, w, dtype, eps=1e-6):
        calls.append((tuple(keys.shape), tuple(key_pe.shape)))
        return two_way.two_way_keys_plain(keys, key_pe, k_tok, v_tok, w,
                                          dtype, eps)

    monkeypatch.setattr(two_way, "two_way_keys_cuda", fake_cuda)
    blk, nxt, keys, key_pe, k_tok, v_tok, _, _, w = op_case(
        B, 576, 7, 1, torch.bfloat16, device="meta")
    with timer.recording() as rec:
        out = two_way.two_way_keys(keys, key_pe, k_tok, v_tok, w,
                                   torch.bfloat16)
    assert rec.counts[0][:2] == ("sam.key_rows_fused", B * 576)
    assert len(rec.counts) == 1
    assert calls == [((1, 576, 256), (576, 256))]
    assert out[0].shape == (B, 576, 256)



def test_the_kernels_autograd_node_differentiates_the_plain_version(
        monkeypatch):
    # On the card `two_way_keys` launches through `_TwoWayKeys`, whose
    # backward recomputes the plain version at the saved inputs.  Here the
    # launch is replaced by the plain version, so the node's gradients
    # equal plain autograd's bit for bit, for every input that wants one.
    monkeypatch.setattr(
        two_way, "two_way_keys_cuda",
        lambda keys, key_pe, *a: two_way.two_way_keys_plain(
            keys, key_pe[None], *a))
    blk, nxt, keys, key_pe, k_tok, v_tok, _, _, w = op_case(
        B, 64, 7, B, torch.float32)
    g = torch.Generator().manual_seed(5)
    dirs = [torch.randn(B, 64, 256, generator=g),
            torch.randn(B, 8, 64, 16, generator=g),
            torch.randn(B, 8, 64, 16, generator=g)]
    grads = []
    for op in (two_way.two_way_keys_plain, "node"):
        xs = [t.detach().clone().requires_grad_(True)
              for t in (keys, k_tok, v_tok)]
        ws = [t.detach().clone().requires_grad_(True) for t in w]
        args = (xs[0], key_pe, xs[1], xs[2])
        if op == "node":
            outs = two_way._TwoWayKeys.apply(*args, torch.float32, 1e-6,
                                             *ws)
        else:
            outs = op(*args, two_way.TwoWayWeights(*ws), torch.float32)
        sum((o * d).sum() for o, d in zip(outs, dirs)).backward()
        grads.append([t.grad for t in xs + ws])
    for want, got in zip(*grads):
        assert got is not None and torch.equal(got, want)
