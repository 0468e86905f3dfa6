"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a card every test skips.  On a machine with one:
    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
(the first test builds the kernels with nvcc; `--noconftest` leaves out
the JAX test configuration, for machines without JAX).
"""

import numpy as np
import pytest
import torch

from sam6d_tpu_torch.config import GeoEmbeddingConfig
from sam6d_tpu_torch.models.pem.geo_embedding import (
    GeometricStructureEmbedding,
    geometric_embedding_indices,
)
from sam6d_tpu_torch.ops import decode_tail as dt
from sam6d_tpu_torch.ops import flash_rpe as fr
from sam6d_tpu_torch.ops import fps as fps_mod
from sam6d_tpu_torch.ops import geo_embed as ge
from sam6d_tpu_torch.params import init_random_

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,npoint", [(2, 2048, 196), (1, 20000, 512)])
def test_fps_kernel_matches_plain_index_for_index(dev, B, N, npoint):
    g = torch.Generator(device=dev).manual_seed(N)
    pts = torch.randn(B, N, 3, generator=g, device=dev)
    got = fps_mod.fps_cuda(pts, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.fps_plain(pts, npoint))


def test_fps_kernel_matches_plain_at_near_ties(dev):
    # A 0.1 lattice with 1e-7 jitter: near-ties that any other rounding of
    # d2 (another association order, or a fused multiply-add) breaks
    # apart.  The kernel must round every step as the plain version does.
    g = np.stack(np.meshgrid(*[np.arange(7.0)] * 3, indexing="ij"), -1)
    g = g.reshape(1, -1, 3)
    jit = np.random.RandomState(0).randint(0, 3, g.shape) * 1e-7
    pts = torch.from_numpy((g * 0.1 + jit).astype(np.float32)).to(dev)
    got = fps_mod.fps_cuda(pts, 40)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.fps_plain(pts, 40))


@torch.no_grad()
def _geo_inputs(dev, B, N, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
    pts[:, 0] = 100.0
    d_idx, a_idx = geometric_embedding_indices(pts, 0.2, 15.0, 3)
    mod = GeometricStructureEmbedding(GeoEmbeddingConfig(hidden_dim=d), dtype)
    init_random_(mod, torch.Generator().manual_seed(seed))
    mod.to(dev)
    Md = mod._fold(40, 20.0, mod.proj_d).contiguous()
    Ma = mod._fold(28, 12.0, mod.proj_a).contiguous()
    bias = torch.randn(d, generator=g, device=dev) * 0.1
    return torch.clamp_max(d_idx, 20.0).contiguous(), a_idx.contiguous(), \
        Md, Ma, bias


@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 1e-5),      # summation order only
    (torch.bfloat16, 1e-2, 8e-3),     # one bf16 step of the output
])
@pytest.mark.parametrize("B,N,d", [(2, 33, 32), (1, 197, 256)])
def test_geo_embed_kernel_matches_plain(dev, dtype, atol, rtol, B, N, d):
    args = _geo_inputs(dev, B, N, d, dtype)
    got = ge.geo_embed_maxk_cuda(*args, 20.0, 12.0, dtype).float()
    want = ge.geo_embed_maxk_plain(*args, 20.0, 12.0, dtype).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        fps_mod.fps_cuda(torch.zeros(1, 64, 3, device=dev, dtype=torch.float64), 8)
    d_idx, a_idx, Md, Ma, bias = _geo_inputs(dev, 1, 9, 32, torch.float32)
    with pytest.raises(ValueError):
        ge.geo_embed_maxk_cuda(d_idx, a_idx, Md.bfloat16(), Ma, bias, 20.0,
                               12.0, torch.float32)
    with pytest.raises(ValueError):
        ge.geo_embed_maxk_cuda(d_idx, a_idx[..., :2].contiguous(), Md, Ma,
                               bias, 20.0, 12.0, torch.float32)


@torch.no_grad()
def test_geo_embedding_auto_uses_the_kernel_at_batch_one(dev):
    mod = GeometricStructureEmbedding(GeoEmbeddingConfig(hidden_dim=32))
    init_random_(mod, torch.Generator().manual_seed(1))
    pts = torch.rand(1, 17, 3, device=dev)
    pts[:, 0] = 100.0
    before = ge.KERNEL.launches
    on_card = mod.to(dev)(pts)
    assert ge.KERNEL.launches == before + 1
    plain = mod.cpu()(pts.cpu()).numpy()
    got = on_card.cpu().numpy()
    # Fused kernel + sentinel delta vs the unfused path: 2e-4 off the
    # diagonal, as on the CPU.  3e-3 elsewhere: row/col 0 (the bg
    # sentinel, distances up to ~500) carry the float32 sin/cos difference
    # of the card's and the CPU's libraries, and the diagonal's distance
    # is the square root of a cancellation residual that differs between
    # the two devices' matmuls.
    off_diag = ~np.eye(16, dtype=bool)
    np.testing.assert_allclose(got[:, 1:, 1:][:, off_diag],
                               plain[:, 1:, 1:][:, off_diag], atol=2e-4)
    np.testing.assert_allclose(got, plain, atol=3e-3)


def _assert_attention_close(got, want, dtype):
    """float32 differs by summation order only (atol 2e-5, rtol 2e-4).  In
    bfloat16 both round the output (each within half a step, 2^-9
    relative), so they may land two steps apart (rtol 1.6e-2); the
    probabilities' own rounding (2^-9 relative each, in the plain version
    before the product with v) moves an output by a small part of its
    typical size, so atol is 5% of the outputs' standard deviation: a
    kernel wrong by one typical output value fails."""
    if dtype == torch.float32:
        atol, rtol = 2e-5, 2e-4
    else:
        atol, rtol = 0.05 * float(want.std()), 1.6e-2
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _qkv(dev, BH, N, d, dtype, seed=0, scale=1.0):
    # Unit-scale q and k spread the logits (standard deviation 1 before
    # the bias), so the outputs are not near-uniform averages of v.
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(BH, N, d, generator=g, device=dev) * scale
            for _ in range(2))
    v = torch.randn(BH, N, d, generator=g, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,h,w,d", [
    (3, 8, 8, 16), (16, 14, 14, 80), (2, 64, 64, 80), (1, 7, 9, 32)])
def test_flash_rpe_kernel_matches_plain(dev, dtype, BH, h, w, d):
    q, k, v = _qkv(dev, BH, h * w, d, dtype)
    g = torch.Generator(device=dev).manual_seed(1)
    rh = (torch.randn(2 * h - 1, d, generator=g, device=dev) * 0.1).to(dtype)
    rw = (torch.randn(2 * w - 1, d, generator=g, device=dev) * 0.1).to(dtype)
    got = fr.flash_rpe_attention_cuda(q, k, v, rh, rw, (h, w)).float()
    want = fr.rpe_attention_plain(q, k, v, rh, rw, (h, w)).float()
    torch.cuda.synchronize()
    _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,N,d", [(8, 257, 64), (4, 64, 16), (2, 300, 128)])
def test_flash_attention_kernel_matches_plain(dev, dtype, BH, N, d):
    q, k, v = _qkv(dev, BH, N, d, dtype)
    got = fr.flash_attention_cuda(q, k, v).float()
    want = fr.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    _assert_attention_close(got, want, dtype)


def test_flash_attention_survives_large_logits(dev):
    q, k, v = _qkv(dev, 2, 200, 64, torch.float32, scale=0.3)
    got = fr.flash_attention_cuda(q * 40.0, k, v)
    want = fr.attention_plain(q * 40.0, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


def _tail_inputs(dev, P, N, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    return dict(keys=r(P, N, 256, s=0.5).to(dtype), hyper=r(P, 3, 32, s=0.5),
                w1=r(256, 256, s=0.05), b1=r(256, s=0.05),
                ln_scale=1.0 + r(256, s=0.1), ln_bias=r(256, s=0.1),
                w2=r(64, 128, s=0.1), b2=r(128, s=0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N", [(3, 256), (2, 100), (4, 4096)])
def test_decode_tail_kernel_matches_plain(dev, dtype, P, N):
    # Counts atol 8 and boxes atol 4 px, as the JAX package holds its
    # kernel to its reference: float32 summation order flips the pixels
    # whose logit lies within rounding of a threshold.
    inp = _tail_inputs(dev, P, N, dtype)
    kw = dict(mask_threshold=0.0, stability_offset=0.3)
    got = dt.decode_tail_stats_cuda(**inp, **kw)
    want = dt.decode_tail_stats_plain(**inp, **kw)
    torch.cuda.synchronize()
    for rows, atol in (((0, 1, 6), 8.0), ((2, 3, 4, 5), 4.0), ((7,), 0.0)):
        torch.testing.assert_close(got[:, list(rows)], want[:, list(rows)],
                                   atol=atol, rtol=0)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v = _qkv(dev, 1, 16, 48, torch.float32)  # head dim 48
    with pytest.raises(ValueError):
        fr.flash_attention_cuda(q, k, v)
    q, k, v = _qkv(dev, 1, 65 * 2, 16, torch.float32)
    rh = torch.zeros(129, 16, device=dev)
    with pytest.raises(ValueError):  # a grid side above 64
        fr.flash_rpe_attention_cuda(q, k, v, rh, torch.zeros(3, 16,
                                                             device=dev),
                                    (65, 2))
    flat = torch.zeros(4 * 16 * 16 + 1, device=dev, dtype=torch.bfloat16)
    q = flat[1:].view(4, 16, 16)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError):
        fr.flash_attention_cuda(q, q, q)
    inp = _tail_inputs(dev, 1, 16, torch.float32)
    inp["w2"] = inp["w2"].T.contiguous()
    with pytest.raises(ValueError):
        dt.decode_tail_stats_cuda(**inp)
