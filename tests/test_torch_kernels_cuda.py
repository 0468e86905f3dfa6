"""The port's CUDA kernels against their plain PyTorch versions, on the card.

TF32 stays off (the package disables it at import), so every float32
matmul of a plain version runs in full float32.

Marked `cuda`: without a card every test skips.  On a machine with one:
    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
(the first test builds the kernels with nvcc; `--noconftest` leaves out
the JAX test configuration, for machines without JAX).
"""

import sys
from pathlib import Path

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
from sam6d_tpu_torch.ops import scatter_rows as sr
from sam6d_tpu_torch.params import init_random_

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from ball_query_clouds import ball_query_rows, synthetic_clouds  # noqa: E402
from fps_clouds import cross_block_ties  # noqa: E402
from procrustes_cases import CASES as PROCRUSTES_CASES  # noqa: E402
from procrustes_cases import procrustes_case  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,npoint", [(2, 2048, 196), (1, 20000, 512),
                                        (2, 10000, 2048)])
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


# Each route and instance through a shape that `fps_plan` sends to it:
# 256 threads of 8 points; one block of 1024 threads of 4 to 18 points;
# clusters of 2, 4, 8 and 16 blocks of 8 to 18 points a thread; the
# device-memory route.
@pytest.mark.parametrize("B,N,npoint,route,cluster,per", [
    (3, 2048, 196, "block", 1, 8),
    (2, 1000, 196, "block", 1, 8),
    (1, 3000, 512, "block", 1, 4),
    (1, 8000, 256, "block", 1, 8),
    (2, 10000, 512, "block", 1, 10),
    (1, 13000, 256, "block", 1, 13),
    (1, 16384, 256, "block", 1, 16),
    (1, 18432, 256, "block", 1, 18),
    (2, 20000, 256, "cluster", 2, 10),
    (1, 25000, 256, "cluster", 2, 13),
    (1, 30000, 256, "cluster", 4, 8),
    (2, 65536, 256, "cluster", 8, 8),
    (1, 250000, 64, "cluster", 16, 16),
    (1, 294912, 64, "cluster", 16, 18),
    (1, 400000, 64, "global", 1, 0),
])
def test_fps_every_route_matches_plain(dev, B, N, npoint, route, cluster,
                                       per):
    plan = fps_mod.fps_plan(B, N)
    assert (plan.route, plan.cluster, plan.per) == (route, cluster, per)
    g = torch.Generator(device=dev).manual_seed(N + B)
    pts = torch.rand(B, N, 3, generator=g, device=dev) * 0.2 - 0.1
    got = fps_mod.fps_cuda(pts, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.fps_plain(pts, npoint))


def test_fps_cluster_route_at_the_onboarding_shape(dev):
    plan = fps_mod.fps_plan(1, 210000)
    assert plan.route == "cluster" and plan.cluster == 16
    g = torch.Generator(device=dev).manual_seed(7)
    pts = torch.randn(1, 210000, 3, generator=g, device=dev) * 0.04
    got = fps_mod.fps_cuda(pts, 2048)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.fps_plain(pts, 2048))


@pytest.mark.parametrize("kind", ["dup", "lattice"])
@pytest.mark.parametrize("N", [210000, 20000])
def test_fps_cluster_breaks_cross_block_ties_to_the_lowest_index(dev, kind,
                                                                 N):
    plan = fps_mod.fps_plan(1, N)
    assert plan.route == "cluster"
    pts = torch.from_numpy(cross_block_ties(N, kind)).to(dev)
    got = fps_mod.fps_cuda(pts, 512)
    torch.cuda.synchronize()
    assert torch.equal(got, fps_mod.fps_plain(pts, 512))
    if kind == "dup":  # a duplicate at j + N / 2 never wins over j
        assert bool((got < N // 2).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", ["none", "all"])
def test_geo_embed_winners_match_plain(dev, dtype, ties):
    # The training forward writes the winners and leaves the embedding as
    # the serving call computes it, bit for bit.  Its winners are the
    # plain version's, except where two e_k lie within float32 rounding
    # of each other (the kernel's fmaf chain against a matmul): at most
    # 1e-4 of the (pair, channel) entries; with all k equal, every entry
    # is 0b111 on both sides.
    d_idx, a_idx, Md, Ma, bias = _geo_inputs(dev, 2, 33, 32, dtype)
    if ties == "all":
        a_idx = a_idx[..., :1].expand_as(a_idx).contiguous()
    args = (d_idx, a_idx, Md, Ma, bias, 20.0, 12.0, dtype)
    serving = ge.geo_embed_maxk_cuda(*args)
    out, win = ge.geo_embed_maxk_cuda(*args, winners=True)
    _, want = ge.geo_embed_maxk_plain(*args, winners=True)
    torch.cuda.synchronize()
    assert torch.equal(out, serving)
    assert win.dtype == torch.uint8 and win.shape == out.shape
    if ties == "all":
        assert bool((win == 7).all()) and bool((want == 7).all())
    else:
        assert float((win != want).float().mean()) <= 1e-4


@pytest.mark.parametrize("B,N,d", [(56, 197, 256), (3, 7, 64)])
def test_geo_embed_bf16_with_winners_at_training_and_ragged_shapes(dev, B, N,
                                                                    d):
    # The tensor-core forward at the training shape and at a ragged pair
    # count (147 pairs: a partial 32-pair tile), against the plain version:
    # the embedding within one bf16 step, the winners at all but 1e-4 of
    # the entries, the serving call equal bit for bit.
    dtype = torch.bfloat16
    d_idx, a_idx, Md, Ma, bias = _geo_inputs(dev, B, N, d, dtype, seed=B)
    args = (d_idx, a_idx, Md, Ma, bias, 20.0, 12.0, dtype)
    out, win = ge.geo_embed_maxk_cuda(*args, winners=True)
    serving = ge.geo_embed_maxk_cuda(*args)
    want, want_win = ge.geo_embed_maxk_plain(*args, winners=True)
    torch.cuda.synchronize()
    assert torch.equal(out, serving)
    torch.testing.assert_close(out.float(), want.float(), atol=1e-2,
                               rtol=8e-3)
    assert float((win != want_win).float().mean()) <= 1e-4


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


def _tables(dev, h, w, d, dtype, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    rh = (torch.randn(2 * h - 1, d, generator=g, device=dev) * 0.1).to(dtype)
    rw = (torch.randn(2 * w - 1, d, generator=g, device=dev) * 0.1).to(dtype)
    return rh, rw


# Ragged shapes: N = 63 and 196 (not multiples of the 64-key tile, nor of
# 16 queries), a rectangular 7 x 9 grid (odd w: key pairs that wrap to the
# next grid row), 5 x 13 at d = 128, d = 64 with a bias; the global 64 x 64
# grid (two query tiles a warp in bf16).
@pytest.mark.parametrize("route", ["wrapper", "launch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,h,w,d", [
    (3, 8, 8, 16), (16, 14, 14, 80), (2, 64, 64, 80), (1, 7, 9, 32),
    (8, 7, 9, 80), (4, 14, 14, 64), (2, 5, 13, 128)])
def test_flash_rpe_kernel_matches_plain(dev, route, dtype, BH, h, w, d):
    q, k, v = _qkv(dev, BH, h * w, d, dtype)
    rh, rw = _tables(dev, h, w, d, dtype)
    want = fr.rpe_attention_plain(q, k, v, rh, rw, (h, w)).float()
    if route == "wrapper":
        got = fr.flash_rpe_attention_cuda(q, k, v, rh, rw, (h, w))
        torch.cuda.synchronize()
        _assert_attention_close(got.float(), want, dtype)
        return
    # A bare launch into a prepared output, as chip_smoke times it.
    got = fr.launch(fr.KERNEL_RPE, q, k, v, rh, rw, (h, w),
                    torch.empty_like(q))
    torch.cuda.synchronize()
    _assert_attention_close(got.float(), want, dtype)


@pytest.mark.parametrize("route", ["wrapper", "launch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,N,d", [(8, 257, 64), (4, 64, 16), (2, 300, 128),
                                    (3, 300, 64), (2, 1100, 80), (2, 63, 80)])
def test_flash_attention_kernel_matches_plain(dev, route, dtype, BH, N, d):
    # N = 300: not a multiple of the 8-key n-tile; N = 1100: two query
    # tiles a warp in bf16.
    q, k, v = _qkv(dev, BH, N, d, dtype)
    want = fr.attention_plain(q, k, v).float()
    if route == "wrapper":
        got = fr.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        _assert_attention_close(got.float(), want, dtype)
        return
    got = fr.launch(fr.KERNEL_PLAIN, q, k, v, None, None, (0, 0),
                    torch.empty_like(q))
    torch.cuda.synchronize()
    _assert_attention_close(got.float(), want, dtype)


def _qkv_pooled(dev, BH, Nq, Nk, d, dtype, seed=0):
    # Unit-scale q and k, as `_qkv`; q with its own (pooled) rows.
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(BH, Nq, d, generator=g, device=dev)
    k, v = (torch.randn(BH, Nk, d, generator=g, device=dev)
            for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


# Hiera-L's K5 calls at 1024 px, head width 72 (padded to 80 inside the
# kernel): the windows of stages 1-4 (64, 16, 256, 64 tokens), the
# global blocks of stage 3 (4096 tokens: two query tiles a warp in
# bf16), and the pooling blocks 2, 8 and 44 (16 queries on 64 keys, 4 on
# 16, 64 on 256); then ragged ones (Nq and Nk no multiple of a tile) at
# 72 and, with Nq < Nk, at 64.
HIERA_K5 = [(2048, 64, 64), (4096, 16, 16), (128, 256, 256), (256, 64, 64),
            (8, 4096, 4096), (4096, 16, 64), (8192, 4, 16), (256, 64, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk", HIERA_K5)
def test_flash_attention_at_hieras_shapes(dev, dtype, BH, Nq, Nk):
    q, k, v = _qkv_pooled(dev, BH, Nq, Nk, 72, dtype)
    launches = fr.KERNEL_PLAIN.launches
    got = fr.flash_attention(q, k, v)
    want = fr.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert fr.KERNEL_PLAIN.launches == launches + 1
    assert got.shape == (BH, Nq, 72) and got.dtype == dtype
    _assert_attention_close(got.float(), want, dtype)


@pytest.mark.parametrize("route", ["wrapper", "launch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,Nq,Nk,d", [(3, 37, 300, 72), (2, 1100, 1300, 72),
                                        (5, 9, 9, 72), (4, 100, 257, 64)])
def test_flash_attention_with_fewer_queries_matches_plain(dev, route, dtype,
                                                          BH, Nq, Nk, d):
    q, k, v = _qkv_pooled(dev, BH, Nq, Nk, d, dtype, seed=3)
    want = fr.attention_plain(q, k, v).float()
    if route == "wrapper":
        got = fr.flash_attention_cuda(q, k, v)
    else:
        got = fr.launch(fr.KERNEL_PLAIN, q, k, v, None, None, (0, 0),
                        torch.empty_like(q))
    torch.cuda.synchronize()
    _assert_attention_close(got.float(), want, dtype)


def test_flash_attention_refuses_what_k5_does_not_take(dev):
    q, k, v = _qkv_pooled(dev, 2, 70, 64, 72, torch.bfloat16)
    with pytest.raises(ValueError):  # more queries than keys
        fr.flash_attention_cuda(q, k, v)
    q, k, v = _qkv_pooled(dev, 2, 16, 64, 72, torch.bfloat16)
    with pytest.raises(ValueError):  # v's rows not k's
        fr.flash_attention_cuda(q, k, v[:, :32].contiguous())
    with pytest.raises(ValueError):  # K4 has no width-72 instance
        fr.flash_rpe_attention_cuda(
            *_qkv(dev, 2, 64, 72, torch.bfloat16),
            *_tables(dev, 8, 8, 72, torch.bfloat16), (8, 8))
    with pytest.raises(ValueError):  # K4 takes Nq = Nk only
        fr.flash_rpe_attention_cuda(
            q, k, v, *_tables(dev, 8, 8, 72, torch.bfloat16), (8, 8))


def test_flash_attention_survives_large_logits(dev):
    q, k, v = _qkv(dev, 2, 200, 64, torch.float32, scale=0.3)
    got = fr.flash_attention_cuda(q * 40.0, k, v)
    want = fr.attention_plain(q * 40.0, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rpe_survives_large_logits(dev, dtype):
    # Logits of q x 40 (spread ~50) plus the bias: the exponentials amplify
    # the logits' rounding, 1e-4 / 1e-3 in float32 as for K5; bf16 at its
    # stated tolerance (q x 40 rounded to bf16 on both sides alike).
    q, k, v = _qkv(dev, 4, 196, 80, torch.float32, scale=0.3)
    rh, rw = _tables(dev, 14, 14, 80, dtype)
    q, k, v = (q * 40.0).to(dtype), k.to(dtype), v.to(dtype)
    got = fr.flash_rpe_attention_cuda(q, k, v, rh, rw, (14, 14)).float()
    want = fr.rpe_attention_plain(q, k, v, rh, rw, (14, 14)).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
    else:
        _assert_attention_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rpe_refuses_tables_it_does_not_take(dev, dtype):
    q, k, v = _qkv(dev, 2, 7 * 9, 32, dtype)
    rh, rw = _tables(dev, 7, 9, 32, dtype)
    hw = (7, 9)
    bad = {
        "rows not 2h - 1": (rh[:-1].contiguous(), rw),
        "width not d": (rh, torch.zeros(17, 16, device=dev, dtype=dtype)),
        "grid swapped": (rw, rh),
        "dtype not q's": (rh.double(), rw),
        "not contiguous": (rh, torch.zeros(32, 17, device=dev,
                                           dtype=dtype).T),
        "on the CPU": (rh.cpu(), rw),
    }
    flat = torch.zeros(rw.numel() + 1, device=dev, dtype=dtype)
    bad["misaligned"] = (rh, flat[1:].view_as(rw).copy_(rw))
    for why, (a, b) in bad.items():
        with pytest.raises(ValueError):
            fr.flash_rpe_attention_cuda(q, k, v, a, b, hw)
            pytest.fail(why)
    fr.flash_rpe_attention_cuda(q, k, v, rh, rw, hw)  # the good ones pass


def _tail_inputs(dev, P, N, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=g, device=dev) * s

    return dict(keys=r(P, N, 256, s=0.5).to(dtype), hyper=r(P, 3, 32, s=0.5),
                w1=r(256, 256, s=0.05), b1=r(256, s=0.05),
                ln_scale=1.0 + r(256, s=0.1), ln_bias=r(256, s=0.1),
                w2=r(64, 128, s=0.1), b2=r(128, s=0.05))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N", [(3, 256), (2, 100), (4, 4096), (5, 64),
                                 (7, 144)])
def test_decode_tail_kernel_matches_plain(dev, dtype, P, N):
    # Counts atol 8 and boxes atol 4 px, as the JAX package holds its
    # kernel to its reference: float32 summation order, and the kernel's
    # bf16 hi / lo split products (float32-level accuracy), flip the
    # pixels whose logit lies within rounding of a threshold.  N = 64,
    # 100 and 144 leave a work item's tile (128 tokens for bf16 keys, 64
    # for float32) partly empty; P = 5 and 7 spread unevenly over the
    # persistent grid.
    inp = _tail_inputs(dev, P, N, dtype)
    kw = dict(mask_threshold=0.0, stability_offset=0.3)
    got = dt.decode_tail_stats_cuda(**inp, **kw)
    want = dt.decode_tail_stats_plain(**inp, **kw)
    torch.cuda.synchronize()
    for rows, atol in (((0, 1, 6), 8.0), ((2, 3, 4, 5), 4.0), ((7,), 0.0)):
        torch.testing.assert_close(got[:, list(rows)], want[:, list(rows)],
                                   atol=atol, rtol=0)


def _residuals(dev, N, dtype, seed=1):
    # In the keys' dtype, as the kernel takes them.
    g = torch.Generator(device=dev).manual_seed(seed)
    return dict(res1=(torch.randn(N, 256, generator=g, device=dev)
                      * 0.3).to(dtype),
                res0=(torch.randn(N, 512, generator=g, device=dev)
                      * 0.3).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,N", [(3, 256), (2, 100), (4, 4096), (5, 64)])
def test_decode_tail_kernel_with_residuals_matches_plain(dev, dtype, P, N):
    # SAM 2's form: one image's res1 / res0 added after each stage's bias,
    # read by every prompt.  The tolerances of the form without them.
    inp = _tail_inputs(dev, P, N, dtype)
    res = _residuals(dev, N, dtype)
    kw = dict(mask_threshold=0.0, stability_offset=0.3, **res)
    got = dt.decode_tail_stats_cuda(**inp, **kw)
    want = dt.decode_tail_stats_plain(**inp, **kw)
    bare = dt.decode_tail_stats_plain(**inp, mask_threshold=0.0,
                                      stability_offset=0.3)
    torch.cuda.synchronize()
    for rows, atol in (((0, 1, 6), 8.0), ((2, 3, 4, 5), 4.0), ((7,), 0.0)):
        torch.testing.assert_close(got[:, list(rows)], want[:, list(rows)],
                                   atol=atol, rtol=0)
    # The residuals move the statistics (they are read at all).
    assert (want[:, 6] != bare[:, 6]).any()


def test_decode_tail_refuses_residuals_it_does_not_take(dev):
    inp = _tail_inputs(dev, 2, 256, torch.bfloat16)
    res = _residuals(dev, 256, torch.bfloat16)
    for bad in ({"res1": res["res1"]}, {"res0": res["res0"]},
                {"res1": res["res1"][:128].contiguous(),
                 "res0": res["res0"][:128].contiguous()},
                {"res1": res["res1"].float(), "res0": res["res0"]},
                {"res1": res["res1"], "res0": res["res0"].reshape(
                    256, 4, 128)}):
        with pytest.raises(ValueError):
            dt.decode_tail_stats_cuda(**inp, **bad)


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


def _bwd_inputs(dev, B, N, d, dtype, ties="none", seed=0):
    """Index fields, the winners that K2 writes for them, a cotangent."""
    d_idx, a_idx, Md, Ma, bias = _geo_inputs(dev, B, N, d, dtype, seed)
    if ties == "some":  # k=1 repeats k=0; k=2 too on every other row
        a_idx[..., 1] = a_idx[..., 0]
        a_idx[:, ::2, :, 2] = a_idx[:, ::2, :, 0]
    elif ties == "all":
        a_idx = a_idx[..., :1].expand_as(a_idx).contiguous()
    a_idx = a_idx.contiguous()
    _, win = ge.geo_embed_maxk_cuda(d_idx, a_idx, Md, Ma, bias, 20.0, 12.0,
                                    dtype, winners=True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cot = torch.randn(B, N, N, d, generator=g, device=dev).to(dtype)
    return d_idx, a_idx, win, cot


@pytest.mark.parametrize("ties", ["none", "some", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,d", [(2, 33, 32), (1, 197, 256), (3, 7, 64)])
def test_geo_embed_bwd_kernel_matches_plain(dev, ties, dtype, B, N, d):
    # Both sides read the same winners (K2's).  bfloat16: the same
    # bf16 operands and float32 sums in another order, the outputs
    # compared in float32: 1e-3.  float32: the kernel's split products
    # hi.hi + hi.lo + lo.hi + lo.lo are each operand to 2^-17 relative,
    # so besides the order of the sums it differs from float32 products
    # by ~1e-6: 1e-5 where every channel is an exact three-way tie (as
    # before), 1e-3 otherwise.  The pair counts (2178, 38809, 147) are
    # not multiples of the 64-pair tile.
    rtol = 1e-5 if ties == "all" else 1e-3
    args = (*_bwd_inputs(dev, B, N, d, dtype, ties), 20.0, 12.0)
    got = ge.geo_embed_maxk_bwd_cuda(*args)
    again = ge.geo_embed_maxk_bwd_cuda(*args)
    want = ge.geo_embed_maxk_bwd_plain(*args, 40)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b)  # a fixed order of sums: the same bits
        assert float((a - w).norm() / w.norm()) <= rtol


def test_scatter_rows_kernel_matches_plain(dev):
    # Each target's rows summed in ascending q from 0.0f: the same bits in
    # every launch, and the bits of the CPU's sequential index_add_.
    B, N, S, C = 4, 2048, 64, 32
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, N, (B, N * S), generator=g, device=dev)
    idx[torch.rand(B, N * S, generator=g, device=dev) < 0.05] = -1
    dy = torch.randn(B, N * S, C, generator=g, device=dev).bfloat16()
    for d in (dy, dy.float()):
        got = sr.scatter_rows_cuda(idx, d, N)
        again = sr.scatter_rows_cuda(idx, d, N)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(),
                           sr.scatter_rows_plain(idx.cpu(), d.cpu(), N))


def _scatter_case(dev, case, B=4, N=2048):
    """(idx on the card, N): the positional encoding's ball-query indices
    at both scales; those at S = 64 with 3000 and 2500 of each batch item's
    rows sent to two mid-range targets (each target then spans several sum
    units beside targets of their own rows); every row to one target;
    every row dropped."""
    if case.startswith("ball_query") or case == "two_long":
        S = 32 if case == "ball_query_32" else 64
        pts = torch.from_numpy(synthetic_clouds(B, N, seed=S)).to(dev)
        idx = ball_query_rows(pts, 0.1 if S == 32 else 0.2, S)
        if case == "two_long":
            g = torch.Generator().manual_seed(4)
            for b in range(B):
                rows = torch.randperm(idx.shape[1], generator=g)[:5500]
                idx[b, rows[:3000].to(dev)] = 700
                idx[b, rows[3000:].to(dev)] = 1400
        return idx, N
    idx = torch.full((B, N * 8), 5, dtype=torch.long, device=dev)
    if case == "all_dropped":
        idx[:, ::2] = -1
        idx[:, 1::2] = N
    return idx, N


SCATTER_CASES = ["ball_query_32", "ball_query_64", "two_long", "one_target",
                 "all_dropped"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", SCATTER_CASES)
def test_scatter_rows_kernel_on_skewed_indices(dev, case, dtype):
    idx, N = _scatter_case(dev, case)
    g = torch.Generator(device=dev).manual_seed(1)
    dy = torch.randn(*idx.shape, 32, generator=g, device=dev).to(dtype)
    got = sr.scatter_rows_cuda(idx, dy, N)
    again = sr.scatter_rows_cuda(idx, dy, N)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    cpu_idx = idx.cpu()
    want = sr.scatter_rows_plain(cpu_idx.where(cpu_idx < N, -1), dy.cpu(), N)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("case", SCATTER_CASES + ["uniform", "ragged"])
def test_scatter_rows_inverse_index_matches_plain(dev, case):
    if case == "uniform":
        g = torch.Generator(device=dev).manual_seed(2)
        idx = torch.randint(-3, 2051, (3, 2048 * 32), generator=g, device=dev)
        N = 2048
    elif case == "ragged":  # Q and N off every tile and warp multiple
        g = torch.Generator(device=dev).manual_seed(3)
        idx = torch.randint(-1, 38, (5, 9001), generator=g, device=dev)
        N = 37
    else:
        idx, N = _scatter_case(dev, case)
    offsets, perm = sr.inverse_index_cuda(idx, N)
    torch.cuda.synchronize()
    want_off, want_perm = sr.inverse_index_plain(idx.cpu(), N)
    assert torch.equal(offsets.cpu(), want_off)
    assert torch.equal(perm.cpu(), want_perm)


def test_training_wrappers_refuse_what_the_kernels_do_not_take(dev):
    d_idx, a_idx, win, cot = _bwd_inputs(dev, 1, 9, 32, torch.float32)
    with pytest.raises(ValueError):  # winners of another dtype
        ge.geo_embed_maxk_bwd_cuda(d_idx, a_idx, win.int(), cot, 20.0, 12.0)
    with pytest.raises(ValueError):  # k = 2
        ge.geo_embed_maxk_bwd_cuda(d_idx, a_idx[..., :2].contiguous(), win,
                                   cot, 20.0, 12.0)
    with pytest.raises(ValueError):  # d = 48
        ge.geo_embed_maxk_bwd_cuda(d_idx, a_idx,
                                   win[..., :16].repeat(1, 1, 1, 3),
                                   cot[..., :16].repeat(1, 1, 1, 3), 20.0,
                                   12.0)
    idx = torch.zeros(1, 8, dtype=torch.long, device=dev)
    dy = torch.zeros(1, 8, 4, device=dev)
    with pytest.raises(ValueError):  # int32 indices
        sr.scatter_rows_cuda(idx.int(), dy, 4)
    with pytest.raises(ValueError):  # odd channel count
        sr.scatter_rows_cuda(idx, dy[..., :3].contiguous(), 4)
    flat = torch.zeros(8 * 4 + 1, device=dev)
    with pytest.raises(ValueError):  # 4 bytes off the 8-byte alignment
        sr.scatter_rows_cuda(idx, flat[1:].view(1, 8, 4), 4)


def test_embedding_gradient_reaches_the_projections_through_k3(dev):
    """A loss backpropagated through the embedding on the card gives
    proj_d and proj_a the gradient of the whole fused op (K3), not only of
    the sentinel rows: the same gradients as the CPU's plain backward."""
    cfg = GeoEmbeddingConfig(hidden_dim=32, fused="on")
    mod = GeometricStructureEmbedding(cfg)
    init_random_(mod, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    pts = torch.rand(2, 33, 3, generator=g) * 2 - 1
    pts[:, 0] = 100.0
    cot = torch.randn(2, 33, 33, 32, generator=g)
    grads = []
    for device in ("cpu", dev):
        mod = mod.to(device)
        mod.zero_grad()
        before = ge.KERNEL_BWD.launches
        (mod(pts.to(device)) * cot.to(device)).sum().backward()
        if device != "cpu":
            assert ge.KERNEL_BWD.launches == before + 1
        grads.append({n: p.grad.detach().cpu().clone()
                      for n, p in mod.named_parameters()})
    cpu, card = grads
    for n, w in cpu.items():
        # Fused on both devices; the diagonal's distance index differs
        # between the two devices' matmuls (see the test above): 1e-3.
        assert float((card[n] - w).norm() / w.norm()) <= 1e-3, n


def test_demo_pem_stage_on_the_card(dev, tmp_path, monkeypatch):
    """The demo's render and PEM stages on the card at the tiny PEM config:
    the example scene's own detection gives one pose, through K1 (the
    onboarding and the request) and K2."""
    import json

    from chip_smoke import tiny_pem_config, write_gt_detection
    from sam6d_tpu_torch.pipeline import demo
    from sam6d_tpu_torch.pipeline.make_example import make_example
    from sam6d_tpu_torch.utils.png import read_png

    cad = make_example(str(tmp_path))
    write_gt_detection(str(tmp_path), str(tmp_path / "detection_ism.json"))
    monkeypatch.setattr(demo, "default_pem_config", tiny_pem_config)
    before = fps_mod.KERNEL.launches, ge.KERNEL.launches
    demo.main(["--cad_path", cad, "--rgb_path", str(tmp_path / "rgb.png"),
               "--depth_path", str(tmp_path / "depth.png"),
               "--cam_path", str(tmp_path / "camera.json"),
               "--output_dir", str(tmp_path), "--stages", "render,pem",
               "--template_size", "96", "--device", "cuda"])
    assert fps_mod.KERNEL.launches >= before[0] + 2
    assert ge.KERNEL.launches > before[1]
    rows = json.loads((tmp_path / "detection_pem.json").read_text())
    assert len(rows) == 1
    R = np.array(rows[0]["R"]).reshape(3, 3)
    assert abs(np.linalg.det(R) - 1.0) < 1e-2
    assert np.isfinite(rows[0]["t"]).all()
    assert read_png(str(tmp_path / "vis_pem.png")).shape == (480, 640, 3)


def test_tiny_fastsam_on_the_card_matches_the_cpu(dev):
    """FastSAM at the "n" scale and 160 px: the head outputs within 1e-4
    of the CPU's and the same proposals (chip_smoke.check_tiny_fastsam
    raises otherwise)."""
    from chip_smoke import check_tiny_fastsam

    assert check_tiny_fastsam(dev)["proposals"] > 3


TINY_HIERA = dict(embed_dim=16, num_heads=1, stages=(1, 2, 2, 1),
                  global_att_blocks=(4,), window_spec=(4, 2, 4, 2))


@torch.no_grad()
def test_tiny_sam2_on_the_card_matches_the_cpu(dev):
    """SAM 2 with a tiny Hiera at 128 px, float32: the encoding within
    1e-4 (relative) of the CPU's (summation order; every block's K5 on
    the card, none plain), and the generator's fused route on the card
    (K9 at T = 8, K6 with the residuals) gives masks and boxes of the
    frame's size."""
    from sam6d_tpu_torch.config import SegmentorConfig
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam2.model import SAM2
    from sam6d_tpu_torch.ops import decode_tail as dtail
    from sam6d_tpu_torch.ops import two_way as tw
    from sam6d_tpu_torch.utils import timer

    cpu = SAM2(img_size=128, trunk_kwargs=TINY_HIERA, device="cpu")
    init_random_(cpu, torch.Generator().manual_seed(4))
    card = SAM2(img_size=128, trunk_kwargs=TINY_HIERA, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(5)
    image = torch.from_numpy((rng.rand(96, 128, 3) * 255).astype(np.uint8))
    feats = []
    for m in (cpu, card):
        x, _, _ = m.preprocess(image.to(m.device))
        with timer.recording() as rec:
            feats.append(m.encode(x[None]))
        rows = {n: 0 for n in ("window", "pooled", "global", "plain")}
        for name, n, _, _ in rec.counts:
            rows[name.rsplit("_", 1)[-1]] += n
        assert (rows["plain"] == 0) == (m is card), rows
    for c, g in zip(feats[0][:3], feats[1][:3]):
        assert float((g.cpu() - c).norm() / c.norm()) < 1e-4
    seg = SegmentorConfig(model_type="sam2.1_hiera_l", points_per_side=4,
                          points_per_batch=8, pred_iou_thresh=-1e9,
                          stability_score_thresh=-1e9,
                          segmentor_width_size=0)
    k6, k9 = dtail.KERNEL.launches, tw.KERNEL.launches
    out = SamAutomaticMaskGenerator(card, seg).generate_masks(
        image.numpy())
    assert dtail.KERNEL.launches == k6 + 1 and tw.KERNEL.launches == k9 + 4
    n = len(out["masks"])
    assert n > 0 and out["masks"].shape == (n, 96, 128)
    b = out["boxes"]
    assert (b[:, 0::2] <= 127).all() and (b[:, 1::2] <= 95).all()


def test_device_prefetcher_batches_equal_the_hosts(dev):
    """DevicePrefetcher copies on a side stream; once the consumer's
    stream has waited on the copy's event, each tensor equals its host
    array (read on the consumer's stream, as the step reads it)."""
    from sam6d_tpu_torch.train.solver import DevicePrefetcher

    rng = np.random.RandomState(0)
    host = [{"rgb": rng.randint(0, 256, (4, 224, 224, 3)).astype(np.uint8),
             "pts": rng.randn(4, 2048, 3).astype(np.float32),
             "choose": rng.randint(0, 50176, (4, 2048)).astype(np.int32)}
            for _ in range(6)]
    pf = DevicePrefetcher(iter(host), device=dev, depth=2)
    try:
        got = []
        for b in pf:
            assert all(t.device.type == "cuda" for t in b.values())
            # Work on the consumer's stream, as a step would do.
            got.append({k: (t * 1).cpu() for k, t in b.items()})
    finally:
        pf.close()
    assert len(got) == len(host)
    for g, h in zip(got, host):
        for k in h:
            np.testing.assert_array_equal(g[k].numpy(), h[k])


def test_rendered_stream_feeds_a_tiny_train_step_on_the_card(dev):
    """RenderedPoseDataset(uint8_rgb) -> ProcessSampleStream (forked numpy
    workers) -> DevicePrefetcher -> train_step at the tiny config: uint8
    planes reach the card and are normalised there, K1, K2, K3 and K7
    launch, the metrics are finite, and no worker outlives close()."""
    import math

    from chip_smoke import tiny_pem_config
    from sam6d_tpu_torch.config import OptimConfig, TrainConfig
    from sam6d_tpu_torch.provider.training_dataset import RenderedPoseDataset
    from sam6d_tpu_torch.train.solver import (
        DevicePrefetcher,
        ProcessSampleStream,
    )
    from sam6d_tpu_torch.train.state import create_train_state, train_step

    cfg = TrainConfig(batch_size=2, img_size=32, n_sample_observed_point=64,
                      n_sample_template_point=48)
    ds = RenderedPoseDataset(cfg, n_objects=2, n_template_views=3,
                             frame_size=64, uint8_rgb=True)
    state = create_train_state(tiny_pem_config(), OptimConfig(), device=dev,
                               seed=0)
    stream = ProcessSampleStream(ds, 2, n_workers=2, depth=2)
    pf = DevicePrefetcher(stream, device=dev)
    kernels = [fps_mod.KERNEL, ge.KERNEL, ge.KERNEL_BWD, sr.KERNEL]
    before = [k.launches for k in kernels]
    try:
        it = iter(pf)
        for _ in range(2):
            batch = next(it)
            assert batch["rgb"].dtype == torch.uint8
            assert batch["rgb"].device.type == "cuda"
            m = train_step(state, batch, torch.Generator(device=dev).manual_seed(0))
            assert all(math.isfinite(v) for v in m.values()), m
    finally:
        pf.close()
        stream.close()
    assert all(k.launches > n for k, n in zip(kernels, before))
    assert not any(p.is_alive() for p in stream.workers)


# -- K4 / K5 are forward-only: training must not lose gradients ------------


def test_flash_kernels_refuse_a_gradient(dev):
    """K4 and K5 make no autograd node: under grad mode with an input that
    requires a gradient the wrappers raise; under no_grad they serve."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(4, 64, 32, device=dev, generator=g)
               for _ in range(3))
    rh = torch.randn(15, 32, device=dev, generator=g)
    rw = torch.randn(15, 32, device=dev, generator=g)
    for req in ("q", "k", "v", "rel_pos_h"):
        args = dict(q=q, k=k, v=v, rel_pos_h=rh, rel_pos_w=rw)
        args[req] = args[req].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            fr.flash_rpe_attention(**args, hw=(8, 8))
        if req != "rel_pos_h":
            with pytest.raises(RuntimeError, match="forward-only"):
                fr.flash_attention(args["q"], args["k"], args["v"])
        with torch.no_grad():  # serving: no gradient wanted
            fr.flash_rpe_attention(**args, hw=(8, 8))
            fr.flash_attention(args["q"], args["k"], args["v"])


def test_tiny_models_train_on_the_card_as_on_the_cpu(dev):
    """The tiny SAM (flash=False; its decoder's K9 launches, with the plain
    version's backward) and descriptor (use_flash=False) on a
    training batch of their tools (phase 11c's), held to the CPU by
    chip_smoke.grads_card_vs_cpu: the loss 1e-4; every parameter that the
    CPU's loss reaches has a finite gradient on the card, within 1e-3
    relative (Frobenius) of the CPU's plus 1e-6 absolute for the leaves
    whose gradient is zero in exact arithmetic (an attention's key bias
    shifts a whole softmax row: float noise on both devices); the serving
    builds refuse a gradient."""
    from chip_smoke import grads_card_vs_cpu
    from sam6d_tpu_torch.models.ism.detector import normalize_rgb
    from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh
    from sam6d_tpu_torch.ops import two_way
    from sam6d_tpu_torch.tools import train_ism_descriptor as t_desc
    from sam6d_tpu_torch.tools import train_tiny_sam as t_sam

    rng = np.random.RandomState(11)
    meshes = [make_procedural_mesh(rng) for _ in range(16)]
    imgs, pts, gts = (torch.from_numpy(a) for a in
                      t_sam.make_training_batch(meshes, rng, B=8, P=8))
    rng = np.random.RandomState(0)
    pools = t_desc.render_pools(32, 8, 64, rng)
    x = normalize_rgb(torch.from_numpy(t_desc.make_batch(pools, rng, 24)))
    grads_card_vs_cpu(
        dev, t_sam.make_tiny_sam(device="cpu", flash=False),
        lambda m, d: t_sam.sam_loss(m, imgs.to(d), pts.to(d), gts.to(d))[0],
        "tiny SAM (flash=False)", kernels=(two_way.KERNEL,))
    grads_card_vs_cpu(
        dev, t_desc.make_descriptor(t_desc.tiny_descriptor_config(), "cpu"),
        lambda m, d: t_desc.nt_xent(m.vit(x.to(d))[0], 0.1)[0],
        "tiny descriptor (use_flash=False)")
    serving = t_sam.make_tiny_sam(device=dev, flash=None)
    with pytest.raises(RuntimeError, match="forward-only"):
        t_sam.sam_loss(serving, imgs.to(dev), pts.to(dev), gts.to(dev))
    served = t_desc.make_descriptor(t_desc.tiny_descriptor_config(), dev,
                                    use_flash=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        served.vit(x.to(dev))


def _procrustes_case(case, dev):
    """`procrustes_cases.procrustes_case` as tensors on dev, with its numpy
    inputs."""
    arrays = procrustes_case(case, np.random.RandomState(len(case)))
    return arrays, tuple(
        x if x is None or isinstance(x, float)
        else torch.from_numpy(x).to(dev) for x in arrays)


def _hold_procrustes(case, src, R, t, Rw, tw):
    """R, t against a reference's Rw, tw within 1e-5.  A rank-1 H leaves R
    free about the line; there the line's image and t are held (what the
    sets determine)."""
    torch.testing.assert_close(t, tw, atol=1e-5, rtol=0)
    if case == "fine_rank1":
        line = src[..., 1, :] - src[..., 0, :]
        line = (line / line.norm(dim=-1, keepdim=True))[..., None]
        torch.testing.assert_close(R @ line, Rw @ line, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(R, Rw, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", PROCRUSTES_CASES)
def test_procrustes_kernel_matches_plain(dev, case):
    """K8 through `weighted_procrustes` against the plain version on the
    same card: R and t within 1e-5; det(R) = 1 within 1e-5 wherever the
    plain version's is (a near-collinear triplet's s3 sits at float32
    noise, about 1e-4 s1, the rank test's own threshold: where noise
    passes it, U comes out off orthonormal in the plain version too).  A
    rank-1 H leaves R free about the line; the thread route sums as the
    plain version does and gives its R, the block route sums in another
    order (`_hold_procrustes`)."""
    from sam6d_tpu_torch.ops import procrustes as pr

    _, (src, ref, weights, thresh) = _procrustes_case(case, dev)
    launches = pr.KERNEL.launches
    with torch.no_grad():
        R, t = pr.weighted_procrustes(src, ref, weights, thresh)
    Rp, tp = pr.weighted_procrustes_plain(src, ref, weights, thresh)
    torch.cuda.synchronize()
    assert pr.KERNEL.launches == launches + 1
    assert R.shape == Rp.shape and t.shape == tp.shape
    det = np.linalg.det(R.double().cpu().numpy())
    proper = np.abs(np.linalg.det(Rp.double().cpu().numpy()) - 1.0) <= 1e-5
    assert proper.mean() > 0.99
    assert np.abs(det[proper] - 1.0).max() <= 1e-5
    _hold_procrustes(case, src, R, t, Rp, tp)


@pytest.mark.parametrize("case", ["coarse", "fine"])
def test_procrustes_kernel_matches_the_jax_package(dev, case):
    """K8's R and t, copied to the CPU, against the JAX package's
    `weighted_procrustes` on the same numpy inputs: the fine solve's 3
    problems of 2048 weighted correspondences within 1e-5; the coarse
    solve's (4, 6000) triplets with a median difference under 1e-6, 90%
    of them within 1e-5 and 95% within 1e-4.  Not every triplet: the
    reference's float32 solve of three points moves by more than 1e-5 on
    about 8% of random triplets when only the order of a 3-term sum
    changes, and the card's reductions (which K8 follows) sum a 3-long
    last dim as (x0 + x2) + x1, the CPU's in turn.  The JAX package runs
    on the CPU alone, and the test skips where jax is not installed or
    has already taken another platform; the CPU tests hold the plain
    version to the JAX package on these inputs, per problem."""
    try:
        import jax
    except ImportError:
        pytest.skip("the JAX package needs jax, which this machine lacks")
    jax.config.update("jax_platforms", "cpu")
    if jax.default_backend() != "cpu":
        pytest.skip("jax already runs on another platform than the CPU")
    import jax.numpy as jnp
    from sam6d_tpu.ops import procrustes as jpr
    from sam6d_tpu_torch.ops import procrustes as pr

    (src_np, ref_np, w_np, thresh), (src, ref, weights, _) = (
        _procrustes_case(case, dev))
    with torch.no_grad():
        R, t = pr.weighted_procrustes(src, ref, weights, thresh)
    Rj, tj = (torch.tensor(np.asarray(x)) for x in jpr.weighted_procrustes(
        jnp.asarray(src_np), jnp.asarray(ref_np),
        None if w_np is None else jnp.asarray(w_np), thresh))
    R, t = R.cpu(), t.cpu()
    if case == "fine":
        _hold_procrustes(case, src.cpu(), R, t, Rj, tj)
        return
    err = torch.maximum((R - Rj).abs().flatten(-2).amax(-1),
                        (t - tj).abs().amax(-1)).flatten()
    shares = (float(err.median()), float((err <= 1e-5).float().mean()),
              float((err <= 1e-4).float().mean()))
    assert shares[0] <= 1e-6 and shares[1] >= 0.90 and shares[2] >= 0.95, (
        f"median {shares[0]}, within 1e-5 {shares[1]}, within 1e-4 "
        f"{shares[2]}")


@pytest.mark.parametrize("with_field", [False, True])
def test_coarse_solve_picks_the_plain_versions_hypothesis(dev, monkeypatch,
                                                          with_field):
    """compute_coarse_Rt at the bin's widths (196 x 196 points, 6000
    hypotheses, 300 kept) with injected uniforms, once through K8 and once
    through the plain version: the same winning pose."""
    from sam6d_tpu_torch.models.pem import matching
    from sam6d_tpu_torch.ops import procrustes as pr
    from sam6d_tpu_torch.ops.distance_field import build_min_dist_field

    rng = np.random.RandomState(7)
    B, N = 4, 196
    t_ = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    atten = t_(3.0 * rng.randn(B, 1 + N, 1 + N))
    pts1, pts2 = t_(0.3 * rng.randn(B, N, 3)), t_(0.3 * rng.randn(B, N, 3))
    model = t_(0.3 * rng.randn(B, 1024, 3))
    u = (t_(rng.rand(B, 18000, 1)), t_(rng.rand(B, 18000, 1)))
    field = build_min_dist_field(model) if with_field else None

    def solve():
        with torch.no_grad():
            return matching.compute_coarse_Rt(
                atten, pts1, pts2, model, 6000, 300, dist_field=field,
                uniforms=u, return_score=True)

    launches = pr.KERNEL.launches
    got = solve()
    assert pr.KERNEL.launches == launches + 1
    monkeypatch.setattr(matching, "weighted_procrustes",
                        pr.weighted_procrustes_plain)
    want = solve()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def test_procrustes_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sam6d_tpu_torch.ops import procrustes as pr

    pts = torch.randn(5, 3, 3, device=dev)
    w = torch.rand(5, 3, device=dev)
    with pytest.raises(ValueError):  # float64 points
        pr.procrustes_cuda(pts.double(), pts.double())
    with pytest.raises(ValueError):  # bf16 weights
        pr.procrustes_cuda(pts, pts, w.bfloat16())
    with pytest.raises(ValueError):  # not contiguous
        pr.procrustes_cuda(pts.transpose(1, 2), pts)
    with pytest.raises(ValueError):  # (..., N, 3) of rank 4
        pr.procrustes_cuda(pts[None], pts[None])
    with pytest.raises(ValueError):  # weights of rank 1
        pr.procrustes_cuda(pts, pts, w[0])
    with pytest.raises(ValueError):  # four coordinates
        pr.procrustes_cuda(torch.randn(5, 3, 4, device=dev),
                           torch.randn(5, 3, 4, device=dev))
    with pytest.raises(ValueError):  # points of two shapes
        pr.procrustes_cuda(pts, pts[:4])


def test_procrustes_refuses_a_gradient(dev):
    """K8 makes no autograd node: on the card, under grad mode with an
    input that requires a gradient, `weighted_procrustes` raises rather
    than computing the plain version; under no_grad it serves."""
    from sam6d_tpu_torch.ops import procrustes as pr

    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randn(6, 3, 3, device=dev, generator=g)
    ref = torch.randn(6, 3, 3, device=dev, generator=g)
    w = torch.rand(6, 3, device=dev, generator=g)
    launches = pr.KERNEL.launches
    for req in range(3):
        args = [src, ref, w]
        args[req] = args[req].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="forward-only"):
            pr.weighted_procrustes(*args)
        with torch.no_grad():
            R, t = pr.weighted_procrustes(*args)
        assert not R.requires_grad and not t.requires_grad
    assert pr.KERNEL.launches == launches + 3
    Rp, tp = pr.weighted_procrustes_plain(src, ref, w)
    torch.testing.assert_close(R, Rp, atol=1e-5, rtol=0)
    torch.testing.assert_close(t, tp, atol=1e-5, rtol=0)


# K9 at the cell's two call forms (64 grid prompts over 4096 rows: the
# first block's batch-1 float32 image side, the second's bf16 keys of
# batch 64), at tiny SAM's 576 rows, at T = 9 (more than one n-tile of
# tokens), at T = 33 and 70 (three and five chunks of 16 tokens under the
# running softmax, 70 past the 64 a build once took) on ragged tiles, and
# at one prompt; SAM 2's two call forms at T = 8 (its object-score token
# ahead of SAM's seven).
TWO_WAY_CASES = [(64, 4096, 7, 1), (64, 4096, 7, 64), (64, 576, 7, 1),
                 (5, 576, 9, 5), (3, 4096, 9, 1), (2, 100, 33, 2),
                 (2, 100, 70, 2), (3, 576, 70, 1), (1, 64, 7, 1),
                 (64, 4096, 8, 1), (64, 4096, 8, 64)]


def _two_way_case(dev, B, N, T, Bk, dtype):
    from two_way_cases import op_case

    _, _, keys, key_pe, k_tok, v_tok, _, _, w = op_case(
        B, N, T, Bk, dtype, device=dev)
    return keys, key_pe, k_tok, v_tok, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,T,Bk", TWO_WAY_CASES)
@torch.no_grad()
def test_two_way_kernel_matches_plain(dev, dtype, B, N, T, Bk):
    # The same rounding points in the same dtype; the sums' order differs,
    # so a bf16 result may differ from the plain version's by an ulp where
    # a float32 sum lies near a rounding boundary, and that flip carries
    # through the later products.  float32: summation order alone.
    from sam6d_tpu_torch.ops import two_way as tw

    keys, key_pe, k_tok, v_tok, w = _two_way_case(dev, B, N, T, Bk, dtype)
    launches = tw.KERNEL.launches
    got = tw.two_way_keys(keys, key_pe, k_tok, v_tok, w, dtype)
    want = tw.two_way_keys_plain(keys, key_pe, k_tok, v_tok, w, dtype)
    torch.cuda.synchronize()
    assert tw.KERNEL.launches == launches + 1
    rel, tol = (4e-3, 3e-2) if dtype == torch.bfloat16 else (2e-6, 1e-4)
    for g, x in zip(got, want):
        assert g.dtype == dtype and g.shape == x.shape
        assert float((g.float() - x.float()).norm() / x.float().norm()) < rel
        torch.testing.assert_close(g.float(), x.float(), atol=tol, rtol=tol)


@torch.no_grad()
def test_two_way_kernel_takes_bf16_keys_of_batch_one(dev):
    # Keys of batch 1 in bf16 (no serving path makes them, the kernel
    # takes them) and float32 keys of batch B under a bf16 compute dtype
    # (a mask prompt's first block).
    from sam6d_tpu_torch.ops import two_way as tw

    for Bk, kd in ((1, torch.bfloat16), (4, torch.float32)):
        keys, key_pe, k_tok, v_tok, w = _two_way_case(dev, 4, 576, 7, Bk,
                                                      torch.bfloat16)
        keys = keys.to(kd)
        got = tw.two_way_keys(keys, key_pe, k_tok, v_tok, w, torch.bfloat16)
        want = tw.two_way_keys_plain(keys, key_pe, k_tok, v_tok, w,
                                     torch.bfloat16)
        for g, x in zip(got, want):
            assert float((g.float() - x.float()).norm()
                         / x.float().norm()) < 4e-3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@torch.no_grad()
def test_two_way_kernel_serves_the_transformer(dev, dtype):
    # Two launches a transformer_forward; tokens and keys near the
    # transformer as it was written before the kernel, on the card.
    from two_way_cases import (fill_, parent_transformer, transformer,
                               transformer_inputs)

    from sam6d_tpu_torch.models.ism.sam.decoder import MaskDecoder
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.ops import two_way as tw

    t = transformer(dtype, device=dev)
    emb, pe, tokens = transformer_inputs(64, 4096, 7, 1, device=dev)
    launches = tw.KERNEL.launches
    got = t(emb, pe, tokens)
    assert tw.KERNEL.launches == launches + 2
    want = parent_transformer(t, emb, pe, tokens)
    rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for g, x in zip(got, want):
        assert float((g.float() - x.float()).norm() / x.float().norm()) < rel
    g = torch.Generator().manual_seed(3)
    dec = cast_dense_weights(fill_(MaskDecoder(dtype=dtype), g).eval()).to(dev)
    launches = tw.KERNEL.launches
    dec.transformer_forward(emb, pe, tokens[:, :2], torch.zeros(
        1, 1, 1, 256, device=dev))
    assert tw.KERNEL.launches == launches + 2


def test_two_way_wrapper_refuses_what_the_kernel_does_not_take(dev):
    from sam6d_tpu_torch.ops import two_way as tw

    bf = torch.bfloat16
    keys, key_pe, k_tok, v_tok, w = _two_way_case(dev, 3, 64, 7, 3, bf)
    pe = key_pe.reshape(64, 256)
    run = tw.two_way_keys_cuda
    with torch.no_grad():
        run(keys, pe, k_tok, v_tok, w, bf)  # takes these
        with pytest.raises(ValueError):  # float16 compute
            run(keys.half(), pe, k_tok.half(), v_tok.half(), w,
                torch.float16)
        with pytest.raises(ValueError):  # bf16 keys, float32 compute
            run(keys, pe, k_tok.float(), v_tok.float(), w, torch.float32)
        with pytest.raises(ValueError):  # a batch neither 1 nor B
            run(keys[:2], pe, k_tok, v_tok, w, bf)
        with pytest.raises(ValueError):  # 128 channels
            run(keys[..., :128].contiguous(), pe, k_tok, v_tok, w, bf)
        with pytest.raises(ValueError):  # not contiguous
            run(keys.transpose(0, 1).contiguous().transpose(0, 1), pe, k_tok,
                v_tok, w, bf)
        with pytest.raises(ValueError):  # bf16 positional encoding
            run(keys, pe.to(bf), k_tok, v_tok, w, bf)
        none = torch.zeros(3, 0, 128, device=dev, dtype=bf)
        with pytest.raises(ValueError):  # a prompt of no tokens
            run(keys, pe, none, none, w, bf)
        with pytest.raises(ValueError):  # the tokens of another width
            run(keys, pe, k_tok[..., :64].contiguous(), v_tok, w, bf)
        with pytest.raises(ValueError):  # a transposed projection
            run(keys, pe, k_tok, v_tok, w._replace(wo=w.wq), bf)
        with pytest.raises(ValueError):  # on the CPU
            run(keys.cpu(), pe, k_tok, v_tok, w, bf)
    with pytest.raises(RuntimeError, match="forward-only"):
        run(keys, pe, k_tok, v_tok, w, bf)  # the weights want a gradient


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_way_kernel_trains_through_a_decode(dev, dtype, monkeypatch):
    # On the card `two_way_keys` launches whether or not a gradient is
    # wanted: a decode whose weights want one, outside no_grad, launches
    # K9 twice, and its backward (the plain version's, recomputed) gives
    # the weights the gradients of the same decode run on plain ops on the
    # card, up to the forwards' rounding differences.
    from two_way_cases import fill_, transformer_inputs

    from sam6d_tpu_torch.models.ism.sam import decoder
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.ops import two_way as tw

    emb, pe, tokens = transformer_inputs(4, 576, 7, 1, device=dev)
    dense = torch.zeros(1, 1, 1, 256, device=dev)
    g = torch.Generator().manual_seed(3)
    dec = cast_dense_weights(fill_(decoder.MaskDecoder(dtype=dtype),
                                   g)).to(dev)

    def grads():
        dec.zero_grad(set_to_none=True)
        keys, hyper, iou = dec.transformer_forward(emb, pe, tokens, dense)
        (keys.float().square().mean() + hyper.float().square().mean()
         + iou.float().sum()).backward()
        return {n: p.grad.float() for n, p in dec.named_parameters()
                if p.grad is not None}

    launches = tw.KERNEL.launches
    got = grads()
    assert tw.KERNEL.launches == launches + 2
    monkeypatch.setattr(decoder, "two_way_keys", tw.two_way_keys_plain)
    want = grads()
    assert tw.KERNEL.launches == launches + 2
    assert set(got) == set(want)
    assert all(bool(torch.isfinite(x).all()) for x in got.values())
    # An attention's key bias adds one logit to a whole softmax row: its
    # gradient is zero in exact arithmetic and float noise on both routes
    # (as `grads_card_vs_cpu` allows), so it is not compared.
    errs = {n: float((got[n] - w).norm() / w.norm())
            for n, w in want.items()
            if not n.endswith("k_proj.bias") and float(w.norm()) > 0}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"two_way gradients, {dtype}: {len(errs)} compared, worst {worst}")
    # float32: the backward itself (1.1e-6 measured on an H100).  bf16:
    # the two forwards round apart (an ulp flip in kp or vp moves the
    # tokens by about 1e-2, and the hypernetworks' gradients by up to 7.5%),
    # so the bar there catches a wrong backward, whose errors are of order 1.
    assert worst[0][1] < (0.2 if dtype == torch.bfloat16 else 1e-5)
