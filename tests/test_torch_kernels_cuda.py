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
