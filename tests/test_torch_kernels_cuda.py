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
