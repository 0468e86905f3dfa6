"""Furthest point sampling (FPS).

Counterpart of `sam6d_tpu/ops/fps.py`.  `furthest_point_sample` launches
the CUDA kernel `csrc/fps.cu` for a tensor on the card and computes the
plain PyTorch version `fps_plain` (a mirror of the JAX oracle `_fps_xla`)
for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr
from sam6d_tpu_torch.ops.pointcloud import gather_points

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "fps", "fps.cu",
    replaces="sam6d_tpu/ops/pallas/fps_kernel.py:117",
    signatures={"fps_launch": [_V, _V, _V, _I, _I, _I, _I, _I, _V]},
)

# Largest row whose points and distance field (16 B a point) the kernel
# keeps in shared memory; the card allows 227 KB a block.
SHARED_BYTES = 200 * 1024


def fps_plain(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative max-min selection; (B, N, 3) -> (B, npoint) int64.

    The first index is 0, the field starts at +inf, and argmax ties go
    to the lowest index.  d2 sums the squared components in the order
    (dx^2 + dy^2) + dz^2, as the oracle does.
    """
    B, N, _ = pts.shape
    pts = pts.float()
    px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
    rows = torch.arange(B, device=pts.device)
    dists = torch.full((B, N), float("inf"), device=pts.device)
    out = torch.zeros((B, npoint), dtype=torch.long, device=pts.device)
    last = out[:, 0]
    for i in range(1, npoint):
        dx = px - px[rows, last][:, None]
        dy = py - py[rows, last][:, None]
        dz = pz - pz[rows, last][:, None]
        d2 = dx * dx + dy * dy + dz * dz
        dists = torch.minimum(dists, d2)
        last = torch.argmax(dists, dim=1)
        out[:, i] = last
    return out


def fps_cuda(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    check_cuda(pts, "pts", torch.float32, ndim=3)
    B, N, C = pts.shape
    if C != 3 or not 1 <= npoint <= N:
        raise ValueError(f"fps: bad shape {tuple(pts.shape)} -> {npoint}")
    out = torch.empty((B, npoint), dtype=torch.long, device=pts.device)
    use_shared = 16 * N <= SHARED_BYTES
    scratch = None if use_shared else torch.empty(
        (B, N), dtype=torch.float32, device=pts.device
    )
    threads = 256 if N <= 4096 else 1024
    KERNEL.launches += 1
    KERNEL.call(
        "fps_launch", ptr(pts), ptr(scratch), ptr(out), B, N, npoint,
        threads, int(use_shared), current_stream(pts.device),
    )
    return out


def furthest_point_sample(pts: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int64 indices."""
    if pts.device.type == "cpu":
        return fps_plain(pts, npoint)
    return fps_cuda(pts, npoint)


def sample_pts_feats(pts, feats, npoint: int, return_index: bool = False):
    """FPS-downsample a cloud (B, N, 3) and its features (B, N, C)."""
    idx = furthest_point_sample(pts, npoint)
    pts_s = gather_points(pts, idx)
    feats_s = gather_points(feats, idx)
    if return_index:
        return pts_s, feats_s, idx
    return pts_s, feats_s
