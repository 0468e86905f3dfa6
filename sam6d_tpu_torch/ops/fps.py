"""Furthest point sampling (FPS).

Counterpart of `sam6d_tpu/ops/fps.py`.  `furthest_point_sample` launches
the CUDA kernel `csrc/fps.cu` for a tensor on the card and computes the
plain PyTorch version `fps_plain` (a mirror of the JAX oracle `_fps_xla`)
for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr
from sam6d_tpu_torch.ops.pointcloud import gather_points

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "fps", "fps.cu",
    replaces="sam6d_tpu/ops/pallas/fps_kernel.py:117",
    signatures={"fps_launch": [_V, _V, _V] + [_I] * 7 + [_V]},
)

MAX_CLUSTER = 16
ROUTES = ("block", "cluster", "global")
# Points a thread of the 1024-thread instances (`csrc/fps.cu`); a block's
# share of the row is padded to per x 1024 points in shared memory, at
# most 221,184 B of the 232,448 B a block may have.
PERS = (4, 8, 10, 13, 16, 18)


class FpsPlan(NamedTuple):
    """How one launch spreads a row: `route` (see `csrc/fps.cu`), blocks a
    row (`cluster`), `threads` a block, `smem_bytes` of dynamic shared
    memory a block, `per` points a thread: a block holds `chunk` points of
    the row, padded to per x threads."""

    route: str
    cluster: int
    threads: int
    smem_bytes: int
    per: int
    chunk: int


def _plan_1024(route: str, cluster: int, chunk: int) -> FpsPlan:
    per = next(p for p in PERS if p * 1024 >= chunk)
    return FpsPlan(route, cluster, 1024, 12 * per * 1024, per, chunk)


@functools.lru_cache(maxsize=64)
def fps_plan(B: int, N: int) -> FpsPlan:
    """The route of a (B, N, 3) call, chosen by the row's size.

    - N <= 2048 (a request's or a training step's 196 from 2048): one block
      of 8 warps a row, 8 points a thread in registers.
    - N <= 18432 (a training step's template clouds, 10000): one block of
      1024 threads a row.
    - Larger rows (the 210k onboarding cloud): the smallest cluster of 2,
      4, 8 or 16 blocks whose threads hold at most 13 points each, else 16
      blocks of at most 18 (294,912 points a row).
    - Beyond that: the device-memory route, one block of 1024 a row.
    """
    if N <= 2048:
        return FpsPlan("block", 1, 256, 12 * 2048, 8, N)
    if N <= PERS[-1] * 1024:
        return _plan_1024("block", 1, N)
    for c in (2, 4, 8, 16):
        chunk = -(-N // c)
        if chunk <= 13 * 1024 or (c == MAX_CLUSTER
                                  and chunk <= PERS[-1] * 1024):
            return _plan_1024("cluster", c, chunk)
    return FpsPlan("global", 1, 1024, 0, 0, N)


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
    plan = fps_plan(B, N)
    bufs = prepare(pts, npoint, plan)
    launch(pts, npoint, plan, *bufs)
    return bufs[0]


def prepare(pts, npoint: int, plan: FpsPlan):
    """The launch's output (B, npoint) int64 and, on the device-memory
    route, its field scratch (B, N) float32."""
    B, N, _ = pts.shape
    out = torch.empty((B, npoint), dtype=torch.long, device=pts.device)
    scratch = (torch.empty((B, N), dtype=torch.float32, device=pts.device)
               if plan.route == "global" else None)
    return out, scratch


def launch(pts, npoint: int, plan: FpsPlan, out, scratch) -> None:
    """One K1 launch on checked, prepared operands (`prepare`)."""
    B, N, _ = pts.shape
    KERNEL.launches += 1
    KERNEL.call(
        "fps_launch", ptr(pts), ptr(scratch), ptr(out), B, N, npoint,
        ROUTES.index(plan.route), plan.cluster, plan.threads, plan.per,
        current_stream(pts.device),
    )


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
