"""Row scatter-add: the backward of a row gather.

Counterpart of `sam6d_tpu/ops/pallas/scatter_rows.py`.  `scatter_rows`
launches the CUDA kernel `csrc/scatter_rows.cu` for tensors on the card and
computes the plain PyTorch version `scatter_rows_plain` (a float32
`index_add_`, as `scatter_rows_xla`) for tensors on the CPU:

  out[b, n] = sum over q with idx[b, q] == n of dy[b, q]   (float32)

Indices outside [0, N) are dropped.  The kernel builds an inverse index (a
stable counting sort of idx: `offsets` (B, N + 1) and `perm` (B, Q), each
target's rows in ascending q; `inverse_index_plain` computes the same on
the CPU) and adds each target's rows in that order from 0.0f (a warp
streams the targets whose rows start in a window of `UNIT_ROWS` positions
of perm), so its result is the same in every launch and equals the
sequential float32 sum of `index_add_` bit for bit.  A call is four kernel
launches (count, scan, place, sum) and no host synchronisation; `prepare`
+ `launch` are the bare launch, `inverse_index_cuda` the first three
alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "scatter_rows", "scatter_rows.cu",
    replaces="sam6d_tpu/ops/pallas/scatter_rows.py:65",
    signatures={"scatter_rows_launch": [_V] * 7 + [_I] * 9 + [_V]},
)

SMEM_LIMIT = 232448  # shared memory a block may have (H100)
MAX_TILE = 8192  # rows a block of the count and placement kernels
MAX_C = 128  # channels: four a lane of the sum kernel
SUM_WARPS = 8  # warps a block of the sum kernel
SUM_UNITS = 4  # vectors a lane copies a round of the sum kernel
SUM_STAGES = 3  # rounds in a warp's ring of the sum kernel
UNIT_ROWS = 1024  # perm positions whose targets one warp of the sum takes


class ScatterPlan(NamedTuple):
    """How a (B, Q) -> (B, N) call spreads: `tile` rows a block of the
    count and placement kernels (`tiles` a batch item), `place_warps` a
    placement block, their dynamic shared memory, the sum kernel's `vec`
    bytes a copy, its `rows` a round and its ring (`sum_smem` a block), the
    perm positions of a sum warp's unit, and the int32 scratch."""

    tile: int
    tiles: int
    place_warps: int
    count_smem: int
    place_smem: int
    vec: int
    rows: int
    sum_smem: int
    unit_rows: int
    units: int
    scratch_ints: int


@functools.lru_cache(maxsize=64)
def scatter_plan(B: int, Q: int, N: int, C: int, itemsize: int,
                 align: int) -> ScatterPlan:
    """The launch geometry of a call; raises ValueError where the kernel
    cannot take the shape.  `align` is dy's address modulo 16."""
    row = C * itemsize
    if C <= 0 or C > MAX_C or row % 4:
        raise ValueError(f"scatter_rows: {C} channels of {itemsize} bytes "
                         f"(1 to {MAX_C}, rows a multiple of 4 bytes)")
    if 4 * N > SMEM_LIMIT:
        raise ValueError(f"scatter_rows: {N} targets exceed shared memory")
    for warps in (8, 4, 2, 1):
        # The tile's keys and sorted rows and a shift a target (int32), a
        # row of N counters a warp (uint16, padded to an even count),
        # beside 128 static bytes.
        step = 32 * warps
        room = (SMEM_LIMIT - 128 - 4 * N - 2 * warps * (N + N % 2)) // 8
        tile = min(MAX_TILE, -(-max(Q, 1) // step) * step, room // step * step)
        if tile >= step:
            break
    else:
        raise ValueError(f"scatter_rows: {N} targets exceed shared memory")
    vec = next(v for v in (16, 8, 4) if row % v == 0 and align % v == 0)
    shift = (row // vec - 1).bit_length()  # lanes a row: 2^shift
    tiles = -(-Q // tile)
    units = max(1, -(-Q // UNIT_ROWS))  # one owns the targets at Q = 0
    return ScatterPlan(
        tile=tile, tiles=tiles, place_warps=warps, count_smem=4 * N,
        place_smem=4 * (2 * tile + N) + 2 * warps * (N + N % 2), vec=vec,
        rows=(32 * SUM_UNITS) >> shift,
        sum_smem=SUM_WARPS * SUM_STAGES * SUM_UNITS * 32 * vec,
        unit_rows=UNIT_ROWS, units=units,
        scratch_ints=B * tiles * N + B * (N + 1) + B * Q + B * (units + 1))


def scatter_rows_plain(idx: torch.Tensor, dy: torch.Tensor,
                       n_targets: int) -> torch.Tensor:
    B, Q = idx.shape
    C = dy.shape[-1]
    offs = torch.arange(B, device=idx.device)[:, None] * n_targets
    flat = torch.where(idx >= 0, idx + offs, B * n_targets).reshape(-1)
    out = torch.zeros(B * n_targets + 1, C, dtype=torch.float32,
                      device=dy.device)
    out.index_add_(0, flat, dy.reshape(-1, C).float())
    return out[:-1].reshape(B, n_targets, C)


def inverse_index_plain(idx: torch.Tensor, n_targets: int):
    """The kernel's inverse index on the CPU: offsets (B, N + 1) int32, the
    start of each target's rows, and perm (B, Q) int32, the rows grouped by
    target in ascending q (a stable sort), -1 past the kept rows."""
    B, Q = idx.shape
    kept = (idx >= 0) & (idx < n_targets)
    key = torch.where(kept, idx, torch.full_like(idx, n_targets))
    order = torch.argsort(key, dim=1, stable=True)
    counts = torch.zeros(B, n_targets + 1, dtype=torch.long,
                         device=idx.device)
    counts.scatter_add_(1, key, torch.ones_like(key))
    offsets = torch.zeros_like(counts)
    offsets[:, 1:] = counts[:, :-1].cumsum(1)
    n_kept = offsets[:, -1:]
    perm = torch.where(torch.arange(Q, device=idx.device) < n_kept, order,
                       torch.full_like(order, -1))
    return offsets.int(), perm.int()


def _check(idx: torch.Tensor, dy: torch.Tensor | None,
           n_targets: int) -> ScatterPlan:
    check_cuda(idx, "idx", torch.int64, ndim=2)
    B, Q = idx.shape
    if dy is None:
        return scatter_plan(B, Q, n_targets, 2, 2, 0)
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scatter_rows: unsupported dtype {dy.dtype}")
    check_cuda(dy, "dy", dy.dtype, ndim=3)
    C = dy.shape[-1]
    if dy.shape[:2] != (B, Q) or C % 2 or dy.data_ptr() % 8:
        raise ValueError(
            f"scatter_rows: unsupported shapes idx {tuple(idx.shape)}, "
            f"dy {tuple(dy.shape)} (C must be even, dy 8-byte aligned)"
        )
    if dy.device != idx.device:
        raise ValueError("scatter_rows: idx and dy on different devices")
    return scatter_plan(B, Q, n_targets, C, dy.element_size(),
                        dy.data_ptr() % 16)


def prepare(idx: torch.Tensor, n_targets: int, C: int, plan: ScatterPlan):
    """The output (B, N, C) float32, uninitialised (the kernel writes every
    row), and the int32 scratch carved from one buffer: counts (B, tiles,
    N), offsets (B, N + 1), perm (B, Q), unit_first (B, units + 1)."""
    B, Q = idx.shape
    out = torch.empty((B, n_targets, C), dtype=torch.float32,
                      device=idx.device)
    work = torch.empty(plan.scratch_ints, dtype=torch.int32, device=idx.device)
    sizes = (B * plan.tiles * n_targets, B * (n_targets + 1), B * Q,
             B * (plan.units + 1))
    counts, offsets, perm, unit_first = work.split(sizes)
    return (out, counts, offsets.view(B, n_targets + 1), perm.view(B, Q),
            unit_first)


def launch(idx, dy, n_targets: int, plan: ScatterPlan, out, counts, offsets,
           perm, unit_first) -> None:
    """One K7 call (four kernel launches: count, scan, place, sum) on
    checked, prepared operands (`prepare`); with out and dy None it stops
    after the placement."""
    B, Q = idx.shape
    C = 0 if dy is None else dy.shape[-1]
    bf16 = dy is not None and dy.dtype == torch.bfloat16
    KERNEL.launches += 1
    KERNEL.call(
        "scatter_rows_launch", ptr(idx), ptr(dy), ptr(out), ptr(counts),
        ptr(offsets), ptr(perm), ptr(unit_first), B, Q, n_targets, C,
        plan.tile, plan.place_warps, plan.unit_rows, int(bf16), plan.vec,
        current_stream(idx.device),
    )


def scatter_rows_cuda(idx: torch.Tensor, dy: torch.Tensor,
                      n_targets: int) -> torch.Tensor:
    plan = _check(idx, dy, n_targets)
    bufs = prepare(idx, n_targets, dy.shape[-1], plan)
    launch(idx, dy, n_targets, plan, *bufs)
    return bufs[0]


def inverse_index_cuda(idx: torch.Tensor, n_targets: int):
    """The kernel's offsets and perm (perm -1 past the kept rows), for
    tests: the count, scan and placement launches alone."""
    plan = _check(idx, None, n_targets)
    bufs = prepare(idx, n_targets, 0, plan)
    offsets, perm = bufs[2], bufs[3]
    perm.fill_(-1)
    launch(idx, None, n_targets, plan, None, *bufs[1:])
    return offsets, perm


def scatter_rows(idx: torch.Tensor, dy: torch.Tensor,
                 n_targets: int) -> torch.Tensor:
    """idx (B, Q) int64 (outside [0, N) = drop), dy (B, Q, C) -> (B, N, C)
    float32."""
    if dy.device.type == "cpu":
        return scatter_rows_plain(idx, dy, n_targets)
    return scatter_rows_cuda(idx, dy, n_targets)
