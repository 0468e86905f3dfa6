"""Row scatter-add: the backward of a row gather.

Counterpart of `sam6d_tpu/ops/pallas/scatter_rows.py`.  `scatter_rows`
launches the CUDA kernel `csrc/scatter_rows.cu` (float32 atomics) for
tensors on the card and computes the plain PyTorch version
`scatter_rows_plain` (a float32 `index_add_`, as `scatter_rows_xla`) for
tensors on the CPU:

  out[b, n] = sum over q with idx[b, q] == n of dy[b, q]   (float32)

Negative indices are dropped.  The kernel's sums land in the order its
atomics do, so two launches may differ in the last float32 bits.
"""

from __future__ import annotations

import ctypes

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "scatter_rows", "scatter_rows.cu",
    replaces="sam6d_tpu/ops/pallas/scatter_rows.py:65",
    signatures={"scatter_rows": [_V, _V, _V, ctypes.c_longlong, _I, _I, _I,
                                 _I, _V]},
)


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


def scatter_rows_cuda(idx: torch.Tensor, dy: torch.Tensor,
                      n_targets: int) -> torch.Tensor:
    check_cuda(idx, "idx", torch.int64, ndim=2)
    if dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scatter_rows: unsupported dtype {dy.dtype}")
    check_cuda(dy, "dy", dy.dtype, ndim=3)
    B, Q = idx.shape
    C = dy.shape[-1]
    if dy.shape[:2] != (B, Q) or C % 2 or dy.data_ptr() % 8:
        raise ValueError(
            f"scatter_rows: unsupported shapes idx {tuple(idx.shape)}, "
            f"dy {tuple(dy.shape)} (C must be even, dy 8-byte aligned)"
        )
    out = torch.zeros((B, n_targets, C), dtype=torch.float32,
                      device=dy.device)
    KERNEL.launches += 1
    KERNEL.call(
        "scatter_rows", ptr(idx), ptr(dy), ptr(out), B * Q, Q, n_targets, C,
        int(dy.dtype == torch.bfloat16), current_stream(dy.device),
    )
    return out


def scatter_rows(idx: torch.Tensor, dy: torch.Tensor,
                 n_targets: int) -> torch.Tensor:
    """idx (B, Q) int64 (negative = drop), dy (B, Q, C) -> (B, N, C)
    float32."""
    if dy.device.type == "cpu":
        return scatter_rows_plain(idx, dy, n_targets)
    return scatter_rows_cuda(idx, dy, n_targets)
