"""Batched weighted Procrustes (rigid alignment by weighted 3x3 SVD).

Counterpart of `sam6d_tpu/ops/procrustes.py` (reference
utils/model_utils.py:343-455).  Returns (R, t) with
ref ~= src @ R^T + t.

`weighted_procrustes` launches the CUDA kernel `csrc/procrustes.cu` for
tensors on the card, and computes the plain PyTorch version
`weighted_procrustes_plain` (struct-of-arrays, a mirror of the JAX
function) for tensors on the CPU.  The kernel is forward-only: on the
card an input that requires a gradient is refused under grad mode (the
pose solves serve under `torch.inference_mode`; training never solves).
"""

from __future__ import annotations

import ctypes

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr
from sam6d_tpu_torch.ops.svd3 import svd3x3_soa
from sam6d_tpu_torch.utils.timer import count

_V = ctypes.c_void_p
_F = ctypes.c_float
KERNEL = Kernel(
    "procrustes", "procrustes.cu",
    replaces="sam6d_tpu/ops/procrustes.py:26",
    signatures={"procrustes_launch": [_V] * 5 + [
        ctypes.c_longlong, ctypes.c_int, _F, _F, ctypes.c_int, _V]},
)

ROUTES = ("thread", "block")
# Problems of this many points take one thread each, their points in
# registers (the coarse stage's three-point hypotheses); any other number
# one block of 256 threads each (the fine stage's 2048 correspondences).
THREAD_N = 3


def procrustes_route(n: int) -> str:
    """The kernel's route for problems of n points."""
    return "thread" if n == THREAD_N else "block"


def weighted_procrustes(src_points, ref_points, weights=None,
                        weight_thresh: float = 0.0, eps: float = 1e-5):
    """src/ref (..., N, 3), weights (..., N) -> R (..., 3, 3), t (..., 3)."""
    if src_points.device.type == "cpu":
        return weighted_procrustes_plain(src_points, ref_points, weights,
                                         weight_thresh, eps)
    lead, (n, _) = src_points.shape[:-2], src_points.shape[-2:]
    R, t = procrustes_cuda(
        src_points.float().reshape(-1, n, 3).contiguous(),
        ref_points.float().reshape(-1, n, 3).contiguous(),
        None if weights is None
        else weights.float().reshape(-1, n).contiguous(),
        weight_thresh, eps)
    return R.reshape(*lead, 3, 3), t.reshape(*lead, 3)


def procrustes_cuda(src, ref, weights=None, weight_thresh: float = 0.0,
                    eps: float = 1e-5):
    """(P, N, 3) float32 src and ref, (P, N) float32 weights or None ->
    R (P, 3, 3), t (P, 3): one launch."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (src, ref, weights)):
        raise RuntimeError(
            "procrustes: the CUDA kernel is forward-only and makes no "
            "autograd node, but an input requires a gradient; call it under "
            "torch.no_grad() or torch.inference_mode()")
    check_cuda(src, "src", torch.float32, ndim=3)
    check_cuda(ref, "ref", torch.float32, ndim=3)
    P, n, c = src.shape
    if c != 3 or n < 1 or ref.shape != src.shape:
        raise ValueError(f"procrustes: bad shapes {tuple(src.shape)}, "
                         f"{tuple(ref.shape)}")
    if weights is not None:
        check_cuda(weights, "weights", torch.float32, ndim=2)
        if weights.shape != (P, n):
            raise ValueError(f"procrustes: weights {tuple(weights.shape)} "
                             f"for points {tuple(src.shape)}")
    route = procrustes_route(n)
    count(f"procrustes.{route}_rows", P)
    R, t = prepare(src)
    launch(src, ref, weights, R, t, weight_thresh, eps, route)
    return R, t


def prepare(src):
    """The launch's outputs: R (P, 3, 3) and t (P, 3) float32."""
    P = src.shape[0]
    return (torch.empty((P, 3, 3), dtype=torch.float32, device=src.device),
            torch.empty((P, 3), dtype=torch.float32, device=src.device))


def launch(src, ref, weights, R, t, weight_thresh: float, eps: float,
           route: str) -> None:
    """One K8 launch on checked, prepared operands (`prepare`)."""
    P, n, _ = src.shape
    KERNEL.launches += 1
    KERNEL.call(
        "procrustes_launch", ptr(src), ptr(ref), ptr(weights), ptr(R),
        ptr(t), P, n, weight_thresh, eps, ROUTES.index(route),
        current_stream(src.device),
    )


def weighted_procrustes_plain(src_points, ref_points, weights=None,
                              weight_thresh: float = 0.0, eps: float = 1e-5):
    """`weighted_procrustes` in plain PyTorch ops."""
    src_points = src_points.float()
    ref_points = ref_points.float()
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], device=src_points.device)
    weights = torch.where(weights < weight_thresh,
                          torch.zeros_like(weights), weights)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + eps)
    w = weights[..., None]

    src_centroid = (src_points * w).sum(dim=-2)
    ref_centroid = (ref_points * w).sum(dim=-2)
    src_c = src_points - src_centroid[..., None, :]
    ref_c = ref_points - ref_centroid[..., None, :]
    ref_cw = ref_c * w

    h = [[(src_c[..., i] * ref_cw[..., j]).sum(dim=-1) for j in range(3)]
         for i in range(3)]
    (u1, u2, u3), _, (v1, v2, v3) = svd3x3_soa(h)

    def det_cols(c1, c2, c3):
        return (
            c1[0] * (c2[1] * c3[2] - c2[2] * c3[1])
            - c2[0] * (c1[1] * c3[2] - c1[2] * c3[1])
            + c3[0] * (c1[1] * c2[2] - c1[2] * c2[1])
        )

    d = torch.sign(det_cols(v1, v2, v3) * det_cols(u1, u2, u3))
    d = torch.where(d == 0, torch.ones_like(d), d)
    v3 = tuple(x * d for x in v3)

    # R = V U^T -> R[i][j] = v1_i u1_j + v2_i u2_j + v3_i u3_j.
    R_rows = [[v1[i] * u1[j] + v2[i] * u2[j] + v3[i] * u3[j]
               for j in range(3)] for i in range(3)]
    R = torch.stack([torch.stack(row, dim=-1) for row in R_rows], dim=-2)
    sc = [src_centroid[..., i] for i in range(3)]
    t = torch.stack([
        ref_centroid[..., i]
        - (R_rows[i][0] * sc[0] + R_rows[i][1] * sc[1] + R_rows[i][2] * sc[2])
        for i in range(3)
    ], dim=-1)
    return R, t
