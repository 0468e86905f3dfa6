"""Fused geometric-structure embedding forward (Chebyshev bases + max over k).

Counterpart of `sam6d_tpu/ops/pallas/geo_embed.py:geo_embed_maxk`
(forward only).  `geo_embed_maxk` launches the CUDA kernel
`csrc/geo_embed.cu` for tensors on the card and computes the plain
PyTorch version `geo_embed_maxk_plain` for tensors on the CPU:

  out[b, n, m] = T(d_idx) @ Md + max_k T(a_idx[..., k]) @ Ma + bias

The Chebyshev recurrences run in float32 on the index fields normalised
to [-1, 1] (clamped), the basis is rounded to the compute dtype, and the
products accumulate in float32.
"""

from __future__ import annotations

import ctypes

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr

_V = ctypes.c_void_p
KERNEL = Kernel(
    "geo_embed_fwd", "geo_embed.cu",
    replaces="sam6d_tpu/ops/pallas/geo_embed.py:272",
    signatures={"geo_embed_fwd": [
        _V, _V, _V, _V, _V, _V, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, _V,
    ]},
)

# The kernel's compile-time basis sizes and k (the PEM configuration).
PD, PA, K = 40, 28, 3


def cheb_basis(x: torch.Tensor, P: int) -> torch.Tensor:
    """Chebyshev basis T_0..T_{P-1} of x (float32), stacked last."""
    t_prev = torch.ones_like(x)
    t_cur = x
    terms = [t_prev, t_cur]
    for _ in range(P - 2):
        t_prev, t_cur = t_cur, 2.0 * x * t_cur - t_prev
        terms.append(t_cur)
    return torch.stack(terms[:P], dim=-1)


def _norm_idx(raw: torch.Tensor, hi: float) -> torch.Tensor:
    return torch.clamp(raw * (2.0 / hi) - 1.0, -1.0, 1.0)


def geo_embed_maxk_plain(d_idx, a_idx, Md, Ma, bias, hi_d: float,
                         hi_a: float, out_dtype) -> torch.Tensor:
    dt = Md.dtype
    td = cheb_basis(_norm_idx(d_idx.float(), hi_d), Md.shape[0])
    acc = td.to(dt).float() @ Md.float()
    ta = cheb_basis(_norm_idx(a_idx.float(), hi_a), Ma.shape[0])
    amax = (ta.to(dt).float() @ Ma.float()).amax(dim=-2)
    return (acc + amax + bias.float().reshape(-1)).to(out_dtype)


def geo_embed_maxk_cuda(d_idx, a_idx, Md, Ma, bias, hi_d: float,
                        hi_a: float, out_dtype) -> torch.Tensor:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"geo_embed: unsupported dtype {out_dtype}")
    check_cuda(d_idx, "d_idx", torch.float32, ndim=3)
    check_cuda(a_idx, "a_idx", torch.float32, ndim=4)
    check_cuda(Md, "Md", out_dtype, ndim=2)
    check_cuda(Ma, "Ma", out_dtype, ndim=2)
    check_cuda(bias, "bias", torch.float32)
    B, N, M = d_idx.shape
    d = Md.shape[1]
    if (a_idx.shape != (B, N, M, K) or Md.shape[0] != PD
            or Ma.shape != (PA, d) or bias.numel() != d
            or d % 32 or d > 256):
        raise ValueError(
            f"geo_embed: unsupported shapes d_idx {tuple(d_idx.shape)}, "
            f"a_idx {tuple(a_idx.shape)}, Md {tuple(Md.shape)}, "
            f"Ma {tuple(Ma.shape)}"
        )
    out = torch.empty((B, N, M, d), dtype=out_dtype, device=d_idx.device)
    KERNEL.launches += 1
    KERNEL.call(
        "geo_embed_fwd", ptr(d_idx), ptr(a_idx), ptr(Md), ptr(Ma), ptr(bias),
        ptr(out), B * N * M, d, 2.0 / hi_d, 2.0 / hi_a,
        int(out_dtype == torch.bfloat16), current_stream(d_idx.device),
    )
    return out


def geo_embed_maxk(d_idx, a_idx, Md, Ma, bias, hi_d: float, hi_a: float,
                   out_dtype=torch.float32) -> torch.Tensor:
    """d_idx (B, N, M) f32 clamped to hi_d; a_idx (B, N, M, k) f32 in
    [0, hi_a]; Md (Pd, d) / Ma (Pa, d) in the compute dtype; bias (d,)
    f32.  Returns (B, N, M, d) in out_dtype."""
    if d_idx.device.type == "cpu":
        return geo_embed_maxk_plain(d_idx, a_idx, Md, Ma, bias, hi_d, hi_a,
                                    out_dtype)
    return geo_embed_maxk_cuda(d_idx, a_idx, Md, Ma, bias, hi_d, hi_a,
                               out_dtype)
