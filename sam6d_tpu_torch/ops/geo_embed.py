"""Fused geometric-structure embedding (Chebyshev bases + max over k),
forward and backward.

Counterpart of `sam6d_tpu/ops/pallas/geo_embed.py:geo_embed_maxk`, a
custom VJP there and a `torch.autograd.Function` here.  The forward
launches the CUDA kernel `geo_embed_fwd` of `csrc/geo_embed.cu` (K2) and
the backward `geo_embed_bwd` (K3) for tensors on the card; for tensors on
the CPU they compute the plain PyTorch versions `geo_embed_maxk_plain`
and `geo_embed_maxk_bwd_plain`:

  out[b, n, m] = T(d_idx) @ Md + max_k T(a_idx[..., k]) @ Ma + bias

The Chebyshev recurrences run in float32 on the index fields normalised
to [-1, 1] (clamped), the basis is rounded to the compute dtype, and the
products accumulate in float32.  The backward gives Md, Ma and bias their
float32 gradients (cast to their dtypes); the index fields are geometry
and get none.  The max over k sends each channel's cotangent to the k
that won it in the forward, split evenly among exact ties: when a
gradient is wanted the forward also returns the winners, one uint8 per
(pair, channel) with bit k set where e_k reached the max, and the
backward reads them (no e_k is rebuilt).
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
        _V, _V, _V, _V, _V, _V, _V, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, _V,
    ]},
)
KERNEL_BWD = Kernel(
    "geo_embed_bwd", "geo_embed.cu",
    replaces="sam6d_tpu/ops/pallas/geo_embed.py:234",
    signatures={"geo_embed_bwd": [
        _V, _V, _V, _V, _V, _V, _V, _V, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, _V,
    ]},
)

# The kernel's compile-time basis sizes and k (the PEM configuration).
PD, PA, K = 40, 28, 3
# Blocks of the backward kernel: one on each of the H100's 132 SMs.  A
# constant, so that the order of its sums, and its result, never change.
BWD_BLOCKS = 132


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


def winner_bits(e: torch.Tensor) -> torch.Tensor:
    """(..., k, d) branch embeddings -> (..., d) uint8 with bit k set where
    e_k reaches the max over k (several bits at an exact tie)."""
    win = e == e.amax(dim=-2, keepdim=True)
    w = 1 << torch.arange(e.shape[-2], device=e.device)
    return (win.to(torch.int32) * w[:, None]).sum(dim=-2).to(torch.uint8)


def geo_embed_maxk_plain(d_idx, a_idx, Md, Ma, bias, hi_d: float,
                         hi_a: float, out_dtype, winners: bool = False):
    """The embedding (B, N, M, d) in out_dtype; with `winners`, also the
    (B, N, M, d) uint8 winners of the max over k (`winner_bits`)."""
    dt = Md.dtype
    td = cheb_basis(_norm_idx(d_idx.float(), hi_d), Md.shape[0])
    acc = td.to(dt).float() @ Md.float()
    ta = cheb_basis(_norm_idx(a_idx.float(), hi_a), Ma.shape[0])
    e = ta.to(dt).float() @ Ma.float()
    out = (acc + e.amax(dim=-2) + bias.float().reshape(-1)).to(out_dtype)
    return (out, winner_bits(e)) if winners else out


def geo_embed_maxk_cuda(d_idx, a_idx, Md, Ma, bias, hi_d: float,
                        hi_a: float, out_dtype, winners: bool = False):
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
    if any(t.data_ptr() % 16 for t in (d_idx, a_idx)):
        raise ValueError("geo_embed: index fields must be 16-byte aligned")
    out, win = prepare_fwd(d_idx, d, out_dtype, winners)
    launch_fwd(d_idx, a_idx, Md, Ma, bias, hi_d, hi_a, out, win)
    return (out, win) if winners else out


def prepare_fwd(d_idx, d: int, out_dtype, winners: bool):
    """The forward's outputs: the embedding and, with `winners`, the
    winners (else None)."""
    shape = (*d_idx.shape, d)
    out = torch.empty(shape, dtype=out_dtype, device=d_idx.device)
    win = (torch.empty(shape, dtype=torch.uint8, device=d_idx.device)
           if winners else None)
    return out, win


def launch_fwd(d_idx, a_idx, Md, Ma, bias, hi_d, hi_a, out, win) -> None:
    """One K2 launch on checked, prepared operands (`prepare_fwd`)."""
    KERNEL.launches += 1
    KERNEL.call(
        "geo_embed_fwd", ptr(d_idx), ptr(a_idx), ptr(Md), ptr(Ma), ptr(bias),
        ptr(out), ptr(win), d_idx.numel(), Md.shape[1], 2.0 / hi_d,
        2.0 / hi_a, int(out.dtype == torch.bfloat16),
        current_stream(d_idx.device),
    )


def geo_embed_maxk_bwd_plain(d_idx, a_idx, win, g, hi_d: float, hi_a: float,
                             Pd: int = PD, Pa: int = PA,
                             chunk: int = 1 << 18):
    """(dMd (Pd, d), dMa (Pa, d), dbias (d,)), all float32, for the
    cotangent g (B, N, M, d) of geo_embed_maxk_plain's output, in the
    compute dtype, and the forward's winners.  Pairs are taken `chunk` at
    a time to bound the (pairs, k, d) intermediates."""
    dt = g.dtype
    d = g.shape[-1]
    k = a_idx.shape[-1]
    d_flat, a_flat = d_idx.reshape(-1), a_idx.reshape(-1, k)
    g_flat, w_flat = g.reshape(-1, d), win.reshape(-1, d)
    bit = 1 << torch.arange(k, device=g.device, dtype=torch.int32)
    dmd = torch.zeros(Pd, d, device=g.device)
    dma = torch.zeros(Pa, d, device=g.device)
    dbias = torch.zeros(d, device=g.device)
    for lo in range(0, g_flat.shape[0], chunk):
        gc = g_flat[lo:lo + chunk].float()
        td = cheb_basis(_norm_idx(d_flat[lo:lo + chunk].float(), hi_d), Pd)
        dmd += td.to(dt).float().T @ gc
        dbias += gc.sum(0)
        ta = cheb_basis(_norm_idx(a_flat[lo:lo + chunk].float(), hi_a), Pa)
        ta = ta.to(dt).float()  # (n, k, Pa)
        wk = (w_flat[lo:lo + chunk, None, :].to(torch.int32)
              & bit[:, None]) != 0  # (n, k, d)
        share = (gc / wk.sum(dim=1)).to(dt).float()
        gk = torch.where(wk, share[:, None, :], 0.0)
        dma += ta.reshape(-1, Pa).T @ gk.reshape(-1, d)
    return dmd, dma, dbias


def geo_embed_maxk_bwd_cuda(d_idx, a_idx, win, g, hi_d: float, hi_a: float):
    dtype = g.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"geo_embed backward: unsupported dtype {dtype}")
    check_cuda(d_idx, "d_idx", torch.float32, ndim=3)
    check_cuda(a_idx, "a_idx", torch.float32, ndim=4)
    check_cuda(win, "win", torch.uint8, ndim=4)
    check_cuda(g, "g", dtype, ndim=4)
    B, N, M = d_idx.shape
    d = g.shape[-1]
    if (a_idx.shape != (B, N, M, K) or g.shape != (B, N, M, d)
            or win.shape != g.shape or d % 32 or d > 256
            or B * N * M == 0):
        raise ValueError(
            f"geo_embed backward: unsupported shapes d_idx "
            f"{tuple(d_idx.shape)}, a_idx {tuple(a_idx.shape)}, win "
            f"{tuple(win.shape)}, g {tuple(g.shape)}"
        )
    if any(t.data_ptr() % 16 for t in (d_idx, a_idx, win, g)):
        raise ValueError("geo_embed backward: inputs must be 16-byte aligned")
    bufs = prepare_bwd(g)
    launch_bwd(d_idx, a_idx, win, g, hi_d, hi_a, *bufs)
    return bufs[1:]


def prepare_bwd(g):
    """The backward's scratch and outputs: (partial, dmd, dma, dbias)."""
    d = g.shape[-1]
    n_pairs = g.numel() // d
    nblocks = min(BWD_BLOCKS, -(-n_pairs // 64))
    dev = g.device
    return (torch.empty((nblocks, PD + PA + 1, d), device=dev),
            torch.empty((PD, d), device=dev), torch.empty((PA, d), device=dev),
            torch.empty((d,), device=dev))


def launch_bwd(d_idx, a_idx, win, g, hi_d, hi_a, partial, dmd, dma,
               dbias) -> None:
    """One K3 launch on checked, prepared operands (`prepare_bwd`)."""
    d = g.shape[-1]
    KERNEL_BWD.launches += 1
    KERNEL_BWD.call(
        "geo_embed_bwd", ptr(d_idx), ptr(a_idx), ptr(win), ptr(g),
        ptr(partial), ptr(dmd), ptr(dma), ptr(dbias), g.numel() // d, d,
        2.0 / hi_d, 2.0 / hi_a, int(g.dtype == torch.bfloat16),
        partial.shape[0], current_stream(g.device),
    )


class _GeoEmbedMaxK(torch.autograd.Function):
    """K2 forward, K3 backward.  The inputs and, when a gradient is
    wanted, the forward's winners are saved, never the output, so the
    caller may add to the output in place."""

    @staticmethod
    def forward(ctx, d_idx, a_idx, Md, Ma, bias, hi_d, hi_a, out_dtype):
        ctx.hi = (hi_d, hi_a)
        ctx.md = (Md.shape[0], Md.dtype)
        ctx.ma = (Ma.shape[0], Ma.dtype)
        ctx.bias_shape = bias.shape
        fn = (geo_embed_maxk_plain if d_idx.device.type == "cpu"
              else geo_embed_maxk_cuda)
        args = (d_idx, a_idx, Md, Ma, bias, hi_d, hi_a, out_dtype)
        if not any(ctx.needs_input_grad[2:5]):
            return fn(*args)
        out, win = fn(*args, winners=True)
        ctx.save_for_backward(d_idx, a_idx, win)
        return out

    @staticmethod
    def backward(ctx, g):
        d_idx, a_idx, win = ctx.saved_tensors
        hi_d, hi_a = ctx.hi
        Pd, md_dtype = ctx.md
        Pa, ma_dtype = ctx.ma
        g = g.to(ma_dtype).contiguous()
        if g.device.type == "cpu":
            dmd, dma, dbias = geo_embed_maxk_bwd_plain(d_idx, a_idx, win, g,
                                                       hi_d, hi_a, Pd, Pa)
        else:
            dmd, dma, dbias = geo_embed_maxk_bwd_cuda(d_idx, a_idx, win, g,
                                                      hi_d, hi_a)
        return (None, None, dmd.to(md_dtype), dma.to(ma_dtype),
                dbias.reshape(ctx.bias_shape), None, None, None)


def geo_embed_maxk(d_idx, a_idx, Md, Ma, bias, hi_d: float, hi_a: float,
                   out_dtype=torch.float32) -> torch.Tensor:
    """d_idx (B, N, M) f32 clamped to hi_d; a_idx (B, N, M, k) f32 in
    [0, hi_a]; Md (Pd, d) / Ma (Pa, d) in the compute dtype; bias (d,)
    f32.  Returns (B, N, M, d) in out_dtype, differentiable in Md, Ma and
    bias."""
    return _GeoEmbedMaxK.apply(d_idx, a_idx, Md, Ma, bias, hi_d, hi_a,
                               out_dtype)
