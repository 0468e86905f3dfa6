"""Fused SAM AMG decode-tail statistics.

Counterpart of `sam6d_tpu/ops/pallas/decode_tail.py` (K6).  For every
(prompt, mask token) pair, the mask decoder's upscaling tail (stage-1
ConvTranspose as a 256 x 256 matmul, LayerNorm over each 64-channel
group, GELU, stage-2 64 x 128 per group, GELU, hypernetwork contraction)
runs without writing a logit, and only the statistics AMG filtering
needs come out, (P, 8, 12) float32:

  row 0: count(logit > thr + off)   row 1: count(logit > thr - off)
  rows 2..5: xmin, ymin, xmax, ymax over logit > thr (+-1e9 when empty)
  row 6: count(logit > thr)          row 7: 0

columns (e, f, t) = e * 6 + f * 3 + t.  SAM 2's decoder adds one
image's high-resolution features in the tail (`res1` before the
LayerNorm, `res0` before the second GELU; `MaskDecoder.tail`), which
every form takes optionally, in the key rows' layout and the keys'
dtype.  The GELU is the sigmoid form x * sigmoid(1.702 x) of the TPU
kernel; the kept candidates' logits are
recomputed with the exact-erf tail afterwards (`models/ism/sam/amg.py`).

`decode_tail_stats` launches `csrc/decode_tail.cu` for tensors on the
card and computes `decode_tail_stats_plain` (the JAX package's
`decode_tail_stats_reference`, returned in the kernel's layout) for
tensors on the CPU; `fold_stats` serves both.  The kernel multiplies on
the tensor cores with every float32 operand split into two bfloat16
parts (`split_bf16`), which keeps the products at float32 accuracy.
"""

from __future__ import annotations

import ctypes

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr
from sam6d_tpu_torch.utils.timer import count

_V = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = Kernel(
    "decode_tail_stats", "decode_tail.cu",
    replaces="sam6d_tpu/ops/pallas/decode_tail.py:171",
    signatures={"decode_tail_stats": [_V] * 12 + [_I, _I, _I, _F, _F, _F,
                                                  _I, _V]},
)

BIG = 1e9
# Tokens of one work item of the kernel, by key dtype (its scratch tile).
ROW_TILE = {torch.bfloat16: 256, torch.float32: 128}


def split_bf16(x: torch.Tensor):
    """float32 x -> bfloat16 (hi, lo), hi = rn(x), lo = rn(x - hi):
    hi + lo is x to within 2^-17 relative (outside the subnormals), so
    products of split operands summed in float32 keep float32 accuracy.
    The kernel splits its float32 keys and stage-2 activations alike."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_t(w: torch.Tensor) -> torch.Tensor:
    """(in, out) float32 -> (2, out, in) bfloat16: hi and lo of w^T, the
    [n][k] layout the kernel's ldmatrix B fragments read."""
    return torch.stack(split_bf16(w.t().contiguous()))


def _gelu_sigmoid(x):
    return x * torch.sigmoid(1.702 * x)


def _side(N: int) -> int:
    side = int(round(N ** 0.5))
    if side * side != N:
        raise ValueError(f"decode_tail_stats: N={N} is not a square grid")
    return side


def decode_tail_stats_plain(keys, hyper, w1, b1, ln_scale, ln_bias, w2, b2,
                            *, mask_threshold: float = 0.0,
                            stability_offset: float = 1.0,
                            ln_eps: float = 1e-6, res1=None,
                            res0=None) -> torch.Tensor:
    """The reference arithmetic (float32, materialized), (P, 8, 12);
    res1 (N, 256) and res0 (N, 512): SAM 2's high-resolution features in
    the key rows' layout, added after each stage's bias."""
    P, N, _ = keys.shape
    side = _side(N)
    dev = keys.device
    h1 = keys.float() @ w1.float() + b1.float()
    if res1 is not None:
        h1 = h1 + res1.float()
    h1 = h1.reshape(P, N, 4, 64)
    mu = h1.mean(-1, keepdim=True)
    var = ((h1 - mu) ** 2).mean(-1, keepdim=True)
    xn = ((h1 - mu) / torch.sqrt(var + ln_eps)).reshape(P, N, 256)
    g = _gelu_sigmoid(xn * ln_scale.float() + ln_bias.float())
    y2 = g.reshape(P, N, 4, 64) @ w2.float() + b2.float()
    if res0 is not None:
        y2 = y2 + res0.float().reshape(N, 4, 128)
    y2 = _gelu_sigmoid(y2).reshape(P, N, 4, 4, 32)  # (a d), (e f), c8
    m = torch.einsum("pnjkc,ptc->ptnjk", y2, hyper.float())
    n = torch.arange(N, device=dev)
    j = torch.arange(4, device=dev)
    Y = (4 * (n // side)[:, None, None] + 2 * (j // 2)[None, :, None]
         + (j // 2)[None, None, :]).float()
    X = (4 * (n % side)[:, None, None] + 2 * (j % 2)[None, :, None]
         + (j % 2)[None, None, :]).float()
    thr, off = mask_threshold, stability_offset
    mp = m > thr
    dims = (2, 3)  # tokens and (a, d): leaves (P, t, ef)
    rows = [
        (m > thr + off).sum(dims),
        (m > thr - off).sum(dims),
        torch.where(mp, X, BIG).amin(dims),
        torch.where(mp, Y, BIG).amin(dims),
        torch.where(mp, X, -BIG).amax(dims),
        torch.where(mp, Y, -BIG).amax(dims),
        mp.sum(dims),
        torch.zeros(P, 3, 4, device=dev),
    ]
    # (P, t, ef) -> columns ef * 3 + t
    return torch.stack([r.float().transpose(1, 2).reshape(P, 12)
                        for r in rows], dim=1)


def decode_tail_stats_cuda(keys, hyper, w1, b1, ln_scale, ln_bias, w2, b2,
                           *, mask_threshold: float = 0.0,
                           stability_offset: float = 1.0,
                           ln_eps: float = 1e-6, res1=None,
                           res0=None) -> torch.Tensor:
    if keys.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_tail_stats: unsupported dtype {keys.dtype}")
    check_cuda(keys, "keys", keys.dtype, ndim=3)
    P, N, C = keys.shape
    _side(N)  # raises unless the tokens form a square grid
    f32 = torch.float32
    shapes = {"hyper": (P, 3, 32), "w1": (256, 256), "b1": (256,),
              "ln_scale": (256,), "ln_bias": (256,), "w2": (64, 128),
              "b2": (128,)}
    args = dict(hyper=hyper, w1=w1, b1=b1, ln_scale=ln_scale,
                ln_bias=ln_bias, w2=w2, b2=b2)
    if C != 256:
        raise ValueError(f"decode_tail_stats: keys have {C} channels, not 256")
    for name, t in args.items():
        check_cuda(t, name, f32)
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"decode_tail_stats: {name} {tuple(t.shape)} "
                             f"!= {shapes[name]}")
    if keys.data_ptr() % 16:
        raise ValueError("decode_tail_stats: keys must be 16-byte aligned")
    if (res1 is None) != (res0 is None):
        raise ValueError("decode_tail_stats: res1 and res0 come together")
    if res1 is not None:
        for name, t, c in (("res1", res1, 256), ("res0", res0, 512)):
            check_cuda(t, name, keys.dtype, ndim=2)
            if tuple(t.shape) != (N, c):
                raise ValueError(f"decode_tail_stats: {name} "
                                 f"{tuple(t.shape)} != {(N, c)}")
    bufs = prepare(keys, w1, w2)
    launch(keys, hyper, b1, ln_scale, ln_bias, b2, *bufs,
           mask_threshold, stability_offset, ln_eps, res1, res0)
    return bufs[-1]


def prepare(keys, w1, w2):
    """The kernel's operands and outputs besides the caller's tensors:
    (w1s, w2s, partial, stats), the weights split and transposed."""
    P, N, _ = keys.shape
    n_tiles = -(-N // ROW_TILE[keys.dtype])
    dev, f32 = keys.device, torch.float32
    return (_split_t(w1), _split_t(w2),
            torch.empty((P, n_tiles, 8, 12), dtype=f32, device=dev),
            torch.empty((P, 8, 12), dtype=f32, device=dev))


def launch(keys, hyper, b1, ln_scale, ln_bias, b2, w1s, w2s, partial, stats,
           mask_threshold, stability_offset, ln_eps, res1=None,
           res0=None) -> None:
    """One launch on checked, prepared operands (`prepare`); res1 and res0
    None for SAM's tail."""
    P, N, _ = keys.shape
    KERNEL.launches += 1
    KERNEL.call("decode_tail_stats", ptr(keys), ptr(hyper), ptr(w1s), ptr(b1),
                ptr(ln_scale), ptr(ln_bias), ptr(w2s), ptr(b2), ptr(res1),
                ptr(res0), ptr(partial), ptr(stats), P, N, _side(N),
                float(mask_threshold),
                float(stability_offset), float(ln_eps),
                int(keys.dtype == torch.bfloat16), current_stream(keys.device))


def decode_tail_stats(keys, hyper, w1, b1, ln_scale, ln_bias, w2, b2, *,
                      mask_threshold: float = 0.0,
                      stability_offset: float = 1.0,
                      ln_eps: float = 1e-6, res1=None,
                      res0=None) -> torch.Tensor:
    """keys (P, N, 256) with N = side^2; hyper (P, 3, 32); the tail's
    weights in the kernel layout (`MaskDecoder.tail_kernel_params`), with
    SAM 2's per-image residuals res1 (N, 256) and res0 (N, 512) in the
    keys' dtype where the decoder has them.  Returns (P, 8, 12) float32
    statistics."""
    fn = (decode_tail_stats_plain if keys.device.type == "cpu"
          else decode_tail_stats_cuda)
    if res1 is not None:  # P x N key rows of the residual form
        count("sam2.tail_residual_rows", keys.shape[0] * keys.shape[1])
    return fn(keys, hyper, w1, b1, ln_scale, ln_bias, w2, b2,
              mask_threshold=mask_threshold,
              stability_offset=stability_offset, ln_eps=ln_eps, res1=res1,
              res0=res0)


def fold_stats(stats: torch.Tensor, upscale: float):
    """(P, 8, 12) statistics -> per-token stability (P, 3), boxes
    (P, 3, 4) xyxy [xmin, ymin, xmax + 1, ymax + 1] * upscale (zeros for
    an empty mask), and the pixel count above threshold (P, 3)."""
    s = stats.reshape(stats.shape[0], 8, 4, 3)  # cols (e * 2 + f, t)
    hi = s[:, 0].sum(1)
    lo = s[:, 1].sum(1)
    xmin = s[:, 2].amin(1)
    ymin = s[:, 3].amin(1)
    xmax = s[:, 4].amax(1)
    ymax = s[:, 5].amax(1)
    n_pos = s[:, 6].sum(1)
    stability = hi / torch.clamp_min(lo, 1.0)
    boxes = torch.stack([xmin, ymin, xmax + 1.0, ymax + 1.0], -1) * upscale
    boxes = torch.where((n_pos > 0)[..., None], boxes, 0.0)
    return stability, boxes, n_pos
