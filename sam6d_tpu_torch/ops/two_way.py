"""The image side of SAM's two-way transformer, one pass per key row (K9).

Each `TwoWayAttentionBlock` ends with an image-to-token attention whose
softmax runs over the T prompt tokens of each key row, never over the
keys: the residual, `norm4` and the next token-to-image attention's key
and value projections are all local to a row as well.  `two_way_keys`
does that chain for every (prompt b, key row n):

  x  = keys_in + key_pe;  q = x Wq^T + bq                  (8 heads of 16)
  o  = softmax_T(q . k_tok / 4) v_tok                    (per head, float32)
  y  = LN(keys_in + (o Wo^T + bo))                       (keys_out)
  kp = (y + key_pe) Wk^T + bk;  vp = y Wv^T + bv         (the next attention's)

with keys_in (Bk, N, 256), Bk in {1, B} (1: the layer-0 image side, shared
by every prompt), key_pe (1, N, 256) or (N, 256) float32, k_tok / v_tok
(B, T, 128) the image-to-token attention's projected tokens (any T),
and the weights of `TwoWayWeights`; it returns keys_out (B, N, 256) and
kp, vp split into heads, (B, 8, N, 16), in the compute dtype (the kernel
writes them head-major, so the next token-to-image attention's products
read them without a copy).  The rounding points are those of the
modules (`models/ism/sam/decoder.py`): the products take compute-dtype
operands, q, the logits, the attention's output, o Wo^T, kp and vp are
rounded to the compute dtype, the softmax and the LayerNorm run in
float32, and the residual rounds as keys_in + o Wo^T does.

`two_way_keys` launches the CUDA kernel `csrc/two_way.cu` for tensors on
the card and computes `two_way_keys_plain` (the modules' own arithmetic,
op for op) for tensors on the CPU.  The kernel is forward-only; where
autograd wants a gradient on the card (training a SAM), the launch's
autograd node differentiates the plain version at the same inputs,
recomputed in its backward.  The kernel replaces no TPU kernel (the JAX package leaves this chain to XLA's
fusion): it was added because the chain, run as PyTorch ops, moved about
12.8 GB a prompt batch of 64 through float32 elementwise passes on the
H100.  It is bound by bytes:
per (prompt, row) it must write 1 KB (keys_out, kp, vp in bf16) against
262,144 tensor-core operations.  Counters: `sam.key_rows_fused` and
`sam.key_rows_plain` (B * N rows a call, `utils/timer.count`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr
from sam6d_tpu_torch.utils.timer import count

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "two_way_keys", "two_way.cu",
    replaces="none: XLA's fusion of sam6d_tpu/models/ism/sam/decoder.py:144",
    signatures={"two_way_launch": [_V] * 17 + [_I] * 6 + [ctypes.c_float,
                                                          _V]},
)

C = 256  # key channels
INTERNAL = 128  # the attentions' width: 8 heads of 16
HEADS = 8


class TwoWayWeights(NamedTuple):
    """The weights `two_way_keys` applies ([out, in] as nn.Linear keeps
    them): the image-to-token attention's q and out projections, the
    block's `norm4`, and the next token-to-image attention's k and v
    projections."""
    wq: torch.Tensor
    bq: torch.Tensor
    wo: torch.Tensor
    bo: torch.Tensor
    ln_w: torch.Tensor
    ln_b: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor


WEIGHT_SHAPES = TwoWayWeights((INTERNAL, C), (INTERNAL,), (C, INTERNAL), (C,),
                              (C,), (C,), (INTERNAL, C), (INTERNAL,),
                              (INTERNAL, C), (INTERNAL,))


def two_way_keys_plain(keys, key_pe, k_tok, v_tok, w: TwoWayWeights, dtype,
                       eps: float = 1e-6):
    """`two_way_keys` in plain PyTorch ops: Dense, CrossAttention and
    LayerNorm's arithmetic (`models/layers.py`), op for op."""
    from sam6d_tpu_torch.models.ism.sam.decoder import CrossAttention

    split_heads = CrossAttention.split_heads

    def dense(x, wt, b):
        return F.linear(x.to(dtype), wt.to(dtype), b.to(dtype))

    q = keys + key_pe
    o = CrossAttention.attention(dense(q, w.wq, w.bq), split_heads(k_tok),
                                 split_heads(v_tok), q.dtype)
    y = keys + dense(o, w.wo, w.bo)
    keys = F.layer_norm(y.float(), (y.shape[-1],), w.ln_w, w.ln_b,
                        eps).to(dtype)
    return (keys, split_heads(dense(keys + key_pe, w.wk, w.bk)),
            split_heads(dense(keys, w.wv, w.bv)))


def two_way_keys(keys, key_pe, k_tok, v_tok, w: TwoWayWeights, dtype,
                 eps: float = 1e-6):
    """keys (Bk, N, 256) with Bk in {1, B}, key_pe (1, N, 256) float32,
    k_tok / v_tok (B, T, 128) -> keys_out (B, N, 256), kp and vp split
    into heads, (B, 8, N, 16).
    The kernel on the card (a gradient by the plain version's backward,
    `_TwoWayKeys`); the plain version on the CPU."""
    B, N = k_tok.shape[0], keys.shape[1]
    if keys.device.type == "cpu":
        count("sam.key_rows_plain", B * N)
        return two_way_keys_plain(keys, key_pe, k_tok, v_tok, w, dtype, eps)
    count("sam.key_rows_fused", B * N)
    return _TwoWayKeys.apply(keys.contiguous(), key_pe, k_tok, v_tok, dtype,
                             eps, *w)


class _TwoWayKeys(torch.autograd.Function):
    """One launch of the kernel; its backward recomputes the plain version
    at the saved inputs and differentiates that (the kernel has no
    backward of its own: no cell trains a SAM)."""

    @staticmethod
    def forward(ctx, keys, key_pe, k_tok, v_tok, dtype, eps, *w):
        ctx.save_for_backward(keys, key_pe, k_tok, v_tok, *w)
        ctx.dtype, ctx.eps = dtype, eps
        N = keys.shape[1]
        return two_way_keys_cuda(keys, key_pe.reshape(N, C).contiguous(),
                                 k_tok, v_tok, TwoWayWeights(*w), dtype, eps)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:4] + ctx.needs_input_grad[6:]
        xs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            outs = two_way_keys_plain(*xs[:4], TwoWayWeights(*xs[4:]),
                                      ctx.dtype, ctx.eps)
        want = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(outs, want, grads, allow_unused=True))
        gx = [next(got) if x.requires_grad else None for x in xs]
        return (*gx[:4], None, None, *gx[4:])


def two_way_keys_cuda(keys, key_pe, k_tok, v_tok, w: TwoWayWeights, dtype,
                      eps: float = 1e-6):
    """The kernel on checked operands: keys (Bk, N, 256) float32 or (for
    a bf16 compute dtype) bf16, key_pe (N, 256) float32, k_tok / v_tok
    (B, T, 128) in the compute dtype, any T; the weights as the modules
    keep them ([out, in]).  One launch, after `kernel_weights`; no
    autograd node (`two_way_keys` makes one)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (keys, k_tok, v_tok, *w)):
        raise RuntimeError(
            "two_way_keys_cuda: the CUDA kernel is forward-only and makes no "
            "autograd node, but an input requires a gradient; call it under "
            "torch.no_grad(), or call two_way_keys")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"two_way_keys: unsupported compute dtype {dtype}")
    keys_dtypes = ((torch.float32, torch.bfloat16) if dtype == torch.bfloat16
                   else (torch.float32,))
    if keys.dtype not in keys_dtypes:
        raise ValueError(f"two_way_keys: keys {keys.dtype} with compute "
                         f"dtype {dtype}")
    check_cuda(keys, "keys", keys.dtype, ndim=3)
    check_cuda(key_pe, "key_pe", torch.float32, ndim=2)
    check_cuda(k_tok, "k_tok", dtype, ndim=3)
    check_cuda(v_tok, "v_tok", dtype, ndim=3)
    Bk, N, c = keys.shape
    B, T, i = k_tok.shape
    if (c != C or i != INTERNAL or Bk not in (1, B) or N < 1 or T < 1
            or tuple(key_pe.shape) != (N, C)
            or tuple(v_tok.shape) != (B, T, INTERNAL)):
        raise ValueError(
            f"two_way_keys: bad shapes keys {tuple(keys.shape)}, key_pe "
            f"{tuple(key_pe.shape)}, k_tok {tuple(k_tok.shape)}, v_tok "
            f"{tuple(v_tok.shape)}")
    for name, t in (("keys", keys), ("key_pe", key_pe), ("k_tok", k_tok),
                    ("v_tok", v_tok)):
        if t.data_ptr() % 16:
            raise ValueError(f"two_way_keys: {name} must be 16-byte aligned")
    outs = prepare(keys, k_tok)
    launch(keys, key_pe, k_tok, v_tok, kernel_weights(w, dtype, keys.device),
           *outs, eps)
    return outs


def kernel_weights(w: TwoWayWeights, dtype, device) -> TwoWayWeights:
    """The weights in the kernel's layout: the matrices and biases in the
    compute dtype (a no-op for bf16 once `cast_dense_weights` stored them
    so), the LayerNorm's parameters in float32; float32 matrices
    transposed, [in, out] (the CUDA-core kernel's coalesced reads).
    Checks each against its shape, device and alignment."""
    for name, t, shape in zip(w._fields, w, WEIGHT_SHAPES):
        if t.shape != shape or t.device != device:
            raise ValueError(
                f"two_way_keys: {name} must be {shape} on {device}, got "
                f"{tuple(t.shape)} on {t.device}")
    mats = (lambda t: t.to(dtype).contiguous() if dtype == torch.bfloat16
            else t.float().t().contiguous())
    out = TwoWayWeights(mats(w.wq), w.bq.to(dtype), mats(w.wo),
                        w.bo.to(dtype), w.ln_w.float(), w.ln_b.float(),
                        mats(w.wk), w.bk.to(dtype), mats(w.wv),
                        w.bv.to(dtype))
    for name, t in zip(out._fields, out):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"two_way_keys: {name} must be contiguous and "
                             f"16-byte aligned")
    return out


def prepare(keys, k_tok):
    """The launch's outputs in k_tok's (the compute) dtype: keys_out
    (B, N, 256), and kp and vp head-major, (B, 8, N, 16) contiguous, the
    layout in which the token-to-image attention's products read them
    without a copy."""
    B, N = k_tok.shape[0], keys.shape[1]
    kw = dict(dtype=k_tok.dtype, device=keys.device)
    hd = INTERNAL // HEADS
    return (torch.empty((B, N, C), **kw), torch.empty((B, HEADS, N, hd), **kw),
            torch.empty((B, HEADS, N, hd), **kw))


def launch(keys, key_pe, k_tok, v_tok, w: TwoWayWeights, keys_out, kp, vp,
           eps: float = 1e-6) -> None:
    """One K9 launch on checked, prepared operands (`prepare`), the weights
    in the kernel's layout (`kernel_weights`)."""
    Bk, N, _ = keys.shape
    B, T, _ = k_tok.shape
    KERNEL.launches += 1
    KERNEL.call(
        "two_way_launch", ptr(keys), ptr(key_pe), ptr(k_tok), ptr(v_tok),
        *(ptr(t) for t in w), ptr(keys_out), ptr(kp), ptr(vp), B, N, T,
        int(Bk == 1 and B > 1), int(keys.dtype == torch.bfloat16),
        int(k_tok.dtype == torch.bfloat16), float(eps),
        current_stream(keys.device))
