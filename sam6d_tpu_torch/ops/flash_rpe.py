"""Flash attention, with and without the decomposed rel-pos bias.

Counterpart of `sam6d_tpu/ops/pallas/flash_rpe.py`:

* `flash_rpe_attention` (K4, replaces `flash_rpe_attention`, `:92`; the
  SAM image encoder's attention, every block): softmax(q k^T / sqrt(d) +
  bias) v with the decomposed relative-position bias of
  segment_anything's add_decomposed_rel_pos;
* `flash_attention` (K5, replaces `flash_attention`, `:229`; the DINOv2
  descriptor ViT's attention): softmax(q k^T / sqrt(d)) v.

Both launch the CUDA kernel `csrc/flash_rpe.cu` for tensors on the card
(one launch a call: the K4 kernel takes the raw (2h - 1, d) / (2w - 1, d)
tables in q's dtype and builds each block's per-token tables itself) and
compute their plain PyTorch versions (`rpe_attention_plain`,
`attention_plain`: the materialized attention, with the float32 tables of
`rel_pos_tables`) for tensors on the CPU.  On the H100 the global SAM
blocks (16, 4096, 80) are bound by operations (the bf16 tensor cores),
the 196-token windows (400, 196, 80) and DINOv2's 257 tokens (128 or
4096 batch-heads at d = 64) by bytes (q, k, v read once, the output
written once); `chip_smoke.py` computes both bounds from each run's
inputs.  The bf16 kernel streams K/V through a cp.async ring, feeds
mma.sync from ldmatrix, runs one or two 16-row query tiles a warp and
skips the 8-key n-tiles beyond N (design and reasons in the source's
head comment).  Logits and softmax are float32 on both routes; the plain
versions round the probabilities to the input dtype before the product
with v, as the JAX reference does.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sam6d_tpu_torch.ops._kernels import Kernel, check_cuda, current_stream, ptr

_V = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_RPE = Kernel(
    "flash_rpe_attention", "flash_rpe.cu",
    replaces="sam6d_tpu/ops/pallas/flash_rpe.py:92",
    signatures={"flash_attn_fwd": [_V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I,
                                   _I, _V]},
)
# K5 shares K4's source and library; it keeps its own launch count.
KERNEL_PLAIN = Kernel(
    "flash_attention", "flash_rpe.cu",
    replaces="sam6d_tpu/ops/pallas/flash_rpe.py:229",
    signatures=KERNEL_RPE.signatures,
)

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID = 64


def rel_pos_tables(q, rel_pos_h, rel_pos_w, hw):
    """Per-token tables QRh[z, n, Y] = q[z, n].Rh[y(n) - Y + h - 1] (BH, N, h)
    and QRw[z, n, X] = q[z, n].Rw[x(n) - X + w - 1] (BH, N, w), float32."""
    BH, N, d = q.shape
    h, w = hw
    qg = q.float().reshape(BH, h, w, d)
    qa_h = qg @ rel_pos_h.float().T  # (BH, h, w, 2h - 1)
    qa_w = qg @ rel_pos_w.float().T  # (BH, h, w, 2w - 1)
    ar_h = torch.arange(h, device=q.device)
    ar_w = torch.arange(w, device=q.device)
    idx_h = (ar_h[:, None] - ar_h[None, :] + h - 1)[None, :, None, :]
    idx_w = (ar_w[:, None] - ar_w[None, :] + w - 1)[None, None, :, :]
    qrh = torch.gather(qa_h, -1, idx_h.expand(BH, h, w, h))
    qrw = torch.gather(qa_w, -1, idx_w.expand(BH, h, w, w))
    return qrh.reshape(BH, N, h), qrw.reshape(BH, N, w)


def rpe_attention_plain(q, k, v, rel_pos_h, rel_pos_w, hw):
    """The unfused formulation (`rpe_attention_reference`), with float32
    logits and softmax."""
    BH, N, d = q.shape
    h, w = hw
    attn = (q.float() @ k.float().transpose(1, 2)) * (1.0 / math.sqrt(d))
    qrh, qrw = rel_pos_tables(q, rel_pos_h, rel_pos_w, hw)
    attn = (attn.reshape(BH, N, h, w) + qrh[..., :, None]
            + qrw[..., None, :]).reshape(BH, N, N)
    p = torch.softmax(attn, dim=-1).to(q.dtype)
    return p @ v


def attention_plain(q, k, v):
    """softmax(q k^T / sqrt(d)) v, materialized, float32 logits."""
    d = q.shape[-1]
    attn = (q.float() @ k.float().transpose(1, 2)) / math.sqrt(d)
    return torch.softmax(attn, dim=-1).to(q.dtype) @ v


def _check_qkv(q, k, v):
    s = q.shape
    # The common case as one expression: at the small shapes a call's host
    # time is most of its time.  A miss goes through the checks below,
    # which say what is wrong.
    if (q.is_cuda and k.is_cuda and v.is_cuda and q.dtype in _DTYPES
            and k.dtype == q.dtype and v.dtype == q.dtype and len(s) == 3
            and k.shape == s and v.shape == s and s[2] in HEAD_DIMS
            and q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and not (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15):
        return
    dtype = q.dtype
    if dtype not in _DTYPES:
        raise ValueError(f"flash attention: unsupported dtype {dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(t, name, dtype, ndim=3)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} differ")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention: q, k, v must be 16-byte aligned")


def launch(kernel, q, k, v, rel_pos_h, rel_pos_w, hw, out):
    """One launch of the kernel on inputs the wrapper has checked, into
    `out` (q's shape and dtype); rel_pos_h / rel_pos_w None for K5."""
    BH, N, d = q.shape
    kernel.launches += 1
    kernel.call("flash_attn_fwd", ptr(q), ptr(k), ptr(v), ptr(rel_pos_h),
                ptr(rel_pos_w), ptr(out), BH, N, d, hw[0], hw[1],
                int(q.dtype == torch.bfloat16), current_stream(q.device))
    return out


def _check_table(t, name, side, q):
    check_cuda(t, name, q.dtype, ndim=2)
    if tuple(t.shape) != (2 * side - 1, q.shape[-1]):
        raise ValueError(f"flash_rpe_attention: {name} {tuple(t.shape)}, "
                         f"want ({2 * side - 1}, {q.shape[-1]})")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_rpe_attention: {name} must be 16-byte "
                         f"aligned")


def flash_rpe_attention_cuda(q, k, v, rel_pos_h, rel_pos_w, hw):
    _check_qkv(q, k, v)
    h, w = hw
    if h * w != q.shape[1] or h > MAX_GRID or w > MAX_GRID:
        raise ValueError(f"flash_rpe_attention: grid {hw} vs N={q.shape[1]}"
                         f" (h, w <= {MAX_GRID})")
    _check_table(rel_pos_h, "rel_pos_h", h, q)
    _check_table(rel_pos_w, "rel_pos_w", w, q)
    return launch(KERNEL_RPE, q, k, v, rel_pos_h, rel_pos_w, hw,
                  torch.empty_like(q))


def flash_attention_cuda(q, k, v):
    _check_qkv(q, k, v)
    return launch(KERNEL_PLAIN, q, k, v, None, None, (0, 0),
                  torch.empty_like(q))


def flash_rpe_attention(q, k, v, rel_pos_h, rel_pos_w, hw):
    """q, k, v (BH, N, d) with N = h * w tokens in row-major (y, x) order;
    rel_pos_h (2h - 1, d), rel_pos_w (2w - 1, d).  Returns (BH, N, d) in
    q's dtype."""
    if q.device.type == "cpu":
        return rpe_attention_plain(q, k, v, rel_pos_h, rel_pos_w, hw)
    return flash_rpe_attention_cuda(q, k, v, rel_pos_h, rel_pos_w, hw)


def flash_attention(q, k, v):
    """q, k, v (BH, N, d) -> (BH, N, d) in q's dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return flash_attention_cuda(q, k, v)
