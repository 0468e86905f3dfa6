"""K4 and K5 of the port (`sam6d_tpu_torch/ops/flash_rpe.py`) against the
JAX package's Pallas kernels in interpret mode, on the CPU.

On CPU tensors the port's wrappers compute their plain versions, so these
tests hold the plain versions to the TPU kernels; the CUDA kernels are
held to the plain versions on the card (test_torch_kernels_cuda.py).

Tolerances in float32: atol 2e-5 / rtol 2e-4 as the JAX package holds
its kernel to its reference (tests/test_flash_rpe.py) -- the two sum the
softmax in another order; 1e-4 / 1e-3 with logits scaled by 40, where the
exponentials amplify the rounding of the logits.

In bfloat16 (the serving dtype, at the SAM window and DINOv2 shapes) the
port's plain versions are held to the Pallas kernels at the tolerance the
card holds the CUDA kernels to the plain versions: atol 5% of the
outputs' standard deviation, rtol 1.6e-2 (two bf16 steps: each side
rounds its output).  Beyond the order of the sums, the two differ in one
place: the JAX function builds QRh / QRw with a bf16 einsum, so its
tables are rounded to q's dtype (`sam6d_tpu/ops/pallas/flash_rpe.py:136-
143`), where the port keeps them in float32 (ROADMAP section 3).  At
these draws the worst element uses under half of the limit; with the
tables zeroed the outputs fall outside it, so the test sees the bias.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sam6d_tpu.ops.pallas.flash_rpe import flash_attention as j_flash
from sam6d_tpu.ops.pallas.flash_rpe import flash_rpe_attention as j_rpe
from sam6d_tpu_torch.ops import flash_rpe as tf

torch.set_num_threads(2)


def _case(rng, BH, h, w, d):
    N = h * w
    q = (rng.randn(BH, N, d) * 0.3).astype(np.float32)
    k = (rng.randn(BH, N, d) * 0.3).astype(np.float32)
    v = rng.randn(BH, N, d).astype(np.float32)
    rh = (rng.randn(2 * h - 1, d) * 0.1).astype(np.float32)
    rw = (rng.randn(2 * w - 1, d) * 0.1).astype(np.float32)
    return q, k, v, rh, rw


def _both(q, k, v, rh, rw, hw, bq, bk):
    want = j_rpe(*map(jnp.asarray, (q, k, v, rh, rw)), hw, block_q=bq,
                 block_k=bk, interpret=True)
    got = tf.flash_rpe_attention(*map(torch.from_numpy, (q, k, v, rh, rw)),
                                 hw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("BH,h,w,d,bq,bk", [
    (3, 8, 8, 16, 32, 32),      # multi-block square grid
    (2, 14, 14, 80, 256, 256),  # SAM windowed shape (padded blocks)
    (1, 8, 16, 24, 64, 32),     # rectangular grid, uneven blocks
])
def test_rpe_plain_matches_pallas_kernel(rng, BH, h, w, d, bq, bk):
    got, want = _both(*_case(rng, BH, h, w, d), (h, w), bq, bk)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)


def test_rpe_plain_survives_large_logits(rng):
    q, k, v, rh, rw = _case(rng, 1, 8, 8, 16)
    got, want = _both(q * 40.0, k, v, rh, rw, (8, 8), 32, 32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_rel_pos_tables_select_the_decomposed_bias(rng):
    # QRh[n, Y] + QRw[n, X] is the bias of query n against key (Y, X) of
    # add_decomposed_rel_pos: check it against the direct gather.
    q, _, _, rh, rw = _case(rng, 2, 3, 5, 16)
    qt = torch.from_numpy(q)
    qrh, qrw = tf.rel_pos_tables(qt, torch.from_numpy(rh),
                                 torch.from_numpy(rw), (3, 5))
    for n in range(15):
        y, x = divmod(n, 5)
        for Y in range(3):
            np.testing.assert_allclose(
                qrh[:, n, Y].numpy(), q[:, n] @ rh[y - Y + 2], atol=1e-6)
        for X in range(5):
            np.testing.assert_allclose(
                qrw[:, n, X].numpy(), q[:, n] @ rw[x - X + 4], atol=1e-6)


def test_flash_attention_plain_matches_pallas_kernel(rng):
    # The DINOv2 length: 257 tokens, not a multiple of the blocks.
    BH, N, d = 4, 257, 64
    q = (rng.randn(BH, N, d) * 0.3).astype(np.float32)
    k = (rng.randn(BH, N, d) * 0.3).astype(np.float32)
    v = rng.randn(BH, N, d).astype(np.float32)
    want = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), block_q=128,
                              block_k=128, interpret=True))
    got = tf.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-4)


def test_wrappers_take_the_plain_version_only_on_the_cpu(rng):
    q, k, v, rh, rw = map(torch.from_numpy, _case(rng, 1, 4, 4, 16))
    before = (tf.KERNEL_RPE.launches, tf.KERNEL_PLAIN.launches)
    tf.flash_rpe_attention(q, k, v, rh, rw, (4, 4))
    tf.flash_attention(q, k, v)
    assert (tf.KERNEL_RPE.launches, tf.KERNEL_PLAIN.launches) == before
    # A tensor that is not on the CPU goes to the kernel's checks, never
    # to the plain version.
    with pytest.raises(ValueError, match="CUDA"):
        tf.flash_attention_cuda(q, k, v)


def _bf16(*arrays):
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrays],
            [torch.from_numpy(a).bfloat16() for a in arrays])


def _bf16_close(got, want):
    err = np.abs(got - want)
    return bool((err <= 0.05 * want.std() + 1.6e-2 * np.abs(want)).all())


@pytest.mark.parametrize("BH,h,w,d", [
    (2, 14, 14, 80),  # SAM windowed block
    (2, 7, 9, 64),    # rectangular grid, d = 64
])
def test_rpe_plain_matches_pallas_kernel_bf16(rng, BH, h, w, d):
    N = h * w
    q, k, v = (rng.randn(BH, N, d).astype(np.float32) for _ in range(3))
    rh = (rng.randn(2 * h - 1, d) * 0.1).astype(np.float32)
    rw = (rng.randn(2 * w - 1, d) * 0.1).astype(np.float32)
    (jq, jk, jv, jrh, jrw), (tq, tk, tv, trh, trw) = _bf16(q, k, v, rh, rw)
    want = np.asarray(j_rpe(jq, jk, jv, jrh, jrw, (h, w), block_q=256,
                            block_k=256, interpret=True).astype(jnp.float32))
    got = tf.flash_rpe_attention(tq, tk, tv, trh, trw, (h, w)).float()
    assert _bf16_close(got.numpy(), want)
    no_bias = tf.flash_rpe_attention(tq, tk, tv, trh * 0, trw * 0, (h, w))
    assert not _bf16_close(no_bias.float().numpy(), want)


@pytest.mark.parametrize("BH,N,d", [
    (2, 257, 64),  # DINOv2-L
    (2, 300, 64),  # N not a multiple of the 8-key n-tile
])
def test_flash_attention_plain_matches_pallas_kernel_bf16(rng, BH, N, d):
    q, k, v = (rng.randn(BH, N, d).astype(np.float32) for _ in range(3))
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    want = np.asarray(j_flash(jq, jk, jv, block_q=128, block_k=128,
                              interpret=True).astype(jnp.float32))
    got = tf.flash_attention(tq, tk, tv).float().numpy()
    assert _bf16_close(got, want)
