"""K6 of the port (`sam6d_tpu_torch/ops/decode_tail.py`) against the JAX
package's Pallas kernel in interpret mode, on the CPU.

Tolerances as the JAX package holds its kernel to its reference
(tests/test_decode_tail.py): counts atol 8 and boxes atol 4 pixels -- the
TPU kernel's approximate reciprocal (~2^-14) and tiled-matmul rounding
flip pixels whose logit lies within ~1e-4 of a threshold.  `fold_stats`
is compared exactly on the same statistics.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sam6d_tpu.ops.pallas import decode_tail as jd
from sam6d_tpu_torch.ops import decode_tail as td

torch.set_num_threads(2)


def _inputs(rng, P, N, scale=0.5):
    return dict(
        keys=(rng.randn(P, N, 256) * scale).astype(np.float32),
        hyper=(rng.randn(P, 3, 32) * scale).astype(np.float32),
        w1=(rng.randn(256, 256) * 0.05).astype(np.float32),
        b1=(rng.randn(256) * 0.05).astype(np.float32),
        ln_scale=(1.0 + 0.1 * rng.randn(256)).astype(np.float32),
        ln_bias=(0.1 * rng.randn(256)).astype(np.float32),
        w2=(rng.randn(64, 128) * 0.1).astype(np.float32),
        b2=(rng.randn(128) * 0.05).astype(np.float32),
    )


@pytest.mark.parametrize("N,row_tile", [(64, 64), (256, 64)])
def test_plain_matches_pallas_kernel(N, row_tile):
    inp = _inputs(np.random.RandomState(0), 3, N)
    kw = dict(mask_threshold=0.0, stability_offset=0.3)
    want = np.array(jd.decode_tail_stats(
        **{k: jnp.asarray(v) for k, v in inp.items()}, row_tile=row_tile,
        interpret=True, **kw))
    got = td.decode_tail_stats(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, **kw).numpy()
    assert got.shape == want.shape == (3, 8, 12)
    for rows, atol in (((0, 1, 6), 8), ((2, 3, 4, 5), 4), ((7,), 0)):
        np.testing.assert_allclose(got[:, rows], want[:, rows], atol=atol)

    # fold_stats: the same statistics fold to the same quantities.
    for a, b in zip(td.fold_stats(torch.from_numpy(want), 4.0),
                    jd.fold_stats(jnp.asarray(want), 4.0)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plain_matches_the_reference_mirror_per_column():
    # The kernel layout's columns (e, f, t) sum to the reference's
    # per-token statistics.
    inp = _inputs(np.random.RandomState(1), 2, 64)
    kw = dict(mask_threshold=0.1, stability_offset=0.5)
    ref = jd.decode_tail_stats_reference(
        **{k: jnp.asarray(v) for k, v in inp.items()}, **kw)
    got = td.decode_tail_stats(
        **{k: torch.from_numpy(v) for k, v in inp.items()}, **kw).numpy()
    s = got.reshape(2, 8, 4, 3)
    np.testing.assert_array_equal(s[:, 0].sum(1), np.asarray(ref["hi"]))
    np.testing.assert_array_equal(s[:, 1].sum(1), np.asarray(ref["lo"]))
    np.testing.assert_array_equal(s[:, 6].sum(1), np.asarray(ref["n_pos"]))
    np.testing.assert_array_equal(s[:, 2].min(1), np.asarray(ref["xmin"]))
    np.testing.assert_array_equal(s[:, 5].max(1), np.asarray(ref["ymax"]))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    inp = {k: torch.from_numpy(v)
           for k, v in _inputs(np.random.RandomState(2), 1, 16).items()}
    before = td.KERNEL.launches
    td.decode_tail_stats(**inp)
    assert td.KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        td.decode_tail_stats_cuda(**inp)


def test_bf16_split_reproduces_float32_operands():
    # The kernel's products take each float32 operand as bf16 hi + lo:
    # hi + lo must be the operand to within 2^-16 relative (2^-17 by
    # construction: each part rounds to 8 significant bits).
    rng = np.random.RandomState(3)
    x = (rng.randn(4096) * 10.0 ** rng.randint(-20, 20, 4096)).astype(
        np.float32)
    hi, lo = td.split_bf16(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    back = hi.double() + lo.double()
    rel = (back - torch.from_numpy(x).double()).abs() / torch.from_numpy(
        np.abs(x)).double()
    assert float(rel.max()) <= 2.0 ** -16
    # The kernel's weight layout: (2, out, in), hi then lo of w^T.
    w = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    ws = td._split_t(w)
    assert ws.shape == (2, 128, 64) and ws.dtype == torch.bfloat16
    torch.testing.assert_close(ws[0].float() + ws[1].float(), w.T,
                               atol=0, rtol=2.0 ** -16)
