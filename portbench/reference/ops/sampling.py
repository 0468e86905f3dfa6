"""Weighted hypothesis sampling by inverse CDF.

Plain copy of `sam6d_tpu_torch/ops/sampling.py:weighted_sample_2d`.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.pointcloud import batched_row_gather

# The CDFs are compared in float16, as in the reference: near cdf ~ 1 its
# spacing is 2^-11, so a bin's mass moves by at most ~0.05% absolute.
CDF_COMPARE_DTYPE = torch.float16


def weighted_sample_2d(scores: torch.Tensor, num_samples: int,
                       u1: torch.Tensor | None = None,
                       u2: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       eps: float = 1e-8):
    """Sample (row, col) pairs in proportion to (B, N, M) scores.

    The row is drawn from the (B, N) marginal CDF, then the column from
    the chosen row's conditional CDF.  u1, u2: optional (B, S, 1) float32
    uniforms in [0, 1); when absent they are drawn from `generator`.

    Returns (idx_n, idx_m), each (B, num_samples) int64.
    """
    B, N, M = scores.shape
    shape = (B, num_samples, 1)
    if u1 is None or u2 is None:
        if generator is None:
            raise ValueError("weighted_sample_2d needs uniforms or a generator")
        u1 = torch.rand(shape, generator=generator, device=scores.device)
        u2 = torch.rand(shape, generator=generator, device=scores.device)
    cmp = CDF_COMPARE_DTYPE
    row_cdf = torch.cumsum(scores.sum(dim=2), dim=1)
    row_cdf = (row_cdf / (row_cdf[:, -1:] + eps)).to(cmp)
    # side='left' searchsorted == count of CDF entries strictly below u.
    idx_n = (row_cdf[:, None, :] < u1.to(cmp)).sum(dim=2).clamp(0, N - 1)
    col_cdf = torch.cumsum(scores, dim=2)
    col_cdf = (col_cdf / (col_cdf[:, :, -1:] + eps)).to(cmp)
    rows = batched_row_gather(col_cdf, idx_n)  # (B, S, M)
    idx_m = (rows < u2.to(cmp)).sum(dim=2).clamp(0, M - 1)
    return idx_n, idx_m
