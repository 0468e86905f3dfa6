"""Inputs of the weighted Procrustes tests at the pose solves' shapes.

`procrustes_case(case, rng)` gives numpy float32 (src, ref, weights,
weight_thresh): the coarse solve's (4, 6000) three-point hypotheses
without weights, or the fine solve's 3 problems of 2048 weighted
correspondences, ref a rigid image of src with noise.  A suffix makes the
case harder: `_reflected` (the det-sign fix has work), `_rank2` (planar
sets), `_rank1` (sets on a line through 0); `fine_zero_weights` gives one
problem no weight at all.
"""

import numpy as np

CASES = ("coarse", "coarse_reflected", "coarse_rank2", "coarse_rank1",
         "fine", "fine_reflected", "fine_rank2", "fine_rank1",
         "fine_zero_weights")


def rotations(rng, n):
    """n random proper rotations, (n, 3, 3) float32."""
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1.0
    return q.astype(np.float32)


def procrustes_case(case, rng):
    """(src (*lead, n, 3), ref (*lead, n, 3), weights (*lead, n) or None,
    weight_thresh) of one case."""
    if case.startswith("coarse"):
        lead, n = (4, 6000), 3
    else:
        lead, n = (3,), 2048
    P = int(np.prod(lead))
    src = rng.randn(P, n, 3).astype(np.float32)
    if case.endswith("rank2"):  # planar sets: H of rank 2
        src[..., 2] = 0.0
        src = src @ rotations(rng, P)
    elif case.endswith("rank1"):  # sets on a line through 0: H of rank 1
        src = rng.randn(P, n, 1) * rng.randn(P, 1, 3)
        src = src.astype(np.float32)
    ref = (src @ np.swapaxes(rotations(rng, P), 1, 2)
           + rng.randn(P, 1, 3).astype(np.float32)
           + 0.01 * rng.randn(P, n, 3).astype(np.float32))
    if case.endswith("reflected"):  # the sign fix has work to do
        ref = -ref
    weights, thresh = None, 0.0
    if case.startswith("fine"):
        weights = rng.rand(P, n).astype(np.float32)
        weights[:, ::5] = 0.0
        thresh = 0.1  # and a tenth of them below the threshold
        if case == "fine_zero_weights":  # no foreground at all
            weights[1] = 0.0
    return (np.ascontiguousarray(src.reshape(*lead, n, 3)),
            np.ascontiguousarray(ref.reshape(*lead, n, 3)),
            None if weights is None
            else np.ascontiguousarray(weights.reshape(*lead, n)),
            thresh)
