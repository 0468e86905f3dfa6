"""Point clouds for the FPS tests, shared by the CPU and the card tests."""

import numpy as np


def cross_block_ties(N, kind, seed=0):
    """(1, N, 3) float32 clouds with exact ties between points that
    different blocks of a cluster hold: "dup" repeats the first half's
    points (integer coordinates) at j + N / 2; "lattice" is an integer
    lattice of at least N points, cut to N, whose equal distances span the
    blocks' chunks."""
    rng = np.random.RandomState(seed)
    if kind == "dup":
        half = rng.randint(0, 64, (N // 2, 3))
        pts = np.concatenate([half, half])
    else:
        side = int(np.ceil(N ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        pts = g.reshape(-1, 3)[:N]
    return pts[None].astype(np.float32)
