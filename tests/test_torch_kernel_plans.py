"""The launch plans of the port's kernels, and the tie rule they must keep,
on the CPU.

`fps_plan` picks K1's route and geometry from (B, N) alone, so every shape
the paths use is checked here against the card's limits (H100: 132 SMs,
232,448 bytes of shared memory a block, clusters of at most 16 blocks)
without a card.  The cluster route splits a row over blocks that merge
their candidates by global index; the plain version, which the kernel is
held to on the card, must break exact ties between points that different
blocks hold as the JAX oracle does.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sam6d_tpu.ops.fps import furthest_point_sample as jfps
from sam6d_tpu_torch.ops import fps

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from fps_clouds import cross_block_ties  # noqa: E402

torch.set_num_threads(2)

SMEM_LIMIT = 232448
STATIC_SMEM = 1024  # the kernels' static arrays (slots, warp candidates)

# The K1 calls of the paths: a request (1 and a bucket of 8 instances),
# onboarding (42 views x 5000 points), a training step's template clouds
# and its 2 x 28 observed clouds.
PATH_SHAPES = [(1, 2048), (8, 2048), (1, 210000), (28, 10000), (56, 2048)]
SWEEP = [(1, n) for n in (1, 17, 2048, 2049, 4096, 4097, 10000, 16384,
                          16385, 18432, 18433, 20000, 65536, 131072,
                          210000, 250000, 294912, 300000)]


def _owners(plan, N):
    """How many blocks of the plan hold each point of a row."""
    count = np.zeros(N, np.int64)
    if plan.route == "cluster":
        for r in range(plan.cluster):
            count[r * plan.chunk:min(N, (r + 1) * plan.chunk)] += 1
    else:
        count += 1
    return count


@pytest.mark.parametrize("B,N", PATH_SHAPES + SWEEP)
def test_fps_plan_fits_the_card(B, N):
    plan = fps.fps_plan(B, N)
    assert plan.route in fps.ROUTES
    assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT
    assert 1 <= plan.cluster <= 16
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert B * plan.cluster <= 132
    assert (_owners(plan, N) == 1).all()
    if plan.route == "global":
        return
    # A block's chunk fits its threads' points, padded in shared memory.
    assert plan.chunk <= plan.per * plan.threads
    assert plan.smem_bytes == 12 * plan.per * plan.threads
    if plan.route == "cluster":
        # Every block of the cluster holds part of the row.
        assert plan.cluster >= 2
        assert (plan.cluster - 1) * plan.chunk < N
    else:
        assert plan.cluster == 1 and plan.chunk == N


@pytest.mark.parametrize("B,N,route,cluster,threads", [
    (1, 2048, "block", 1, 256), (8, 2048, "block", 1, 256),
    (56, 2048, "block", 1, 256), (28, 10000, "block", 1, 1024),
    (1, 210000, "cluster", 16, 1024), (1, 294912, "cluster", 16, 1024),
    (1, 300000, "global", 1, 1024), (50, 10000, "block", 1, 1024),
])
def test_fps_plan_routes_by_size(B, N, route, cluster, threads):
    plan = fps.fps_plan(B, N)
    assert (plan.route, plan.cluster, plan.threads) == (route, cluster,
                                                        threads)


def test_fps_plan_names_an_instance_of_the_kernel():
    # The geometries `fps_launch` (csrc/fps.cu) has an instance for: a
    # block of 256 threads of 8 points, of 1024 threads of 4 to 18, a
    # cluster of 1024-thread blocks of 8 to 18 (each holds more than 4096
    # points), or the device-memory route of 1024 threads.
    instances = {("block", 256, 8), ("global", 1024, 0)}
    instances |= {("block", 1024, p) for p in fps.PERS}
    instances |= {("cluster", 1024, p) for p in fps.PERS if p > 4}
    for B, N in PATH_SHAPES + SWEEP:
        plan = fps.fps_plan(B, N)
        assert (plan.route, plan.threads, plan.per) in instances, (B, N)


@pytest.mark.parametrize("kind", ["dup", "lattice"])
def test_fps_plain_breaks_cross_block_ties_as_the_oracle(kind):
    # The clouds of the card test, at 20000 points: a cluster of two
    # blocks (10000 each).  A duplicate at j + N / 2 lies in the other
    # block, and the lattice's equal distances span the boundary; integer
    # coordinates make every d2 exact whatever the rounding.  The lowest
    # index must win every tie.
    N = 20000
    plan = fps.fps_plan(1, N)
    assert plan.route == "cluster" and plan.cluster == 2
    pts = cross_block_ties(N, kind)
    want = np.asarray(jfps(jnp.asarray(pts), 256, use_pallas=False))
    got = fps.fps_plain(torch.from_numpy(pts), 256).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "dup":
        assert (got < N // 2).all()
