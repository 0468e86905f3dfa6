"""Hypothesis-parallel coarse pose solve over a mesh axis.

Counterpart of `sam6d_tpu/parallel/hyp_parallel.py` (a shard_map over the
axis; the reference's 6000-hypothesis scoring loop, model_utils.py:
204-275, pinned to the host CPU).  Every rank of the axis samples and
solves its own block of hypotheses from the attention, rescores them,
and one all_gather of (score, R, t) over the axis picks each instance's
winner: the highest score, ties to the lowest rank, as `jnp.argmax`
breaks them.  With a batch axis as well, each rank holds its own rows of
the instance batch and the winners stay on those rows.

Draws: the JAX solve folds the axis index into the key (`fold_in`), so
rank d of the axis draws alike on every batch shard.  Here a rank's
uniforms are injected, or drawn from a generator seeded from the
caller's generator and the axis index.
"""

from __future__ import annotations

import torch

from sam6d_tpu_torch.models.pem.matching import compute_coarse_Rt
from sam6d_tpu_torch.parallel.collectives import all_gather_rows
from sam6d_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


def local_budget(n_dev: int, n_proposal1: int, n_proposal2: int,
                 n_refine: int) -> tuple[int, int, int]:
    """A rank's (hypotheses drawn, kept, refined) of the axis's budget."""
    return (max(n_proposal1 // n_dev, 3), max(n_proposal2 // n_dev, 1),
            max(n_refine // n_dev, 1))


def rank_generator(generator: torch.Generator, index: int,
                   device) -> torch.Generator:
    """A generator for axis index `index`: a seed drawn from the caller's
    generator (equal on every rank that holds it in the same state)
    combined with the index, the analog of `jax.random.fold_in`."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=device).manual_seed(
        (base * 1_000_003 + index) % (2 ** 63))


def sharded_compute_coarse_Rt(mesh, axis: str, atten, pts1, pts2, model_pts,
                              n_proposal1: int = 6000,
                              n_proposal2: int = 300, dist_field=None,
                              n_refine: int = 32, uniforms=None,
                              generator=None):
    """`compute_coarse_Rt` with its hypotheses spread over `axis`.

    Each of the axis's n ranks draws max(n_proposal1 // n, 3)
    hypotheses, keeps max(n_proposal2 // n, 1) and refines max(n_refine
    // n, 1) of them (with `dist_field`, the bank's shared (1, G, G, G)
    field).  The inputs are this rank's rows: the whole batch, or its
    shard of it when the mesh also splits the instances over another
    axis; the solve only reduces over `axis`.
    uniforms: this rank's (u1, u2), each (B_local, 3 * local n1, 1);
    else drawn from `rank_generator(generator, axis index)`.

    Returns (R, t), (B_local, 3, 3) and (B_local, 3), the same on every
    rank of the axis."""
    n_dev = axis_size(mesh, axis)
    local_n1, local_n2, local_refine = local_budget(
        n_dev, n_proposal1, n_proposal2, n_refine)
    local_gen = None
    if uniforms is None:
        local_gen = rank_generator(generator, axis_index(mesh, axis),
                                   atten.device)
    R, t, score = compute_coarse_Rt(
        atten, pts1, pts2, model_pts, n_proposal1=local_n1,
        n_proposal2=local_n2, score_chunk=min(50, local_n2),
        dist_field=dist_field, n_refine=local_refine, uniforms=uniforms,
        generator=local_gen, return_score=True)
    B = R.shape[0]
    packed = torch.cat([score.float()[:, None], R.reshape(B, 9).float(),
                        t.float()], dim=1)  # (B, 13)
    every = all_gather_rows(packed, axis_group(mesh, axis))  # (n, B, 13)
    best = torch.argmax(every[:, :, 0], dim=0)  # first maximum: lowest rank
    win = every[best, torch.arange(B, device=best.device)]
    return win[:, 1:10].reshape(B, 3, 3).to(R.dtype), win[:, 10:].to(t.dtype)
