"""Coarse and fine point-matching heads and their pose solvers.

Counterpart of `sam6d_tpu/models/pem/matching.py` (reference
coarse_point_matching.py, fine_point_matching.py, model_utils.py:157-341).
With `train=True` both heads return an attention map per block, the fine
stage starts from the ground-truth pose perturbed by `aug_pose_noise` and
skips its pose solve, and the positional encoding's BatchNorms use and
update batch statistics.  Geometric contractions run in float32 (the
package disables TF32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.config import CoarseMatchingConfig, FineMatchingConfig
from sam6d_tpu_torch.models.layers import BatchNorm, Dense
from sam6d_tpu_torch.models.pem.transformer import (
    GeometricTransformer,
    SparseToDenseTransformer,
)
from sam6d_tpu_torch.ops.distance_field import sample_min_dist
from sam6d_tpu_torch.ops.geometry import (
    compute_feature_similarity,
    pairwise_distance,
)
from sam6d_tpu_torch.ops.pointcloud import (
    ball_query_from_d2,
    gather_neighbors,
    gather_points,
)
from sam6d_tpu_torch.ops.procrustes import weighted_procrustes
from sam6d_tpu_torch.ops.sampling import weighted_sample_2d
from sam6d_tpu_torch.utils.timer import stage


def _smallest_k(x, k: int):
    """Indices of the k smallest entries along the last axis, ties to the
    lower index (lax.top_k of -x)."""
    return torch.sort(x, dim=-1, stable=True).indices[..., :k]


def _largest_k(x, k: int):
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _take(x, idx):
    """x (B, P, ...) rows at idx (B, K) -> (B, K, ...)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def _rescore(R_c, t_c, pts1, model_pts, w1, w1sum):
    """Inverse mean distance of the assigned observed points, mapped back
    by each hypothesis, to the model cloud: (B, c) scores."""
    transformed = (pts1[:, None] - t_c[:, :, None, :]) @ R_c  # (B, c, N1, 3)
    xy = torch.matmul(transformed, model_pts[:, None].transpose(-1, -2))
    x2 = (transformed * transformed).sum(-1)
    m2 = (model_pts * model_pts).sum(-1)
    d2 = x2[..., None] - 2.0 * xy + m2[:, None, None, :]
    dmin = torch.sqrt(torch.clamp_min(d2.amin(dim=-1), 0.0))
    return w1sum[:, None] / ((dmin * w1[:, None, :]).sum(2) + 1e-8)


def compute_coarse_Rt(atten, pts1, pts2, model_pts=None,
                      n_proposal1: int = 6000, n_proposal2: int = 300,
                      score_chunk: int = 50, dist_field=None,
                      n_refine: int = 32,
                      uniforms=None, generator=None,
                      return_score: bool = False):
    """Hypothesis-sampled coarse pose from the (B, 1+N1, 1+N2) attention.

    uniforms: optional (u1, u2), each (B, 3 * n_proposal1, 1), for the
    hypothesis draws; else they come from `generator`.

    Returns (R, t): pts1 ~ pts_model @ R^T + t (normalised space), and
    with `return_score` the winner's score (B,) as a third value (the
    hypothesis-parallel solve compares it across ranks).
    """
    B = atten.shape[0]
    if model_pts is None:
        model_pts = pts2
    pred_score = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    label1 = torch.argmax(pred_score[:, 1:, :], dim=2)
    label2 = torch.argmax(pred_score[:, :, 1:], dim=1)
    w1 = (label1 > 0).to(pred_score.dtype)
    w2 = (label2 > 0).to(pred_score.dtype)
    scores = pred_score[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    u1, u2 = uniforms if uniforms is not None else (None, None)
    idx1, idx2 = weighted_sample_2d(scores ** 1.5, n_proposal1 * 3, u1, u2,
                                    generator=generator)
    p1 = gather_points(pts1, idx1).reshape(B, n_proposal1, 3, 3)
    p2 = gather_points(pts2, idx2).reshape(B, n_proposal1, 3, 3)
    Rs, ts = weighted_procrustes(p2, p1)

    # Keep the n2 hypotheses with the smallest triplet self-residual.
    resid = (p1 - ts[:, :, None, :]) @ Rs - p2
    dis = torch.linalg.vector_norm(resid, dim=3).mean(dim=2)
    keep = _smallest_k(dis, n_proposal2)
    Rs, ts = _take(Rs, keep), _take(ts, keep)
    w1sum = w1.sum(dim=1)

    if dist_field is not None:
        # Pre-score every kept hypothesis by voxel lookups, rescore the
        # leading n_refine exactly.
        def comp(k):
            return sum(
                (pts1[:, None, :, j] - ts[:, :, j, None]) * Rs[:, :, j, k, None]
                for j in range(3)
            )

        d_approx = sample_min_dist(dist_field, comp(0), comp(1), comp(2))
        approx = w1sum[:, None] / ((d_approx * w1[:, None, :]).sum(2) + 1e-8)
        refine = _largest_k(approx, min(n_refine, n_proposal2))
        Rs, ts = _take(Rs, refine), _take(ts, refine)
        hyp_scores = _rescore(Rs, ts, pts1, model_pts, w1, w1sum)
    else:
        n_chunks = max(1, n_proposal2 // score_chunk)
        chunk = n_proposal2 // n_chunks
        hyp_scores = torch.cat([
            _rescore(Rs[:, lo:lo + chunk], ts[:, lo:lo + chunk], pts1,
                     model_pts, w1, w1sum)
            for lo in range(0, n_chunks * chunk, chunk)
        ], dim=1)
    best = torch.argmax(hyp_scores, dim=1)
    rows = torch.arange(B, device=atten.device)
    if return_score:
        return Rs[rows, best], ts[rows, best], hyp_scores[rows, best]
    return Rs[rows, best], ts[rows, best]


def compute_fine_Rt(atten, pts1, pts2, model_pts=None,
                    dis_thres: float = 0.15):
    """Dense expectation-correspondence pose + inlier score
    (reference model_utils.py:308-341).  Returns (R, t, pose_score)."""
    if model_pts is None:
        model_pts = pts2
    mat = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    label1 = torch.argmax(mat[:, 1:, :], dim=2)
    label2 = torch.argmax(mat[:, :, 1:], dim=1)
    fg1 = (label1 > 0).to(mat.dtype)
    fg2 = (label2 > 0).to(mat.dtype)
    mat = mat[:, 1:, 1:] * fg1[:, :, None] * fg2[:, None, :]
    weights = mat.sum(dim=2)
    pred_pts = torch.matmul(mat, pts2) / (weights[..., None] + 1e-6)
    R, t = weighted_procrustes(pred_pts, pts1, weights, weight_thresh=0.0)

    back = (pts1 - t[:, None, :]) @ R
    d2 = pairwise_distance(back, model_pts)
    dmin = torch.sqrt(torch.clamp_min(d2.amin(dim=2), 0.0))
    inlier = (dmin < dis_thres).to(mat.dtype)
    pose_score = (inlier * fg1).sum(1) / (fg1.sum(1) + 1e-8)
    return R, t, pose_score * fg1.mean(dim=1)


def _rot(c, s, axis: int):
    """(B,) cosines and sines -> (B, 3, 3) rotations about x, y or z."""
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rows = {
        0: (o, z, z, z, c, -s, z, s, c),
        1: (c, z, s, z, o, z, -s, z, c),
        2: (c, -s, z, s, c, z, z, z, o),
    }[axis]
    return torch.stack(rows, dim=-1).reshape(-1, 3, 3)


def draw_pose_noise(B: int, generator, device,
                    std_rots=(15.0, 10.0, 5.0, 1.25, 1.0)):
    """`aug_pose_noise`'s draws for a batch of B, in its order: the
    rotation std (one for the batch), n_rot (B, 3), n_trans (B, 3)."""
    pick = torch.randint(len(std_rots), (1,), generator=generator,
                         device=device)
    std_rot = torch.tensor(std_rots, device=device)[pick]
    n_rot = torch.randn(B, 3, generator=generator, device=device)
    n_trans = torch.randn(B, 3, generator=generator, device=device)
    return std_rot, n_rot, n_trans


def aug_pose_noise(gt_r, gt_t, noise=None, generator=None,
                   std_rots=(15.0, 10.0, 5.0, 1.25, 1.0), max_rot=45.0,
                   sel_std_trans=(0.2, 0.2, 0.2), max_trans=0.8):
    """Perturb the ground-truth pose for the fine stage's training init
    (reference model_utils.py:157-201).

    noise: optional (std_rot, n_rot (B, 3), n_trans (B, 3)): the rotation
    std in degrees, picked from `std_rots`, and two standard-normal draws;
    else they are drawn from `generator`.  Returns (R, t)."""
    dev = gt_r.device
    if noise is None:
        noise = draw_pose_noise(gt_r.shape[0], generator, dev, std_rots)
    std_rot, n_rot, n_trans = noise
    angles = torch.clamp(n_rot * std_rot, -max_rot, max_rot) * (math.pi / 180.0)
    c, s = torch.cos(angles), torch.sin(angles)
    rand_rot = (_rot(c[:, 0], s[:, 0], 2) @ _rot(c[:, 1], s[:, 1], 0)
                @ _rot(c[:, 2], s[:, 2], 1))
    std_t = torch.tensor(sel_std_trans, device=dev)
    rand_trans = torch.clamp(n_trans * std_t, -max_trans, max_trans)
    t = gt_t + rand_trans
    t = torch.cat([t[:, :2], torch.clamp_min(t[:, 2:], 1e-6)], dim=1)
    return gt_r @ rand_rot, t


class CoarsePointMatching(nn.Module):
    def __init__(self, cfg: CoarseMatchingConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.in_proj = Dense(cfg.input_dim, cfg.hidden_dim, dtype=dtype)
        self.out_proj = Dense(cfg.hidden_dim, cfg.out_dim, dtype=dtype)
        self.bg_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_dim))
        for i in range(cfg.nblock):
            self.add_module(f"transformers_{i}", GeometricTransformer(
                ("self", "cross"), cfg.hidden_dim, cfg.num_heads, dtype))

    def forward(self, p1, f1, geo1, p2, f2, geo2, radius, model_pts,
                dist_field=None, uniforms=None, generator=None,
                train: bool = False, gt_r=None, gt_t=None, noise=None,
                solver=None):
        """-> (init_R, init_t, attention maps).  Serving solves the coarse
        pose from the last block's map (hypothesis draws from `uniforms`
        or `generator`) with `compute_coarse_Rt`, or with `solver`
        (atten, p1, p2, norm_model, dist_field, uniforms, generator) ->
        (R, t) where one is given (the hypothesis-parallel solve,
        `parallel/hyp_parallel.py`); training returns every block's map
        and the ground-truth pose (gt_t radius-normalised) perturbed by
        `aug_pose_noise` (draws from `noise` or `generator`)."""
        cfg = self.cfg
        B = f1.shape[0]
        bg = self.bg_token.expand(B, 1, -1).to(self.dtype)
        f1 = torch.cat([bg, self.in_proj(f1)], dim=1)
        f2 = torch.cat([bg, self.in_proj(f2)], dim=1)
        geo_both = torch.cat([geo1, geo2], dim=0)
        attens = []
        for i in range(cfg.nblock):
            f1, f2 = getattr(self, f"transformers_{i}")(
                f1, geo1, f2, geo2, embeddings_both=geo_both)
            if train or i == cfg.nblock - 1:
                attens.append(compute_feature_similarity(
                    self.out_proj(f1), self.out_proj(f2), cfg.sim_type,
                    cfg.temp, cfg.normalize_feat,
                ))
        if train:
            init_R, init_t = aug_pose_noise(gt_r, gt_t, noise, generator)
            return init_R, init_t, attens
        norm_model = model_pts / (radius[:, None, None] + 1e-6)
        with stage(None, "pem.coarse_solve"):
            if solver is not None:
                init_R, init_t = solver(attens[-1], p1, p2, norm_model,
                                        dist_field, uniforms, generator)
            else:
                init_R, init_t = compute_coarse_Rt(
                    attens[-1], p1, p2, norm_model, cfg.nproposal1,
                    cfg.nproposal2, dist_field=dist_field,
                    uniforms=uniforms, generator=generator,
                )
        return init_R, init_t, attens


class SharedMLP(nn.Module):
    """Dense (no bias) + BatchNorm + ReLU stack applied pointwise, with the
    first Dense exposed so callers can commute it with a gather."""

    def __init__(self, in_dim: int, channels, dtype=torch.float32):
        super().__init__()
        self.n = len(channels)
        dims = [in_dim, *channels]
        for i in range(self.n):
            self.add_module(f"dense_{i}",
                            Dense(dims[i], dims[i + 1], bias=False, dtype=dtype))
            self.add_module(f"bn_{i}", BatchNorm(dims[i + 1], dtype))

    def forward(self, x, train: bool = False):
        return self.tail(self.first_dense(x), train)

    def first_dense(self, x):
        return self.dense_0(x)

    def tail(self, z, train: bool = False):
        x = F.relu(self.bn_0(z, train))
        for i in range(1, self.n):
            x = F.relu(getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x),
                                                train))
        return x


class PositionalEncoding(nn.Module):
    """Two ball-query scales -> SharedMLP [32, 64, 128] each -> max over
    neighbours -> concat -> Dense(out_dim) (fine_point_matching.py:102-144).
    The first Dense of each scale is applied to the ungrouped points and
    the gather moves its output rows:
    concat(P[idx] - c, P[idx]) @ W = P[idx] @ (Wx + Wf) - c @ Wx."""

    def __init__(self, out_dim: int, r1=0.1, r2=0.2, nsample1=32,
                 nsample2=64, dtype=torch.float32):
        super().__init__()
        self.r1, self.r2 = r1, r2
        self.nsample1, self.nsample2 = nsample1, nsample2
        self.mlp1 = SharedMLP(6, [32, 64, 128], dtype)
        self.mlp2 = SharedMLP(6, [32, 64, 128], dtype)
        self.mlp3 = Dense(256, out_dim, dtype=dtype)

    def forward(self, pts, train: bool = False):
        d2 = pairwise_distance(pts, pts)
        zeros = torch.zeros_like(pts)

        def grouped_mlp(mlp, radius, nsample):
            idx = ball_query_from_d2(d2, radius, nsample)
            a = mlp.first_dense(torch.cat([pts, pts], dim=-1))
            c = mlp.first_dense(torch.cat([pts, zeros], dim=-1))
            z = gather_neighbors(a, idx) - c[:, :, None, :]
            return mlp.tail(z, train).amax(dim=2)

        f1 = grouped_mlp(self.mlp1, self.r1, self.nsample1)
        f2 = grouped_mlp(self.mlp2, self.r2, self.nsample2)
        return self.mlp3(torch.cat([f1, f2], dim=-1))


class FinePointMatching(nn.Module):
    def __init__(self, cfg: FineMatchingConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.in_proj = Dense(cfg.input_dim, cfg.hidden_dim, dtype=dtype)
        self.out_proj = Dense(cfg.hidden_dim, cfg.out_dim, dtype=dtype)
        self.bg_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_dim))
        self.PE = PositionalEncoding(cfg.hidden_dim, cfg.pe_radius1,
                                     cfg.pe_radius2, cfg.pe_nsample1,
                                     cfg.pe_nsample2, dtype)
        for i in range(cfg.nblock):
            self.add_module(f"transformers_{i}", SparseToDenseTransformer(
                cfg.hidden_dim, ("self", "cross"), cfg.num_heads,
                cfg.focusing_factor, dtype))

    def _bg(self, B):
        return self.bg_token.expand(B, 1, -1).to(self.dtype)

    def compute_pe(self, pts, train: bool = False):
        return self.PE(pts, train)

    def compute_f2_init(self, f2, pe_p2):
        """Template-side input tokens (bg | in_proj(f2) + pe): every factor
        is object-static, so the serving bank stores the result."""
        return torch.cat([self._bg(f2.shape[0]), self.in_proj(f2) + pe_p2],
                         dim=1)

    def forward(self, p1, f1, geo1, fps_idx1, p2, geo2, fps_idx2, radius,
                model_pts, init_R, init_t, f2_init=None, f2=None,
                train: bool = False):
        """-> (pred_R, pred_t, pose_score, attention maps).  The template
        side comes precomputed (`f2_init`, the serving bank) or from its
        features `f2`, through the positional encoding of p2 after that of
        the observed side (the BatchNorms' update order in training).
        Training returns every block's map and the init pose, unsolved."""
        cfg = self.cfg
        B = p1.shape[0]
        p1_ = (p1 - init_t[:, None, :]) @ init_R
        f1 = torch.cat([self._bg(B), self.in_proj(f1) + self.PE(p1_, train)],
                       dim=1)
        if f2_init is None:
            f2_init = self.compute_f2_init(f2, self.PE(p2, train))
        f2 = f2_init.to(self.dtype)
        geo_both = torch.cat([geo1, geo2], dim=0)
        attens = []
        for i in range(cfg.nblock):
            f1, f2 = getattr(self, f"transformers_{i}")(
                f1, geo1, fps_idx1, f2, geo2, fps_idx2,
                embeddings_both=geo_both)
            if train or i == cfg.nblock - 1:
                attens.append(compute_feature_similarity(
                    self.out_proj(f1), self.out_proj(f2), cfg.sim_type,
                    cfg.temp, cfg.normalize_feat,
                ))
        if train:
            pred_t = init_t * (radius[:, None] + 1e-6)
            return init_R, pred_t, torch.zeros(B, dtype=p1.dtype,
                                               device=p1.device), attens
        norm_model = model_pts / (radius[:, None, None] + 1e-6)
        with stage(None, "pem.fine_solve"):
            pred_R, pred_t, score = compute_fine_Rt(attens[-1], p1, p2,
                                                    norm_model, cfg.dis_thres)
        return pred_R, pred_t * (radius[:, None] + 1e-6), score, attens
