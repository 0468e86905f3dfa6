"""Proposal-vs-template scoring for the ISM.

Counterpart of `sam6d_tpu/models/ism/scoring.py` (reference Instance_
Segmentation_Model/model/loss.py PairwiseSimilarity :21-44,
MaskedPatch_MatrixSimilarity :46-116, detector.py :260-322 and
run_inference_custom.py:255): batched products over the proposal axis.
"""

from __future__ import annotations

import torch

from sam6d_tpu_torch.ops.geometry import l2_normalize


def semantic_similarity_matrix(query_desc, ref_desc):
    """(Q, D) proposals x (O, T, D) templates -> (Q, O, T) cosine
    similarities clamped to [0, 1]."""
    sim = torch.einsum("qd,otd->qot", l2_normalize(query_desc),
                       l2_normalize(ref_desc))
    return torch.clamp(sim, 0.0, 1.0)


def aggregate_semantic_score(sim, aggregation: str = "avg_5"):
    """Per-template similarities -> per-object score (detector.py:265-279);
    avg_5 is the mean of the top 5."""
    if aggregation == "mean":
        return sim.mean(-1)
    if aggregation == "median":
        # jnp.median averages the two middle values; torch.median does not.
        return torch.quantile(sim, 0.5, dim=-1)
    if aggregation == "max":
        return sim.amax(-1)
    if aggregation == "avg_5":
        return torch.topk(sim, min(5, sim.shape[-1]), dim=-1).values.mean(-1)
    raise ValueError(f"unknown aggregation {aggregation}")


def semantic_score(query_desc, ref_desc, aggregation: str = "avg_5"):
    """Returns (score, obj_idx, score, best_template, sim): the best
    object's score (Q,), the object (Q,), the best template of that
    object (Q,), and the (Q, O, T) similarities."""
    sim = semantic_similarity_matrix(query_desc, ref_desc)
    per_obj = aggregate_semantic_score(sim, aggregation)  # (Q, O)
    score, obj_idx = per_obj.amax(-1), per_obj.argmax(-1)
    best_template = torch.gather(sim.argmax(-1), 1, obj_idx[:, None])[:, 0]
    return score, obj_idx, score, best_template, sim


def appearance_score(query_patches, ref_patches):
    """Masked patch-matrix similarity (loss.py compute_straight :52-62):
    (Q, Np, D) query patches (zero where invalid) x (Q, Nr, D) -> (Q,)."""
    sim = torch.einsum("qnd,qmd->qnm", query_patches, ref_patches)
    max_ref = sim.amax(-1)
    valid = query_patches.abs().sum(-1) > 0
    factor = valid.sum(-1) + 1e-6
    return torch.clamp((max_ref * valid).sum(-1) / factor, 0.0, 1.0)


def visible_ratio(query_patches, ref_patches, thred: float = 0.5):
    """Fraction of template patches matched above `thred`
    (loss.py compute_visible_ratio :64-76)."""
    sim = torch.einsum("qnd,qmd->qnm", query_patches, ref_patches)
    best = sim.amax(1)
    valid_patches = (best != 0.0).sum(-1) + 1e-6
    return (best > thred).sum(-1) / valid_patches


def bbox_iou(a, b):
    """Elementwise IoU of (N, 4) xyxy boxes (bbox_utils.py:197-221)."""
    x1 = torch.maximum(a[:, 0], b[:, 0])
    y1 = torch.maximum(a[:, 1], b[:, 1])
    x2 = torch.minimum(a[:, 2], b[:, 2])
    y2 = torch.minimum(a[:, 3], b[:, 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter + 1e-9)


def geometric_score(projected_uv, proposal_boxes):
    """IoU of the projected template's box and the proposal box
    (detector.py:310-322): (Q, Npc, 2) uv + (Q, 4) -> (Q,)."""
    proj = torch.cat([projected_uv.amin(1), projected_uv.amax(1)],
                     dim=-1).float()
    return bbox_iou(proj, proposal_boxes)


def final_score(sem, appe, geo, vis):
    """(sem + appe + geo * vis) / (2 + vis) (run_inference_custom.py:255)."""
    return (sem + appe + geo * vis) / (2.0 + vis)
