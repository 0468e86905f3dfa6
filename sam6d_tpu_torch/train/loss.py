"""Correspondence loss over the matching heads' attention maps.

Counterpart of `sam6d_tpu/train/loss.py` (reference
Pose_Estimation_Model/utils/loss_utils.py): per block, the cross-entropy
of each side's attention logits against the nearest-neighbour
correspondence labels under the ground-truth pose (label 0, the
background token, where no neighbour lies within `dis_thres`), plus the
diagnostics acc, fg_num and dis.  The total sums the per-block losses of
both stages, clamps each sample at 100 and averages over the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam6d_tpu_torch.ops.geometry import pairwise_distance


def correspondence_labels(pts1, pts2, gt_r, gt_t, dis_thres: float = 0.15):
    """pts1 (B, N1, 3) observed, pts2 (B, N2, 3) template (normalised),
    gt_r (B, 3, 3), gt_t (B, 3) -> label1 (B, N1) in [0, N2], label2
    (B, N2) in [0, N1] (0 = background) and the observed points mapped
    into the template frame."""
    gt_pts = (pts1 - gt_t[:, None, :]) @ gt_r
    dis_mat = torch.sqrt(pairwise_distance(gt_pts, pts2))
    # argmin takes the first of equal distances, as jnp.argmin does.
    dis1, nn1 = dis_mat.amin(dim=2), dis_mat.argmin(dim=2)
    dis2, nn2 = dis_mat.amin(dim=1), dis_mat.argmin(dim=1)
    label1 = torch.where(dis1 <= dis_thres, nn1 + 1, 0)
    label2 = torch.where(dis2 <= dis_thres, nn2 + 1, 0)
    return label1, label2, gt_pts


def compute_correspondence_loss(attens, pts1, pts2, gt_r, gt_t,
                                dis_thres: float = 0.15,
                                prefix: str = "coarse") -> dict:
    """Per-block losses and diagnostics of one stage, each (B,):
    {prefix}_loss{i}, {prefix}_acc, {prefix}_fg_num, {prefix}_dis."""
    with torch.no_grad():
        label1, label2, gt_pts = correspondence_labels(pts1, pts2, gt_r,
                                                       gt_t, dis_thres)
    out = {}
    for i, atten in enumerate(attens):
        # Observed -> template: logits (B, N1, 1+N2); template -> observed:
        # logits (B, N2, 1+N1).  Class axis second for F.cross_entropy.
        l1 = F.cross_entropy(atten[:, 1:, :].transpose(1, 2), label1,
                             reduction="none").mean(dim=1)
        l2 = F.cross_entropy(atten[:, :, 1:], label2,
                             reduction="none").mean(dim=1)
        out[f"{prefix}_loss{i}"] = 0.5 * (l1 + l2)
    with torch.no_grad():
        pred = torch.argmax(attens[-1][:, 1:, :], dim=2)
        out[f"{prefix}_acc"] = (pred == label1).float().mean(dim=1)
        fg = (pred > 0).float()
        out[f"{prefix}_fg_num"] = fg.sum(dim=1)
        fg_label = (fg * (pred - 1)).long()
        pred_pts = torch.gather(pts2, 1, fg_label[..., None].expand(-1, -1, 3))
        pred_dis = torch.linalg.vector_norm(pred_pts - gt_pts, dim=2)
        out[f"{prefix}_dis"] = (pred_dis * fg).sum(dim=1) / (fg.sum(dim=1)
                                                             + 1e-8)
    return out


def total_loss(end_points: dict):
    """Sum the per-block losses, clamp each sample at 100, average over
    the batch (reference loss_utils.py:56-68).  Returns (loss, metrics),
    each metric the batch mean of its entry."""
    loss = 0.0
    metrics = {}
    for key, val in end_points.items():
        if "coarse_" in key or "fine_" in key:
            metrics[key] = val.mean()
            if "loss" in key:
                loss = loss + val
    loss = torch.clamp_max(loss, 100.0).mean()
    metrics["loss"] = loss
    return loss, metrics


def pem_loss(out: dict, gt_r, gt_t, coarse_dis_thres: float = 0.15,
             fine_dis_thres: float = 0.15):
    """The PEM training loss from `PEM.forward(train=True)`'s outputs; the
    labels live in the radius-normalised space of the attention maps."""
    gt_t_n = gt_t / (out["radius"][:, None] + 1e-6)
    end_points = compute_correspondence_loss(
        out["coarse_attens"], out["sparse_pm"], out["sparse_po"], gt_r,
        gt_t_n, coarse_dis_thres, prefix="coarse")
    end_points.update(compute_correspondence_loss(
        out["fine_attens"], out["dense_pm"], out["dense_po"], gt_r, gt_t_n,
        fine_dis_thres, prefix="fine"))
    return total_loss(end_points)
