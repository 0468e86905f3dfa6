"""ISM detector: SAM proposals scored against onboarded templates.

Counterpart of `sam6d_tpu/models/ism/detector.py` (reference Instance_
Segmentation_Model/model/detector.py :25-462 and run_inference_custom.py
:98-267): onboard templates (CLS and masked-patch descriptors), generate
mask proposals, score each against the template bank with the semantic,
appearance and geometric scores, and emit the final detections.

Variable-count work (NMS, filtering) stays on the host in numpy; the
descriptors and scores run on the detector's device over proposal
batches padded to a power of two (minimum 8).  The JAX package caches
`ReferenceData` as a pickle of its own dataclass, which this package
cannot load without importing it; the port caches it as `.npz`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from sam6d_tpu_torch.config import ISMConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.ism import scoring
from sam6d_tpu_torch.ops.geometry import project_points
from sam6d_tpu_torch.utils.bbox import crop_resize_pad, crop_resize_pad_masks
from sam6d_tpu_torch.utils.detections import Detections
from sam6d_tpu_torch.utils.timer import stage

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_rgb(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images (..., 3) -> ImageNet-normalised."""
    return ((images - images.new_tensor(IMAGENET_MEAN))
            / images.new_tensor(IMAGENET_STD))


@dataclass
class ReferenceData:
    """Onboarded object templates (numpy, on the host)."""

    descriptors: np.ndarray  # (O, T, D) CLS descriptors
    appe_descriptors: np.ndarray  # (O, T, Np, D) masked patch descriptors
    poses: np.ndarray  # (T, 4, 4) template object poses
    pointcloud: np.ndarray | None = None  # (O, Npc, 3)

    def save_npz(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        extra = {} if self.pointcloud is None else {
            "pointcloud": self.pointcloud}
        np.savez(path, descriptors=self.descriptors,
                 appe_descriptors=self.appe_descriptors, poses=self.poses,
                 **extra)

    @classmethod
    def load_npz(cls, path: str) -> "ReferenceData":
        with np.load(path) as d:
            return cls(d["descriptors"], d["appe_descriptors"], d["poses"],
                       d["pointcloud"] if "pointcloud" in d.files else None)


def bucket(n: int) -> int:
    """Power-of-two proposal batch, at least 8 (JAX `_bucket`)."""
    b = 8
    while b < n:
        b *= 2
    return b


class ISMDetector:
    """segmentor: `SamAutomaticMaskGenerator`; descriptor:
    `DescriptorModel` with its weights, on `device`."""

    def __init__(self, cfg: ISMConfig, segmentor, descriptor,
                 device="cuda"):
        self.cfg = cfg
        self.segmentor = segmentor
        self.device = resolve_device(device)
        self.descriptor = descriptor.to(self.device)
        self.ref_data: ReferenceData | None = None
        # Proposal counts of the last frame: from the segmentor, after
        # the size filter, the descriptor bucket, above the confidence
        # threshold, and after the per-object NMS.
        self.last_counts: dict = {}

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=self.device, dtype=dtype)

    @torch.no_grad()
    def onboard_templates(self, template_images: np.ndarray,
                          template_masks: np.ndarray,
                          template_poses: np.ndarray,
                          pointcloud: np.ndarray | None = None,
                          cache_path: str | None = None) -> ReferenceData:
        """Template descriptors (reference detector.py:65-134).

        template_images (O, T, S, S, 3) float [0, 1] masked crops,
        template_masks (O, T, S, S) bool, template_poses (T, 4, 4),
        pointcloud (O, Npc, 3).  An existing `.npz` at cache_path replaces
        the computation; a fresh one is saved there."""
        if cache_path and os.path.exists(cache_path):
            self.ref_data = ReferenceData.load_npz(cache_path)
            return self.ref_data
        cls_all, patch_all = [], []
        for o in range(template_images.shape[0]):
            cls, patch = self.descriptor.compute_cls_and_patch(
                normalize_rgb(self._tensor(template_images[o])),
                self._tensor(template_masks[o], torch.bool))
            cls_all.append(cls.float().cpu().numpy())
            patch_all.append(patch.float().cpu().numpy())
        self.ref_data = ReferenceData(
            descriptors=np.stack(cls_all),
            appe_descriptors=np.stack(patch_all),
            poses=np.asarray(template_poses),
            pointcloud=None if pointcloud is None else np.asarray(pointcloud))
        if cache_path:
            self.ref_data.save_npz(cache_path)
        return self.ref_data

    @torch.no_grad()
    def detect(self, image: np.ndarray, depth: np.ndarray | None = None,
               K: np.ndarray | None = None, timer=None) -> Detections:
        """One frame (reference run_inference_custom.py:184-258): image
        (H, W, 3) uint8 RGB, optional metric depth (H, W) and intrinsics
        (3, 3) for the geometric score.  Returns the final detections.
        `timer` (`utils/timer.StageTimer`) records the stages."""
        assert self.ref_data is not None, "call onboard_templates first"
        cfg = self.cfg
        proposals = self.segmentor.generate_masks(image, timer=timer)
        dets = Detections(masks=proposals["masks"], boxes=proposals["boxes"])
        counts = self.last_counts = {"proposals": len(dets)}
        dets = dets.filter(dets.remove_very_small_detections(
            cfg.min_box_size, cfg.min_mask_size))
        counts["sized"] = len(dets)
        if len(dets) == 0:
            return dets

        with stage(timer, "descriptors"):
            Q = len(dets)
            counts["bucket"] = bucket(Q)
            pad = bucket(Q) - Q
            H, W = image.shape[:2]
            masks = self._tensor(dets.masks, torch.bool)
            boxes = self._tensor(dets.boxes)
            if pad:
                masks = torch.cat([masks, masks.new_zeros(pad, H, W)])
                boxes = torch.cat([boxes, boxes.new_tensor(
                    [[0.0, 0.0, 2.0, 2.0]]).expand(pad, 4)])
            crops, crop_masks = self._masked_crops(
                self._tensor(image) / 255.0, masks, boxes)
            query_cls, query_patch = self.descriptor.compute_cls_and_patch(
                normalize_rgb(crops), crop_masks)
            query_cls, query_patch = query_cls.float(), query_patch.float()

        with stage(timer, "scoring"):
            ref = self.ref_data
            sem, obj_idx, _, best_tpl, _ = (
                t[:Q] for t in scoring.semantic_score(
                    query_cls, self._tensor(ref.descriptors),
                    cfg.aggregation_function))
            sel = torch.nonzero(sem > cfg.confidence_thresh)[:, 0]
            counts["confident"] = len(sel)
            if len(sel) == 0:
                return dets.filter(sel.cpu().numpy())
            sel_np = sel.cpu().numpy()
            dets = dets.filter(sel_np)
            sem, obj_idx, best_tpl = sem[sel], obj_idx[sel], best_tpl[sel]
            query_patch = query_patch[:Q][sel]
            obj_np, tpl_np = obj_idx.cpu().numpy(), best_tpl.cpu().numpy()
            ref_patch = self._tensor(ref.appe_descriptors[obj_np, tpl_np])
            Qs = len(dets)
            pad_s = bucket(Qs) - Qs
            appe = scoring.appearance_score(
                torch.nn.functional.pad(query_patch, (0, 0, 0, 0, 0, pad_s)),
                torch.nn.functional.pad(ref_patch, (0, 0, 0, 0, 0, pad_s)),
            )[:Qs]
            if depth is not None and K is not None \
                    and ref.pointcloud is not None:
                geo, vis = self._geometric_score(
                    dets, obj_np, tpl_np, query_patch, ref_patch, depth, K)
            else:
                geo = torch.zeros(Qs, device=self.device)
                vis = torch.zeros(Qs, device=self.device)
            final = scoring.final_score(sem, appe, geo, vis)
            dets.scores = final.cpu().numpy()
            dets.object_ids = obj_np
            dets.extras = {
                "semantic_score": sem.cpu().numpy(),
                "appe_score": appe.cpu().numpy(),
                "geometric_score": geo.cpu().numpy(),
                "visible_ratio": vis.cpu().numpy(),
                "best_template": tpl_np,
            }
            dets = dets.apply_nms_per_object_id(cfg.nms_thresh)
            counts["final"] = len(dets)
            return dets

    def _masked_crops(self, img_f, masks, boxes):
        """Masked square crops of each proposal at descriptor size:
        one image crop per box times the proposal's cropped mask."""
        S = self.cfg.descriptor.image_size
        crops = crop_resize_pad(img_f, boxes, S)
        crop_masks = crop_resize_pad_masks(masks, boxes, S) > 0.5
        return crops * crop_masks[..., None], crop_masks

    def _geometric_score(self, dets, obj_idx, best_template, query_patch,
                         ref_patch, depth, K):
        """Project the model cloud under the best template's rotation and
        the masked depth's mean translation; IoU with the proposal box
        (reference detector.py:209-246, 310-322)."""
        vis = scoring.visible_ratio(query_patch, ref_patch,
                                    self.cfg.visible_thred)
        R = self._tensor(self.ref_data.poses[best_template, :3, :3])
        pc = self._tensor(self.ref_data.pointcloud[obj_idx])
        posed = torch.einsum("qij,qnj->qni", R, pc)
        depth_t = self._tensor(depth)
        H, W = depth_t.shape
        fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                          float(K[1, 2]))
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=self.device),
            torch.arange(W, dtype=torch.float32, device=self.device),
            indexing="ij")
        xmap = (xs - cx) * depth_t / fx
        ymap = (ys - cy) * depth_t / fy
        m = self._tensor(dets.masks, torch.bool) & (depth_t > 0)[None]
        flat = m.reshape(len(dets), -1).float()
        counts = torch.clamp_min(flat.sum(1), 1.0)
        translate = torch.stack([flat @ xmap.reshape(-1),
                                 flat @ ymap.reshape(-1),
                                 flat @ depth_t.reshape(-1)], -1) / counts[:, None]
        uv = project_points(posed + translate[:, None, :], self._tensor(K))
        uv = torch.stack([uv[..., 0].clamp(0, W - 1),
                          uv[..., 1].clamp(0, H - 1)], -1)
        return scoring.geometric_score(uv, self._tensor(dets.boxes)), vis
