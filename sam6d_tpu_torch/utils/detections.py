"""Detections container: filtering, per-object NMS, BOP23 serialization.

Counterpart of `sam6d_tpu/utils/detections.py` (reference Instance_
Segmentation_Model/model/utils.py Detections :80-198 and utils/inout.py
save_json_bop23 :57).  Host-side numpy: proposal counts vary per frame.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from sam6d_tpu_torch.utils.bbox import compute_iou_matrix, xyxy_to_xywh
from sam6d_tpu_torch.utils.rle import mask_to_rle


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float) -> np.ndarray:
    """Greedy NMS on xyxy boxes; returns kept indices sorted by score."""
    order = np.argsort(-scores)
    iou = compute_iou_matrix(boxes, boxes)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


@dataclass
class Detections:
    """Per-frame detections (masks at full image resolution)."""

    masks: np.ndarray  # (N, H, W) bool
    boxes: np.ndarray  # (N, 4) xyxy float
    scores: np.ndarray | None = None  # (N,)
    object_ids: np.ndarray | None = None  # (N,)
    extras: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.masks)

    def filter(self, idx: np.ndarray) -> "Detections":
        return Detections(
            masks=self.masks[idx],
            boxes=self.boxes[idx],
            scores=None if self.scores is None else self.scores[idx],
            object_ids=(None if self.object_ids is None
                        else self.object_ids[idx]),
            extras={k: v[idx] for k, v in self.extras.items()},
        )

    def remove_very_small_detections(self, min_box_size: float = 0.05,
                                     min_mask_size: float = 3e-4
                                     ) -> np.ndarray:
        """Indices of detections above the size thresholds, relative to
        the image's sides and area (reference model/utils.py:96-105)."""
        if len(self) == 0:
            return np.zeros(0, np.int64)
        H, W = self.masks.shape[1:]
        box_w = self.boxes[:, 2] - self.boxes[:, 0]
        box_h = self.boxes[:, 3] - self.boxes[:, 1]
        mask_area = self.masks.reshape(len(self), -1).sum(-1)
        keep = ((box_w > min_box_size * W) & (box_h > min_box_size * H)
                & (mask_area > min_mask_size * H * W))
        return np.flatnonzero(keep)

    def apply_nms_per_object_id(self, nms_thresh: float = 0.25
                                ) -> "Detections":
        assert self.object_ids is not None and self.scores is not None
        keep_all = []
        for obj in np.unique(self.object_ids):
            sel = np.flatnonzero(self.object_ids == obj)
            kept = nms(self.boxes[sel], self.scores[sel], nms_thresh)
            keep_all.append(sel[kept])
        keep_all = (np.concatenate(keep_all) if keep_all
                    else np.zeros(0, np.int64))
        return self.filter(np.sort(keep_all))

    def to_bop23(self, scene_id: int, image_id: int, runtime: float = -1.0,
                 object_id_offset: int = 1) -> list[dict]:
        """BOP23 json rows (reference inout.py:57-85, utils.py:199-216)."""
        rows = []
        xywh = xyxy_to_xywh(self.boxes)
        for i in range(len(self)):
            rows.append({
                "scene_id": int(scene_id),
                "image_id": int(image_id),
                "category_id": (int(self.object_ids[i]) + object_id_offset
                                if self.object_ids is not None else -1),
                "bbox": [float(v) for v in xywh[i]],
                "score": (float(self.scores[i]) if self.scores is not None
                          else 1.0),
                "time": float(runtime),
                "segmentation": mask_to_rle(self.masks[i]),
            })
        return rows


def save_json_bop23(path: str, rows: list[dict]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rows, f)
