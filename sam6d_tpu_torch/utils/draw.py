"""Pose visualisation: project the model cloud under predicted poses.

Counterpart of `sam6d_tpu/utils/draw.py` (reference Pose_Estimation_
Model/utils/draw_utils.py: draw_detections :75, calculate_2d_projections
:5), numpy only, the image written with the port's PNG codec.
"""

from __future__ import annotations

import numpy as np

from sam6d_tpu_torch.utils.png import write_png


def calculate_2d_projections(pts_cam: np.ndarray, K: np.ndarray) -> np.ndarray:
    """(N, 3) camera-frame points -> (N, 2) int pixel coords."""
    uv = pts_cam @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)
    return uv.astype(np.int32)


def draw_detections(
    image: np.ndarray,
    pred_rots: np.ndarray,
    pred_trans: np.ndarray,
    model_points: np.ndarray,
    K: np.ndarray,
    color: tuple[int, int, int] = (255, 0, 0),
) -> np.ndarray:
    """Overlay projected model points for each predicted pose.

    Args:
      image: (H, W, 3) uint8.
      pred_rots: (N, 3, 3); pred_trans: (N, 3) meters.
      model_points: (M, 3) meters.
      K: (3, 3).
    """
    out = image.copy()
    H, W = out.shape[:2]
    for R, t in zip(pred_rots, pred_trans):
        cam_pts = model_points @ R.T + t
        uv = calculate_2d_projections(cam_pts, K)
        ok = (
            (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        )
        out[uv[ok, 1], uv[ok, 0]] = color
    return out


def save_image(path: str, image: np.ndarray):
    write_png(path, image)
