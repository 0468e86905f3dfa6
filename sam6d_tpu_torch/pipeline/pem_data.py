"""PEM inference data preparation (host side, numpy).

Counterpart of `sam6d_tpu/pipeline/pem_data.py` (reference Pose_
Estimation_Model/run_inference_custom_pytorch.py: _get_template
:182-223, get_templates :226-253, get_test_data :256-367), with the
port's PNG codec and PIL-exact resize in place of PIL.  The same files
and seed give the same arrays: the `np.random.RandomState` draws come in
the same order (view by view, then instance by instance from one
generator).

Contract with the template renderer (render stage): a template directory
holds rgb_<i>.png, mask_<i>.png and xyz_<i>.npy (mm, float16 allowed)
for i in [0, n_template_view).
"""

from __future__ import annotations

import json
import os

import numpy as np

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.utils.bbox import get_resize_rgb_choose, square_bbox
from sam6d_tpu_torch.utils.mesh import load_mesh
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.resize import pil_resize
from sam6d_tpu_torch.utils.rle import rle_to_mask

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_rgb_np(rgb_uint8: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> ImageNet-normalized float (H, W, 3)."""
    x = rgb_uint8.astype(np.float32) / 255.0
    return (x - _IMAGENET_MEAN) / _IMAGENET_STD


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    return pil_resize(img, size, size, "bilinear")


def read_depth(depth_path: str, cam_info: dict) -> np.ndarray:
    """The depth PNG in metres, scaled by the camera's `depth_scale`."""
    return (read_png(depth_path).astype(np.float32)
            * cam_info.get("depth_scale", 1.0) / 1000.0)


def load_template(path: str, cfg: PEMConfig, index: int,
                  rng: np.random.RandomState, rgb_mask_flag: bool = True):
    """One rendered view -> (rgb (S, S, 3) normalised, rgb_choose (Np,),
    xyz (Np, 3) metres): square-crop the mask's bbox, masked resize to
    img_size, sample n_sample_template_point in-mask pixels."""
    S = cfg.feature_extraction.img_size
    npoint = cfg.n_sample_template_point
    rgb = read_png(os.path.join(path, f"rgb_{index}.png"))[..., :3]
    mask = read_png(os.path.join(path, f"mask_{index}.png"))
    if mask.ndim == 3:
        mask = mask[..., 0]
    mask = mask == 255
    xyz = np.load(os.path.join(path, f"xyz_{index}.npy")).astype(
        np.float32) / 1000.0

    y1, y2, x1, x2 = square_bbox(mask)
    mask_c = mask[y1:y2, x1:x2]
    # BGR, as the reference feeds the ViT for templates and queries
    # (run_inference_custom_pytorch.py:206,346; the released PEM weights
    # were trained that way).
    rgb_c = rgb[y1:y2, x1:x2, ::-1]
    if rgb_mask_flag:
        rgb_c = rgb_c * (mask_c[..., None] > 0).astype(np.uint8)
    rgb_norm = normalize_rgb_np(_resize(rgb_c, S))

    choose = np.flatnonzero(mask_c.astype(np.float32).flatten())
    replace = len(choose) <= npoint
    choose_idx = rng.choice(np.arange(len(choose)), npoint, replace=replace)
    choose = choose[choose_idx]
    xyz_c = xyz[y1:y2, x1:x2].reshape(-1, 3)[choose]
    rgb_choose = get_resize_rgb_choose(choose, (y1, y2, x1, x2), S)
    return rgb_norm, rgb_choose, xyz_c


def load_all_templates(path: str, cfg: PEMConfig, seed: int = 1):
    """All template views stacked: (T, S, S, 3), (T, Np), (T, Np, 3)."""
    rng = np.random.RandomState(seed)
    rgbs, chooses, xyzs = [], [], []
    for v in range(cfg.n_template_view):
        rgb, choose, xyz = load_template(path, cfg, v, rng)
        rgbs.append(rgb)
        chooses.append(choose)
        xyzs.append(xyz)
    return (np.stack(rgbs).astype(np.float32),
            np.stack(chooses).astype(np.int32),
            np.stack(xyzs).astype(np.float32))


def prepare_test_data(rgb_path: str, depth_path: str, cam_path: str,
                      cad_path: str, seg_path: str, cfg: PEMConfig,
                      det_score_thresh: float = 0.2, seed: int = 1,
                      max_instances: int | None = None):
    """ISM detections -> per-instance PEM inputs (reference get_test_data
    :256-367).

    Returns (input_data dict of numpy arrays or None, img, whole_pts,
    model_points, the kept detections)."""
    rng = np.random.RandomState(seed)
    with open(seg_path) as f:
        dets_all = json.load(f)
    dets = [d for d in dets_all if d["score"] > det_score_thresh]
    if max_instances:
        dets = sorted(dets, key=lambda d: -d["score"])[:max_instances]

    with open(cam_path) as f:
        cam_info = json.load(f)
    K = np.array(cam_info["cam_K"], np.float32).reshape(3, 3)
    img = read_png(rgb_path)[..., :3]
    depth = read_depth(depth_path, cam_info)
    H, W = depth.shape

    ys, xs = np.mgrid[:H, :W].astype(np.float32)
    z = depth
    whole_pts = np.stack(
        [(xs - K[0, 2]) * z / K[0, 0], (ys - K[1, 2]) * z / K[1, 1], z],
        axis=-1)

    mesh = load_mesh(cad_path)
    model_points = mesh.sample(cfg.n_sample_model_point, seed=seed) / 1000.0
    radius = np.max(np.linalg.norm(model_points, axis=1))

    S = cfg.feature_extraction.img_size
    n_obs = cfg.n_sample_observed_point
    all_pts, all_rgb, all_choose, all_score, kept = [], [], [], [], []
    for inst in dets:
        mask = rle_to_mask(inst["segmentation"])
        mask = np.logical_and(mask > 0, depth > 0)
        if mask.sum() <= 32:
            continue
        y1, y2, x1, x2 = square_bbox(mask)
        mask_c = mask[y1:y2, x1:x2]
        choose = np.flatnonzero(mask_c.astype(np.float32).flatten())

        cloud = whole_pts[y1:y2, x1:x2].reshape(-1, 3)[choose]
        center = cloud.mean(axis=0)
        flag = np.linalg.norm(cloud - center, axis=1) < radius * 1.2
        if flag.sum() < 4:
            continue
        choose, cloud = choose[flag], cloud[flag]

        replace = len(choose) <= n_obs
        idx = rng.choice(np.arange(len(choose)), n_obs, replace=replace)
        choose, cloud = choose[idx], cloud[idx]

        rgb_c = img[y1:y2, x1:x2, ::-1]  # BGR, as the reference trained
        rgb_c = rgb_c * (mask_c[..., None] > 0).astype(np.uint8)
        all_rgb.append(normalize_rgb_np(_resize(rgb_c, S)))
        all_pts.append(cloud.astype(np.float32))
        all_choose.append(get_resize_rgb_choose(choose, (y1, y2, x1, x2), S))
        all_score.append(inst["score"])
        kept.append(inst)

    if not all_pts:
        return None, img, whole_pts.reshape(-1, 3), model_points, []

    n = len(all_pts)
    input_data = {
        "pts": np.stack(all_pts),
        "rgb": np.stack(all_rgb).astype(np.float32),
        "rgb_choose": np.stack(all_choose).astype(np.int32),
        "score": np.asarray(all_score, np.float32),
        "model_pts": np.tile(model_points[None], (n, 1, 1)),
        "K": np.tile(K[None], (n, 1, 1)),
    }
    return input_data, img, whole_pts.reshape(-1, 3), model_points, kept
