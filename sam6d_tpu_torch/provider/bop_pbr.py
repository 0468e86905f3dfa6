"""BOP PBR-image onboarding for the ISM.

Counterpart of `sam6d_tpu/provider/bop_pbr.py` (reference Instance_
Segmentation_Model/provider/bop_pbr.py, BOPTemplatePBR): the template
bank is built from the dataset's own train_pbr renders instead of
rendered CAD views.  A bounded number of scenes and frames is scanned,
instances with visib_fract above a threshold are kept, and each of the
42 level-0 template viewpoints takes the PBR crop whose ground-truth
rotation views the object most similarly.

The frames (BOP's train_pbr frames are JPEGs) and masks are read with
the port's codecs and resized with its PIL-exact BILINEAR, and the
crop's arithmetic is the JAX package's in float32, the uint8 -> /255 ->
masked -> *255 -> uint8 round trip included (its truncation moves some
grey levels down by one), so the crops equal the JAX package's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from sam6d_tpu_torch.provider.bop import list_scenes, read_image
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.resize import pil_resize
from sam6d_tpu_torch.utils.template_poses import (
    get_obj_poses_from_template_level,
)


@dataclass
class PBRInstance:
    """One visible object instance in a train_pbr frame."""

    scene_dir: str
    frame_id: int
    idx_obj: int  # index in the frame's GT list (the mask file's suffix)
    obj_id: int
    R: np.ndarray  # (3, 3) cam_R_m2c
    visib_fract: float


def scan_pbr_instances(dataset_dir: str, split: str = "train_pbr",
                       max_scenes: int = 10, max_frames: int = 1000,
                       min_visib_fract: float = 0.8,
                       ) -> dict[int, list[PBRInstance]]:
    """train_pbr instances by object id, with the reference's bounds on
    scenes and frames (reference load_metaData, bop_pbr.py:81-143)."""
    per_obj: dict[int, list[PBRInstance]] = {}
    for scene_dir in list_scenes(dataset_dir, split)[:max_scenes]:
        gt_path = os.path.join(scene_dir, "scene_gt.json")
        info_path = os.path.join(scene_dir, "scene_gt_info.json")
        if not (os.path.exists(gt_path) and os.path.exists(info_path)):
            continue
        with open(gt_path) as f:
            scene_gt = json.load(f)
        with open(info_path) as f:
            scene_info = json.load(f)
        for n_frame, frame_id in enumerate(sorted(scene_gt, key=int)):
            if n_frame > max_frames:
                break
            for idx_obj, (gt, info) in enumerate(
                    zip(scene_gt[frame_id], scene_info[frame_id])):
                vis = float(info.get("visib_fract", 0.0))
                if vis <= min_visib_fract:
                    continue
                inst = PBRInstance(
                    scene_dir=scene_dir, frame_id=int(frame_id),
                    idx_obj=idx_obj, obj_id=int(gt["obj_id"]),
                    R=np.array(gt["cam_R_m2c"], np.float32).reshape(3, 3),
                    visib_fract=vis)
                per_obj.setdefault(inst.obj_id, []).append(inst)
    return per_obj


def select_views_per_template(instances: list[PBRInstance],
                              level: int = 0) -> list[PBRInstance]:
    """For each template viewpoint, the instance whose viewing direction
    (the third row of R) is nearest (reference NearestTemplateFinder)."""
    t_dirs = get_obj_poses_from_template_level(level)[:, 2, :3]  # (T, 3)
    q_dirs = np.stack([inst.R[2] for inst in instances])  # (N, 3)
    q_dirs = q_dirs / np.maximum(
        np.linalg.norm(q_dirs, axis=1, keepdims=True), 1e-9)
    best = np.argmax(t_dirs @ q_dirs.T, axis=1)  # (T,)
    return [instances[i] for i in best]


def read_rgb(path: str) -> np.ndarray:
    """PIL's `Image.open(path).convert("RGB")` for the files the port's
    codecs read: grey is repeated into three channels, alpha dropped.
    A 16-bit image raises `ValueError`, as the codecs do for what they
    cannot decode."""
    img = read_image(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: cannot convert a {img.dtype} image to RGB")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):  # L, LA
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])  # RGB, RGBA


def _load_instance_crop(inst: PBRInstance, image_size: int,
                        frames: dict | None = None):
    """Masked square crop and mask at image_size (reference __getitem__'s
    masked composite and CropResizePad).  `frames` (path -> decoded
    frame) keeps the frames decoded for earlier instances."""
    rgb_path = os.path.join(inst.scene_dir, "rgb", f"{inst.frame_id:06d}.png")
    if not os.path.exists(rgb_path):
        rgb_path = os.path.join(inst.scene_dir, "rgb",
                                f"{inst.frame_id:06d}.jpg")
    if frames is None:
        frames = {}
    if rgb_path not in frames:
        frames[rgb_path] = read_rgb(rgb_path)
    rgb = frames[rgb_path].astype(np.float32) / 255.0
    mask = read_png(os.path.join(
        inst.scene_dir, "mask_visib",
        f"{inst.frame_id:06d}_{inst.idx_obj:06d}.png")) > 127
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return (np.zeros((image_size, image_size, 3), np.float32),
                np.zeros((image_size, image_size), bool))
    y1, y2, x1, x2 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    # A square window centred on the bbox (CropResizePad's pad to square).
    side = max(y2 - y1, x2 - x1)
    cy, cx = (y1 + y2) // 2, (x1 + x2) // 2
    y1s, x1s = cy - side // 2, cx - side // 2
    H, W = mask.shape
    crop = np.zeros((side, side, 3), np.float32)
    mcrop = np.zeros((side, side), bool)
    sy1, sx1 = max(y1s, 0), max(x1s, 0)
    sy2, sx2 = min(y1s + side, H), min(x1s + side, W)
    crop[sy1 - y1s:sy2 - y1s, sx1 - x1s:sx2 - x1s] = (
        rgb[sy1:sy2, sx1:sx2] * mask[sy1:sy2, sx1:sx2, None])
    mcrop[sy1 - y1s:sy2 - y1s, sx1 - x1s:sx2 - x1s] = mask[sy1:sy2, sx1:sx2]
    crop_r = pil_resize((crop * 255).astype(np.uint8), image_size,
                        image_size, "bilinear").astype(np.float32) / 255.0
    mask_r = pil_resize(mcrop.astype(np.uint8) * 255, image_size,
                        image_size, "bilinear") > 127
    return crop_r, mask_r


def load_pbr_onboarding_templates(
        dataset_dir: str, obj_id: int, split: str = "train_pbr",
        level: int = 0, image_size: int = 224,
        per_obj: dict[int, list[PBRInstance]] | None = None, **scan_kwargs):
    """PBR onboarding of one object: (images (T, S, S, 3) float [0, 1],
    masks (T, S, S) bool, poses (T, 4, 4)), the inputs of
    `ISMDetector.onboard_templates`."""
    if per_obj is None:
        per_obj = scan_pbr_instances(dataset_dir, split, **scan_kwargs)
    if obj_id not in per_obj or not per_obj[obj_id]:
        raise ValueError(
            f"no train_pbr instances for obj {obj_id} in {dataset_dir}")
    selected = select_views_per_template(per_obj[obj_id], level=level)
    frames = {}  # each frame decoded once, however many views it gives
    images, masks = zip(*[_load_instance_crop(inst, image_size, frames)
                          for inst in selected])
    poses = get_obj_poses_from_template_level(level)
    return np.stack(images), np.stack(masks), poses
