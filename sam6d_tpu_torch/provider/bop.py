"""BOP dataset access: scene listing, the object library, PEM test instances.

Counterpart of `sam6d_tpu/provider/bop.py` (reference Instance_
Segmentation_Model/provider/base_bop.py, Pose_Estimation_Model/provider/
bop_test_dataset.py and utils/bop_object_utils.py), with the port's PNG
and JPEG codecs and PIL-exact resize in place of PIL: the same files and
seed give the same arrays.  The reference's quirks are kept: a missing
`diameter` defaults to 2000 x the mesh radius / 2 (in mm, so the
diameter in metres equals the radius in metres); each frame draws its
observed points from a new `RandomState(seed)`; detections scoring at
most `seg_filter_score` (0.25) are dropped; an instance needs 8 points
within 1.2 x the model's radius of its centre.

Standard BOP layout: <root>/<dataset>/test/<scene>/{rgb,depth}/,
scene_gt.json, scene_camera.json; models/ with obj_<id>.ply and
models_info.json.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field

import numpy as np

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.pipeline.pem_data import normalize_rgb_np
from sam6d_tpu_torch.utils.bbox import get_resize_rgb_choose, square_bbox
from sam6d_tpu_torch.utils.jpeg import read_jpeg
from sam6d_tpu_torch.utils.mesh import load_mesh
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.resize import pil_resize
from sam6d_tpu_torch.utils.rle import rle_to_mask

LMO_OBJECT_IDS = [1, 5, 6, 8, 9, 10, 11, 12]


@dataclass
class BOPObject:
    """One BOP object: model samples, metadata and its template bank's
    directory."""

    obj_id: int
    model_points: np.ndarray  # (M, 3) metres
    diameter: float
    symmetry: bool
    template_dir: str | None = None


def load_objects(models_dir: str, n_sample: int = 1024,
                 template_root: str | None = None,
                 seed: int = 1) -> dict[int, BOPObject]:
    """Every obj_XXXXXX.ply with its models_info.json metadata."""
    info_path = os.path.join(models_dir, "models_info.json")
    info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
    objects = {}
    for path in sorted(glob.glob(os.path.join(models_dir, "obj_*.ply"))):
        obj_id = int(os.path.basename(path)[4:10])
        mesh = load_mesh(path)
        meta = info.get(str(obj_id), {})
        sym = bool(meta.get("symmetries_continuous")
                   or meta.get("symmetries_discrete"))
        objects[obj_id] = BOPObject(
            obj_id=obj_id,
            model_points=mesh.sample(n_sample, seed=seed) / 1000.0,
            diameter=meta.get("diameter", 2000.0 * mesh.radius / 2) / 1000.0,
            symmetry=sym,
            template_dir=(os.path.join(template_root, f"obj_{obj_id:06d}")
                          if template_root else None),
        )
    return objects


def list_scenes(dataset_dir: str, split: str = "test") -> list[str]:
    return sorted(d for d in glob.glob(os.path.join(dataset_dir, split, "*"))
                  if os.path.isdir(d))


def list_frames(scene_dir: str) -> list[int]:
    rgbs = (glob.glob(os.path.join(scene_dir, "rgb", "*.png"))
            + glob.glob(os.path.join(scene_dir, "rgb", "*.jpg")))
    return sorted(int(os.path.basename(p).split(".")[0]) for p in rgbs)


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG frame as PIL's `np.asarray(Image.open(path))`."""
    return read_jpeg(path) if path.endswith(".jpg") else read_png(path)


def load_frame(scene_dir: str, im_id: int):
    """(rgb uint8, depth in metres float32, K) of one frame."""
    with open(os.path.join(scene_dir, "scene_camera.json")) as f:
        entry = json.load(f)[str(im_id)]
    K = np.array(entry["cam_K"], np.float32).reshape(3, 3)
    depth_scale = entry.get("depth_scale", 1.0)
    rgb_path = os.path.join(scene_dir, "rgb", f"{im_id:06d}.png")
    if not os.path.exists(rgb_path):
        rgb_path = os.path.join(scene_dir, "rgb", f"{im_id:06d}.jpg")
    rgb = read_image(rgb_path)
    if rgb.ndim == 2:
        rgb = np.stack([rgb] * 3, axis=-1)
    depth = (read_png(os.path.join(scene_dir, "depth", f"{im_id:06d}.png"))
             .astype(np.float32) * depth_scale / 1000.0)
    return rgb[..., :3], depth, K


@dataclass
class BOPTestset:
    """Groups ISM detections by frame and builds the PEM's instance
    batches (reference bop_test_dataset.py:24-208)."""

    cfg: PEMConfig
    dataset_dir: str
    objects: dict[int, BOPObject]
    detections: list[dict] = field(default_factory=list)
    seg_filter_score: float = 0.25
    seed: int = 1

    def load_detections(self, path: str):
        with open(path) as f:
            dets = json.load(f)
        self.detections = [d for d in dets
                           if d["score"] > self.seg_filter_score]
        self.by_frame: dict[tuple[int, int], list[dict]] = {}
        for d in self.detections:
            self.by_frame.setdefault((d["scene_id"], d["image_id"]),
                                     []).append(d)
        return self

    def frames(self):
        return sorted(self.by_frame.keys())

    def get_frame_instances(self, scene_id: int, image_id: int):
        """The PEM inputs of every detection in one frame: (batch or
        None, (rgb, depth, K))."""
        rng = np.random.RandomState(self.seed)
        scene_dir = os.path.join(self.dataset_dir, "test", f"{scene_id:06d}")
        rgb, depth, K = load_frame(scene_dir, image_id)
        dets = self.by_frame[(scene_id, image_id)]

        batch = {"pts": [], "rgb": [], "rgb_choose": [], "model_pts": [],
                 "score": [], "obj_id": [], "det": []}
        S = self.cfg.feature_extraction.img_size
        n_obs = self.cfg.n_sample_observed_point
        H, W = depth.shape
        ys, xs = np.mgrid[:H, :W].astype(np.float32)
        cloud_full = np.stack([(xs - K[0, 2]) * depth / K[0, 0],
                               (ys - K[1, 2]) * depth / K[1, 1],
                               depth], axis=-1)
        for det in dets:
            obj = self.objects.get(det["category_id"])
            if obj is None:
                continue
            mask = rle_to_mask(det["segmentation"]) & (depth > 0)
            if mask.sum() <= 32:
                continue
            y1, y2, x1, x2 = square_bbox(mask)
            mask_c = mask[y1:y2, x1:x2]
            choose = np.flatnonzero(mask_c.flatten())
            cloud = cloud_full[y1:y2, x1:x2].reshape(-1, 3)[choose]
            radius = np.max(np.linalg.norm(obj.model_points, axis=1))
            center = cloud.mean(0)
            flag = np.linalg.norm(cloud - center, axis=1) < radius * 1.2
            if flag.sum() < self.cfg_min_points():
                continue
            choose, cloud = choose[flag], cloud[flag]
            idx = rng.choice(np.arange(len(choose)), n_obs,
                             replace=len(choose) <= n_obs)
            choose, cloud = choose[idx], cloud[idx]

            crop = rgb[y1:y2, x1:x2, ::-1]
            crop = crop * (mask_c[..., None] > 0).astype(np.uint8)
            crop = pil_resize(crop, S, S, "bilinear")
            batch["pts"].append(cloud.astype(np.float32))
            batch["rgb"].append(normalize_rgb_np(crop))
            batch["rgb_choose"].append(get_resize_rgb_choose(
                choose, (y1, y2, x1, x2), S).astype(np.int32))
            batch["model_pts"].append(obj.model_points.astype(np.float32))
            batch["score"].append(det["score"])
            batch["obj_id"].append(det["category_id"])
            batch["det"].append(det)
        if not batch["pts"]:
            return None, (rgb, depth, K)
        out = {k: np.stack(v) for k, v in batch.items()
               if k not in ("det", "obj_id", "score")}
        out["score"] = np.asarray(batch["score"], np.float32)
        out["obj_id"] = np.asarray(batch["obj_id"])
        out["det"] = batch["det"]
        out["K"] = np.tile(K[None], (len(batch["pts"]), 1, 1))
        return out, (rgb, depth, K)

    def cfg_min_points(self) -> int:
        return 8  # reference test_dataset minimum_n_point
