"""PEM training data: MegaPose web shards, rendered samples, synthetic
samples, collation and a batch iterator.

A numpy copy of `sam6d_tpu/provider/training_dataset.py` (the port
imports nothing of the JAX package) with the port's file codecs in place
of PIL: JPEG through `utils/jpeg.py`, PNG through `utils/png.py`, the
BILINEAR resize through `utils/resize.py` and the colour augmentation
through `provider/augment.py`, each equal to PIL's arrays, so the same
files and seeds give the same samples.

* `MegaPoseDataset` reads the reference's web-shard layout (reference
  Pose_Estimation_Model/provider/training_dataset.py:32-312).
* `RenderedPoseDataset` renders learnable samples of procedural
  NOCS-coloured meshes with the port's rasterizer
  (`pipeline/renderer.rasterize`): no external data.
* `SyntheticPoseDataset` draws random objects and random images.

Every sample is in the raw-template layout `train.state.train_step`
consumes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sam6d_tpu_torch.config import TrainConfig
from sam6d_tpu_torch.pipeline.pem_data import _resize, normalize_rgb_np
from sam6d_tpu_torch.provider.augment import color_augment
from sam6d_tpu_torch.utils.bbox import get_resize_rgb_choose, square_bbox
from sam6d_tpu_torch.utils.jpeg import read_jpeg
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.rle import rle_to_mask


def random_rotation(rng: np.random.RandomState) -> np.ndarray:
    """Rotation from three uniform Euler angles (reference
    data_utils.py:162-177)."""
    angles = rng.rand(3) * 2 * np.pi
    cx, sx = np.cos(angles[0]), np.sin(angles[0])
    cy, sy = np.cos(angles[1]), np.sin(angles[1])
    cz, sz = np.cos(angles[2]), np.sin(angles[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz).astype(np.float32)


def dilate_mask_cross(mask: np.ndarray, iterations: int = 4) -> np.ndarray:
    """Binary dilation by the 3x3 cross, `iterations` times: each ORs the
    mask with its four one-pixel shifts (cv2.dilate with MORPH_CROSS;
    the reference dilates 4 times at probability 0.5, training_dataset.py
    :176-179, so the network tolerates a segmentor's overshooting masks)."""
    m = mask > 0
    for _ in range(iterations):
        p = np.pad(m, 1)
        m = (p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1]
             | p[1:-1, :-2] | p[1:-1, 2:])
    return m


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class MegaPoseDataset:
    """MegaPose web-shard training data (the reference's layout).

    Reads data_dir/{MegaPose-GSO,MegaPose-ShapeNetCore}/train_pbr_web:
    key_to_shard.json ({key: shard}), gso_models.json /
    shapenet_models.json (per obj_id the template directory's names),
    shard-<shard:06d>/<key>.{rgb.jpg, depth.png, camera.json, gt.json,
    gt_info.json, mask_visib.json} (gt and gt_info lists, one entry an
    instance; mask_visib {instance: column-major RLE}), and the template
    directories data_dir/<dataset>/templates/<id>/{rgb,mask}_<i>.png,
    xyz_<i>.npy.

    template_xyz_scale takes the stored xyz to metres: MegaPose's banks
    store 10x metres (reference training_dataset.py:294 multiplies by
    0.1); banks written by `pipeline/renderer.py` store millimetres (pass
    1e-3).  All draws come from one generator seeded by `seed`, in the
    JAX package's order.
    """

    def __init__(self, cfg: TrainConfig, data_dir: str,
                 num_img_per_epoch: int = -1, seed: int = 1,
                 template_xyz_scale: float = 0.1, dilate_mask: bool = True):
        self.cfg = cfg
        self.data_dir = data_dir
        self.rng = np.random.RandomState(seed)
        self.num_img_per_epoch = num_img_per_epoch
        self.template_xyz_scale = template_xyz_scale
        self.dilate_mask = dilate_mask
        self.data_paths = [os.path.join("MegaPose-GSO", "train_pbr_web"),
                           os.path.join("MegaPose-ShapeNetCore",
                                        "train_pbr_web")]
        self.templates_paths = [
            os.path.join(data_dir, "MegaPose-GSO", "templates"),
            os.path.join(data_dir, "MegaPose-ShapeNetCore", "templates")]
        self.dataset_paths = []
        for f in self.data_paths:
            k2s = os.path.join(data_dir, f, "key_to_shard.json")
            if not os.path.exists(k2s):
                continue
            for k, shard in _json(k2s).items():
                self.dataset_paths.append(
                    os.path.join(f, f"shard-{shard:06d}", k))
        self.model_info = []
        for f, name in zip(self.data_paths,
                           ("gso_models.json", "shapenet_models.json")):
            p = os.path.join(data_dir, f, name)
            self.model_info.append(_json(p) if os.path.exists(p) else None)

    def __len__(self):
        if self.num_img_per_epoch > 0:
            return self.num_img_per_epoch
        return len(self.dataset_paths)

    def reset(self):
        """This epoch's image subset (reference :110-119): len(self)
        indices into the shard list, drawn with replacement when the
        corpus is no larger than the epoch."""
        num_img = len(self.dataset_paths)
        n = self.num_img_per_epoch if self.num_img_per_epoch > 0 else num_img
        self.img_idx = self.rng.choice(num_img, n, replace=num_img <= n)

    def __getitem__(self, index):
        img_idx = getattr(self, "img_idx", None)
        for _ in range(64):  # per-sample retry (reference :120-130)
            raw = (img_idx[index % len(img_idx)] if img_idx is not None
                   else index % len(self.dataset_paths))
            data = self.read_data(raw)
            if data is not None:
                return data
            index = self.rng.randint(len(self.dataset_paths))
        raise RuntimeError("too many invalid samples")

    def read_data(self, index):
        """One sample of shard entry `index`, or None when it has no
        usable instance (missing files, too little visible, too few
        points)."""
        cfg = self.cfg
        rng = self.rng
        path_head = os.path.join(self.data_dir, self.dataset_paths[index])
        dataset_type = 0 if "GSO" in path_head else 1
        for suffix in (".camera.json", ".depth.png", ".gt.json",
                       ".gt_info.json", ".mask_visib.json", ".rgb.jpg"):
            if not os.path.exists(path_head + suffix):
                return None

        gt_info = _json(path_head + ".gt_info.json")
        valid = [k for k, item in enumerate(gt_info)
                 if item.get("px_count_valid", 0) >= 512
                 and item.get("visib_fract", 0) >= 0.1]
        if not valid:
            return None
        vi = valid[rng.randint(len(valid))]
        gt = _json(path_head + ".gt.json")[vi]
        obj_id = gt["obj_id"]
        target_R = np.array(gt["cam_R_m2c"], np.float32).reshape(3, 3)
        target_t = np.array(gt["cam_t_m2c"], np.float32).reshape(3) / 1000.0
        camera = _json(path_head + ".camera.json")
        K = np.array(camera["cam_K"], np.float32).reshape(3, 3)

        tem = [self._get_template(dataset_type, obj_id, i) for i in (0, 1)]
        if tem[0][0] is None:
            return None

        masks_rle = {int(k): v for k, v in
                     _json(path_head + ".mask_visib.json").items()}
        mask = rle_to_mask(masks_rle[vi])
        if mask.sum() == 0:
            return None
        if self.dilate_mask and rng.rand() < 0.5:
            mask = dilate_mask_cross(mask, iterations=4)

        y1, y2, x1, x2 = square_bbox(mask)
        mask_c = mask[y1:y2, x1:x2]
        choose = np.flatnonzero(mask_c.astype(np.float32).flatten())

        depth = (read_png(path_head + ".depth.png").astype(np.float32)
                 * camera.get("depth_scale", 1.0) / 1000.0)
        dh = depth[y1:y2, x1:x2]
        ys, xs = np.mgrid[y1:y2, x1:x2].astype(np.float32)
        z = dh.reshape(-1)[choose]
        xsf = xs.reshape(-1)[choose]
        ysf = ys.reshape(-1)[choose]
        pts = np.stack([(xsf - K[0, 2]) * z / K[0, 0],
                        (ysf - K[1, 2]) * z / K[1, 1], z], axis=-1)

        target_pts = (pts - target_t) @ target_R
        tem_all = np.concatenate([tem[0][2], tem[1][2]], axis=0)
        radius = np.max(np.linalg.norm(tem_all, axis=1))
        flag = np.linalg.norm(target_pts, axis=1) < radius * 1.2
        pts, choose = pts[flag], choose[flag]
        if len(choose) < 32:
            return None

        n_obs = cfg.n_sample_observed_point
        idx = rng.choice(np.arange(len(choose)), n_obs,
                         replace=len(choose) <= n_obs)
        pts, choose = pts[idx], choose[idx]

        # Only the rows down to the crop's bottom need decoding.
        rgb = read_jpeg(path_head + ".rgb.jpg", rows=y2)[..., :3]
        rgb = rgb[y1:y2, x1:x2, ::-1]
        if rng.rand() < 0.8:
            rgb = color_augment(rng, rgb)
        rgb = rgb * (mask_c[..., None] > 0).astype(np.uint8)
        rgb = _resize(rgb, cfg.img_size)
        rgb_choose = get_resize_rgb_choose(choose, (y1, y2, x1, x2),
                                           cfg.img_size)

        # Rotation + translation augmentation (reference :220-229).
        rand_R = random_rotation(rng)
        tem1_pts = tem[0][2] @ rand_R
        tem2_pts = tem[1][2] @ rand_R
        target_R = target_R @ rand_R
        add_t = rng.uniform(-0.01, 0.01, (1, 3))
        target_t = target_t + add_t[0]
        pts = pts + add_t + 0.001 * rng.randn(len(pts), 3)

        return {
            "pts": pts.astype(np.float32),
            "rgb": normalize_rgb_np(rgb),
            "rgb_choose": rgb_choose.astype(np.int32),
            "gt_t": target_t.astype(np.float32),
            "gt_r": target_R.astype(np.float32),
            "tem_rgb": np.stack([tem[0][0], tem[1][0]]).astype(np.float32),
            "tem_choose": np.stack([tem[0][1], tem[1][1]]).astype(np.int32),
            "tem_pts": np.stack([tem1_pts, tem2_pts]).astype(np.float32),
            "K": K,
        }

    def _get_template(self, dataset_type, obj_id, tem_index):
        """(normalised rgb, rgb_choose, xyz in metres) of one template
        view, or (None, None, None) when the object has none."""
        cfg = self.cfg
        rng = self.rng
        info = self.model_info[dataset_type]
        if info is None:
            return None, None, None
        entry = info[obj_id]
        if dataset_type == 0:
            base = os.path.join(self.templates_paths[0], entry["gso_id"])
        else:
            base = os.path.join(self.templates_paths[1],
                                entry["shapenet_synset_id"],
                                entry["shapenet_source_id"])
        rgb_path = os.path.join(base, f"rgb_{tem_index}.png")
        if not os.path.exists(rgb_path):
            return None, None, None

        mask = read_png(os.path.join(base, f"mask_{tem_index}.png"))
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask == 255
        y1, y2, x1, x2 = square_bbox(mask)
        mask_c = mask[y1:y2, x1:x2]

        rgb = read_png(rgb_path)[..., :3][y1:y2, x1:x2, ::-1]
        if rng.rand() < 0.8:
            rgb = color_augment(rng, rgb)
        rgb = rgb * (mask_c[..., None] > 0).astype(np.uint8)
        rgb = _resize(rgb, cfg.img_size)

        choose = np.flatnonzero(mask_c.astype(np.float32).flatten())
        npt = cfg.n_sample_template_point
        idx = rng.choice(np.arange(len(choose)), npt,
                         replace=len(choose) <= npt)
        choose = choose[idx]
        xyz = np.load(os.path.join(base, f"xyz_{tem_index}.npy")).astype(
            np.float32)[y1:y2, x1:x2].reshape(-1, 3)[choose]
        xyz = xyz * self.template_xyz_scale
        rgb_choose = get_resize_rgb_choose(choose, (y1, y2, x1, x2),
                                           cfg.img_size)
        return normalize_rgb_np(rgb), rgb_choose, xyz


def make_procedural_mesh(rng: np.random.RandomState, radius_mm: float = 50.0,
                         subdivisions: int = 2):
    """A random asymmetric coloured mesh: a subdivided icosphere deformed
    by six smooth radial bumps and scaled anisotropically, its vertex
    colours the object's normalised coordinates (NOCS) through a mild
    random channel mix, so appearance follows position as on a textured
    object and both the geometric and the appearance paths of the
    correspondence loss have signal."""
    from sam6d_tpu_torch.utils.mesh import TriMesh
    from sam6d_tpu_torch.utils.template_poses import icosphere

    verts, faces = icosphere(subdivisions)  # 162 vertices at 2
    dirs = rng.randn(6, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    amps = rng.uniform(-0.3, 0.55, 6)
    bump = np.maximum(verts @ dirs.T, 0.0) ** 2  # (V, 6)
    r = 1.0 + bump @ amps
    verts = verts * np.maximum(r, 0.3)[:, None]
    verts = verts * rng.uniform(0.6, 1.4, 3)[None, :]
    verts = verts * (radius_mm / np.linalg.norm(verts, axis=1).max())
    verts = verts.astype(np.float32)

    rad = np.linalg.norm(verts, axis=1).max()
    nocs = verts / (2.0 * rad) + 0.5  # in [0, 1]
    mix = np.eye(3) * rng.uniform(0.75, 1.0) + rng.uniform(-0.12, 0.12, (3, 3))
    colors = np.clip(nocs @ mix.T + rng.uniform(-0.08, 0.08, 3), 0.05, 1.0)
    return TriMesh(verts, faces.astype(np.int64),
                   (colors * 255).astype(np.uint8))


def _render_view(mesh, R_w2c, t_w2c_mm, K, hw):
    """One view of `mesh`: (rgb uint8 (H, W, 3), mask bool, xyz in mm in
    the object's frame (H, W, 3), depth in mm), headlight-shaded vertex
    colours."""
    from sam6d_tpu_torch.pipeline.renderer import (
        compute_vertex_normals,
        rasterize,
    )

    verts_cam = mesh.vertices @ R_w2c.T + t_w2c_mm
    normals_cam = compute_vertex_normals(mesh) @ R_w2c.T
    shade = np.clip(-normals_cam[:, 2], 0.2, 1.0)[:, None]
    colors = mesh.vertex_colors.astype(np.float32) / 255.0
    attrs = np.concatenate([colors * shade, mesh.vertices], axis=1)
    attr_img, mask, depth = rasterize(verts_cam, mesh.faces, K, hw, attrs)
    rgb = (np.clip(attr_img[..., :3], 0, 1) * 255).astype(np.uint8)
    return rgb, mask, attr_img[..., 3:6], depth


class RenderedPoseDataset:
    """Rendered pose-training samples with learnable appearance.

    The MegaPose sample path (masked depth back-projection, the radius
    outlier filter, fixed-count resampling, template crops with
    object-frame xyz, rotation and translation augmentation) on frames
    that the port's rasterizer renders of procedural NOCS-coloured meshes:
    training needs no external data.  Each object's template views are
    rendered once, here; a sample draws 2 of them, `template_arrays` gives
    the whole bank.  Sample i depends only on (seed, i), so worker
    processes can draw disjoint samples.

    uint8_rgb ships rgb / tem_rgb as raw uint8 and leaves the ImageNet
    normalisation to the card (`train.state._to_device`): the float32
    image planes are most of a batch's bytes.
    """

    def __init__(self, cfg: TrainConfig, n_objects: int = 32,
                 n_template_views: int = 8, n_samples: int = 100000,
                 seed: int = 0, frame_size: int = 160,
                 color_aug_prob: float = 0.0, uint8_rgb: bool = False):
        from sam6d_tpu_torch.utils.template_poses import get_camera_poses

        self.cfg = cfg
        self.uint8_rgb = uint8_rgb
        self.n = n_samples
        self.seed = seed
        self.frame_size = frame_size
        self.color_aug_prob = color_aug_prob
        rng = np.random.RandomState(seed ^ 0x5EED)
        self.meshes = [make_procedural_mesh(rng) for _ in range(n_objects)]

        # Template views from evenly spread level-0 icosphere poses.
        S = 96
        f = float(S)
        K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
        self.templates = []  # per object: one dict a view
        for mesh in self.meshes:
            radius = float(np.linalg.norm(mesh.vertices, axis=1).max())
            poses = get_camera_poses(0, radius=2.8 * radius)
            sel = np.linspace(0, len(poses) - 1, n_template_views).astype(int)
            views = []
            for pi in sel:
                R_c2w, t_c2w = poses[pi][:3, :3], poses[pi][:3, 3]
                R = R_c2w.T
                t = -R @ t_c2w
                rgb, mask, xyz_mm, _ = _render_view(mesh, R, t, K, (S, S))
                views.append(self._crop_template(rgb, mask, xyz_mm))
            self.templates.append(views)

    def _crop_template(self, rgb, mask, xyz_mm):
        """The MegaPose template crop: square bbox, masked BGR resize,
        the in-mask pixels (sampled anew at each access)."""
        cfg = self.cfg
        y1, y2, x1, x2 = square_bbox(mask)
        mask_c = mask[y1:y2, x1:x2]
        rgb_c = rgb[y1:y2, x1:x2, ::-1] * (mask_c[..., None] > 0).astype(
            np.uint8)
        xyz_flat = xyz_mm[y1:y2, x1:x2].reshape(-1, 3) / 1000.0
        return {
            "rgb_u8": _resize(rgb_c, cfg.img_size),
            "choose_all": np.flatnonzero(mask_c.astype(np.float32).flatten()),
            "xyz_flat": xyz_flat.astype(np.float32),
            "bbox": (y1, y2, x1, x2),
        }

    def _sample_template(self, obj_idx, view_idx, rng):
        cfg = self.cfg
        v = self.templates[obj_idx][view_idx]
        npt = cfg.n_sample_template_point
        ca = v["choose_all"]
        idx = rng.choice(np.arange(len(ca)), npt, replace=len(ca) <= npt)
        choose = ca[idx]
        xyz = v["xyz_flat"][choose]
        rgb_choose = get_resize_rgb_choose(choose, v["bbox"], cfg.img_size)
        rgb = v["rgb_u8"] if self.uint8_rgb else normalize_rgb_np(v["rgb_u8"])
        return rgb, rgb_choose.astype(np.int32), xyz

    def template_arrays(self, obj_idx, seed: int = 0):
        """The object's whole template bank for inference, normalised:
        (T, S, S, 3) float32, (T, Np) int32, (T, Np, 3) float32."""
        rng = np.random.RandomState(seed)
        rgbs, chooses, xyzs = [], [], []
        for vi in range(len(self.templates[obj_idx])):
            r, c, x = self._sample_template(obj_idx, vi, rng)
            if r.dtype == np.uint8:
                r = normalize_rgb_np(r)
            rgbs.append(r)
            chooses.append(c)
            xyzs.append(x)
        return (np.stack(rgbs).astype(np.float32),
                np.stack(chooses).astype(np.int32),
                np.stack(xyzs).astype(np.float32))

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        return self.sample(index, aug=True)

    def sample(self, index, aug: bool = True):
        """Sample `index`; aug=False keeps the object's own frame (no
        rotation or translation augmentation), so `template_arrays` is
        its matching inference bank."""
        cfg = self.cfg
        rng = np.random.RandomState(self.seed + index)
        obj_idx = rng.randint(len(self.meshes))
        mesh = self.meshes[obj_idx]
        radius_mm = float(np.linalg.norm(mesh.vertices, axis=1).max())

        # Scene view: a random pose, the object 0.4-0.6 m from the camera.
        S = self.frame_size
        f = 4.0 * S
        K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
        target_R = random_rotation(rng)
        z_mm = rng.uniform(400.0, 600.0)
        lat = z_mm / f  # mm per pixel at depth z
        t_mm = np.array([rng.uniform(-20, 20) * lat,
                         rng.uniform(-20, 20) * lat, z_mm], np.float32)
        rgb, mask, _, depth_mm = _render_view(mesh, target_R, t_mm, K, (S, S))
        if mask.sum() < 64:
            return self.sample(index + 7919, aug)  # degenerate: redraw
        target_t = t_mm / 1000.0

        y1, y2, x1, x2 = square_bbox(mask)
        mask_c = mask[y1:y2, x1:x2]
        choose = np.flatnonzero(mask_c.astype(np.float32).flatten())
        dh = (depth_mm[y1:y2, x1:x2] / 1000.0).reshape(-1)[choose]
        ys, xs = np.mgrid[y1:y2, x1:x2].astype(np.float32)
        xsf = xs.reshape(-1)[choose]
        ysf = ys.reshape(-1)[choose]
        pts = np.stack([(xsf - K[0, 2]) * dh / K[0, 0],
                        (ysf - K[1, 2]) * dh / K[1, 1], dh], axis=-1)

        flag = (np.linalg.norm((pts - target_t) @ target_R, axis=1)
                < (radius_mm / 1000.0) * 1.2)
        pts, choose = pts[flag], choose[flag]
        if len(choose) < 32:
            return self.sample(index + 7919, aug)

        n_obs = cfg.n_sample_observed_point
        idx = rng.choice(np.arange(len(choose)), n_obs,
                         replace=len(choose) <= n_obs)
        pts, choose = pts[idx], choose[idx]

        rgb_c = rgb[y1:y2, x1:x2, ::-1]
        if rng.rand() < self.color_aug_prob:
            rgb_c = color_augment(rng, rgb_c)
        rgb_c = rgb_c * (mask_c[..., None] > 0).astype(np.uint8)
        rgb_c = _resize(rgb_c, cfg.img_size)
        rgb_choose = get_resize_rgb_choose(choose, (y1, y2, x1, x2),
                                           cfg.img_size)

        vids = rng.choice(len(self.templates[obj_idx]), 2, replace=False)
        t1 = self._sample_template(obj_idx, vids[0], rng)
        t2 = self._sample_template(obj_idx, vids[1], rng)
        if aug:
            rand_R = random_rotation(rng)
            tem_pts = np.stack([t1[2] @ rand_R, t2[2] @ rand_R])
            target_R = target_R @ rand_R
            add_t = rng.uniform(-0.01, 0.01, (1, 3)).astype(np.float32)
            target_t = target_t + add_t[0]
            pts = pts + add_t + 0.001 * rng.randn(len(pts), 3)
        else:
            tem_pts = np.stack([t1[2], t2[2]])
            pts = pts + 0.001 * rng.randn(len(pts), 3)

        if self.uint8_rgb:
            rgb_out = rgb_c
            tem_rgb_out = np.stack([t1[0], t2[0]])
        else:
            rgb_out = normalize_rgb_np(rgb_c)
            tem_rgb_out = np.stack([t1[0], t2[0]]).astype(np.float32)
        return {
            "obj_idx": obj_idx,
            "pts": pts.astype(np.float32),
            "rgb": rgb_out,
            "rgb_choose": rgb_choose.astype(np.int32),
            "gt_t": target_t.astype(np.float32),
            "gt_r": target_R.astype(np.float32),
            "tem_rgb": tem_rgb_out,
            "tem_choose": np.stack([t1[1], t2[1]]).astype(np.int32),
            "tem_pts": tem_pts.astype(np.float32),
            "K": K,
        }


class SyntheticPoseDataset:
    """A random ~5 cm object of 256 points per sample, its observed cloud
    `obj @ R^T + t` (plus 1 mm noise) at a random pose, 2 template views
    of points drawn from the object, and random images: the full training
    path runs on it and its correspondence loss can be minimised."""

    def __init__(self, cfg: TrainConfig, n_samples: int = 64,
                 img_size: int | None = None, n_obs: int | None = None,
                 n_tem: int | None = None, seed: int = 0):
        self.cfg = cfg
        self.n = n_samples
        self.img_size = img_size or cfg.img_size
        self.n_obs = n_obs or cfg.n_sample_observed_point
        self.n_tem = n_tem or cfg.n_sample_template_point
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed + index)
        S, n_obs, n_tem = self.img_size, self.n_obs, self.n_tem
        obj = rng.randn(256, 3).astype(np.float32)
        obj /= np.abs(obj).max()
        obj *= 0.05

        R = random_rotation(rng)
        t = np.array([0, 0, 0.5], np.float32) + 0.05 * rng.randn(3).astype(
            np.float32)
        t[2] = abs(t[2]) + 0.3

        obs_idx = rng.randint(0, 256, n_obs)
        pts = obj[obs_idx] @ R.T + t
        pts += 0.001 * rng.randn(n_obs, 3)
        tem_pts = obj[rng.randint(0, 256, (2, n_tem))]
        return {
            "pts": pts.astype(np.float32),
            "rgb": rng.rand(S, S, 3).astype(np.float32),
            "rgb_choose": rng.randint(0, S * S, n_obs).astype(np.int32),
            "gt_r": R,
            "gt_t": t,
            "tem_rgb": rng.rand(2, S, S, 3).astype(np.float32),
            "tem_choose": rng.randint(0, S * S, (2, n_tem)).astype(np.int32),
            "tem_pts": tem_pts.astype(np.float32),
            "K": np.eye(3, dtype=np.float32),
        }


def collate(samples: list[dict]) -> dict:
    """Stack per-sample dicts into batch arrays (drops K and obj_idx)."""
    keys = [k for k in samples[0] if k not in ("K", "obj_idx")]
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def batch_iterator(dataset, batch_size: int, steps: int, start: int = 0):
    """`steps` batches of consecutive samples, wrapping around."""
    i = start
    for _ in range(steps):
        samples = [dataset[(i + j) % len(dataset)] for j in range(batch_size)]
        i += batch_size
        yield collate(samples)
