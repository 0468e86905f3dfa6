"""Write a BOP-layout dataset (LM-O-like) from two procedural objects.

The layout that `provider/bop.py`, `provider/bop_pbr.py`,
`pipeline/{ism_eval,bop_eval,bop_score}.py` read (the BOP toolkit's
format, docs/bop_datasets_format.md):

  <root>/models/obj_000001.ply, obj_000005.ply     (mm, vertex colours)
  <root>/models/models_info.json   {id: {diameter, min_*, size_*,
                                         symmetries_discrete |
                                         symmetries_continuous}}
  <root>/test/000001/rgb/<im>.png                  (8-bit RGB)
  <root>/test/000001/depth/<im>.png                (16-bit, x depth_scale mm)
  <root>/test/000001/mask_visib/<im>_<k>.png       (0 / 255)
  <root>/test/000001/scene_{camera,gt,gt_info}.json
  <root>/train_pbr/000000/rgb/<im>.jpg             (q95 4:2:0 JPEG)
  <root>/train_pbr/000000/mask_visib/<im>_<k>.png
  <root>/train_pbr/000000/scene_{camera,gt,gt_info}.json

Object 1 is a 60 mm cube (the demo's, `pipeline/make_example.py`) whose
models_info lists its discrete symmetries about z (90, 180, 270
degrees); object 5 is a vase, a surface of revolution about z whose
colours vary with height only, listed with a continuous symmetry about
z.  Every frame shows both objects, composited by depth over a textured,
tilted background plane; each GT entry has its visible mask and
visib_fract.  The camera is LM-O's (fx 572.4, fy 573.6, cx 325.3, cy
242.0 at 640 x 480), scaled to the frame's size; test depth is stored
with `depth_scale` 0.1 as LM-O stores it.  Numpy and the port only (no
PIL, no JAX), so the card's machine can write it too: `chip_smoke.py`
loads this file by its path, as the CPU tests do.

`gt_detections` turns the test split's visible masks into a BOP23
detection json (score 1), and `gt_pose_rows` its GT poses into the rows
of `pipeline/bop_eval.write_bop_csv`, which the scorer must give AR 1.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import numpy as np

from sam6d_tpu_torch.pipeline.make_example import make_cube_mesh, write_ply
from sam6d_tpu_torch.provider.training_dataset import (
    _render_view,
    random_rotation,
)
from sam6d_tpu_torch.utils.mesh import TriMesh
from sam6d_tpu_torch.utils.png import read_png, write_png
from sam6d_tpu_torch.utils.rle import mask_to_rle

OBJ_IDS = (1, 5)


def _jpeg_writer():
    path = Path(__file__).with_name("jpeg_writer.py")
    spec = importlib.util.spec_from_file_location("jpeg_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_vase_mesh(height_mm: float = 80.0, radius_mm: float = 28.0,
                   n_seg: int = 24, n_rings: int = 9) -> TriMesh:
    """A closed surface of revolution about z, centred on the origin: a
    vase profile, capped at both ends, coloured by height."""
    z = np.linspace(-height_mm / 2, height_mm / 2, n_rings)
    s = (z - z[0]) / (z[-1] - z[0])
    r = radius_mm * (0.55 + 0.45 * np.sin(np.pi * (0.15 + 0.85 * s)))
    a = 2 * np.pi * np.arange(n_seg) / n_seg
    ring = np.stack([np.cos(a), np.sin(a)], axis=1)
    verts = [np.concatenate([r[i] * ring, np.full((n_seg, 1), z[i])], axis=1)
             for i in range(n_rings)]
    verts.append(np.array([[0.0, 0.0, z[0]], [0.0, 0.0, z[-1]]]))
    verts = np.concatenate(verts).astype(np.float32)
    faces = []
    for i in range(n_rings - 1):
        for j in range(n_seg):
            p, q = i * n_seg + j, i * n_seg + (j + 1) % n_seg
            faces += [[p, q, q + n_seg], [p, q + n_seg, p + n_seg]]
    bottom, top = n_rings * n_seg, n_rings * n_seg + 1
    last = (n_rings - 1) * n_seg
    for j in range(n_seg):
        faces.append([bottom, (j + 1) % n_seg, j])
        faces.append([top, last + j, last + (j + 1) % n_seg])
    sv = (verts[:, 2] - z[0]) / (z[-1] - z[0])
    colors = np.stack([200 - 120 * sv, 90 + 120 * sv,
                       60 + 60 * np.cos(4 * np.pi * sv)], axis=1)
    return TriMesh(verts, np.asarray(faces, np.int64),
                   np.clip(colors, 0, 255).astype(np.uint8))


def _rot_z(deg: float) -> np.ndarray:
    a = np.radians(deg)
    T = np.eye(4)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return T


def _models_info(meshes: dict) -> dict:
    info = {}
    for oid, mesh in meshes.items():
        v = mesh.vertices.astype(np.float64)
        d = np.sqrt(((v[:, None] - v[None]) ** 2).sum(-1)).max()
        lo, hi = v.min(0), v.max(0)
        entry = {"diameter": float(d),
                 **{f"min_{c}": float(lo[i]) for i, c in enumerate("xyz")},
                 **{f"size_{c}": float(hi[i] - lo[i])
                    for i, c in enumerate("xyz")}}
        if oid == OBJ_IDS[0]:
            entry["symmetries_discrete"] = [
                _rot_z(deg).flatten().tolist() for deg in (90, 180, 270)]
        else:
            entry["symmetries_continuous"] = [
                {"axis": [0, 0, 1], "offset": [0, 0, 0]}]
        info[str(oid)] = entry
    return info


def _background(rng, H, W, K):
    """A textured plane tilted about the camera's x axis: (rgb uint8,
    depth mm float32)."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    s = 640.0 / W
    img = np.stack([105 + 55 * np.sin(s * x / 19.0 + p)
                    * np.cos(s * y / 27.0 - p) for p in phase], axis=-1)
    img += rng.randn(H, W, 3) * 5.0
    # The plane z = z0 + k * Y: along a pixel's ray, z = z0 / (1 - k * v),
    # v = (row - cy) / fy.
    v = (y - K[1, 2]) / K[1, 1]
    depth = 1100.0 / (1.0 - 0.35 * v)
    return np.clip(img, 0, 255).astype(np.uint8), depth.astype(np.float32)


def _frame(rng, meshes, K, H, W, diam):
    """Both objects at random rotations, left and right of the centre, at
    a depth where each spans about a fifth of the width; composited over
    the background.  Returns rgb, depth (mm), GT list, info list, visible
    masks."""
    rgb, depth = _background(rng, H, W, K)
    views, gts = [], []
    for k, (oid, mesh) in enumerate(meshes.items()):
        R = random_rotation(rng)
        z = K[0, 0] * diam[oid] / (0.2 * W) * rng.uniform(0.9, 1.15)
        u = W * (0.3 + 0.4 * k + rng.uniform(-0.05, 0.05))
        v = H * (0.5 + rng.uniform(-0.12, 0.12))
        t = np.array([(u - K[0, 2]) * z / K[0, 0],
                      (v - K[1, 2]) * z / K[1, 1], z], np.float32)
        views.append(_render_view(mesh, R, t, K, (H, W)))
        gts.append({"cam_R_m2c": R.flatten().tolist(),
                    "cam_t_m2c": t.tolist(), "obj_id": oid})
    for vrgb, vmask, _, vdepth in views:
        near = vmask & (vdepth < depth)
        rgb[near] = vrgb[near]
        depth[near] = vdepth[near]
    infos, masks = [], []
    for _, vmask, _, vdepth in views:
        visib = vmask & (vdepth <= depth)
        infos.append({"px_count_all": int(vmask.sum()),
                      "px_count_visib": int(visib.sum()),
                      "visib_fract": float(visib.sum())
                      / max(int(vmask.sum()), 1)})
        masks.append(visib)
    return rgb, depth, gts, infos, masks


def _write_scene(scene: Path, frames, K, depth_scale, rgb_ext, jw):
    for sub in ("rgb", "mask_visib") + (("depth",) if depth_scale else ()):
        (scene / sub).mkdir(parents=True, exist_ok=True)
    cams, gts, infos = {}, {}, {}
    for im, (rgb, depth, gt, info, masks) in enumerate(frames):
        if rgb_ext == "jpg":
            jw.write_jpeg(str(scene / "rgb" / f"{im:06d}.jpg"), rgb, 95,
                          "4:2:0")
        else:
            write_png(str(scene / "rgb" / f"{im:06d}.png"), rgb)
        cam = {"cam_K": K.flatten().tolist()}
        if depth_scale:
            write_png(str(scene / "depth" / f"{im:06d}.png"),
                      np.round(depth / depth_scale).astype(np.uint16))
            cam["depth_scale"] = depth_scale
        for k, m in enumerate(masks):
            write_png(str(scene / "mask_visib" / f"{im:06d}_{k:06d}.png"),
                      (m * 255).astype(np.uint8))
        cams[str(im)], gts[str(im)], infos[str(im)] = cam, gt, info
    for name, obj in (("scene_camera", cams), ("scene_gt", gts),
                      ("scene_gt_info", infos)):
        with open(scene / f"{name}.json", "w") as f:
            json.dump(obj, f)


def write_bop_tree(root, height: int = 480, width: int = 640,
                   n_test: int = 3, n_pbr: int = 8, seed: int = 0,
                   depth_scale: float = 0.1) -> dict:
    """Write the tree under `root`; returns {"root", "obj_ids",
    "meshes", "K"}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    meshes = {OBJ_IDS[0]: make_cube_mesh(60.0), OBJ_IDS[1]: make_vase_mesh()}
    models = root / "models"
    models.mkdir(parents=True, exist_ok=True)
    for oid, mesh in meshes.items():
        write_ply(mesh, str(models / f"obj_{oid:06d}.ply"))
    info = _models_info(meshes)
    with open(models / "models_info.json", "w") as f:
        json.dump(info, f)
    diam = {oid: info[str(oid)]["diameter"] for oid in meshes}
    s = width / 640.0
    K = np.array([[572.4 * s, 0, 325.3 * s], [0, 573.6 * s, 242.0 * s],
                  [0, 0, 1]], np.float32)
    jw = _jpeg_writer()
    _write_scene(root / "test" / "000001",
                 [_frame(rng, meshes, K, height, width, diam)
                  for _ in range(n_test)], K, depth_scale, "png", jw)
    if n_pbr:
        _write_scene(root / "train_pbr" / "000000",
                     [_frame(rng, meshes, K, height, width, diam)
                      for _ in range(n_pbr)], K, 0, "jpg", jw)
    return {"root": str(root), "obj_ids": list(OBJ_IDS), "meshes": meshes,
            "K": K}


def gt_detections(dataset_dir, split: str = "test") -> list[dict]:
    """BOP23 detection rows (score 1) from each GT's visible mask."""
    rows = []
    for scene in sorted((Path(dataset_dir) / split).iterdir()):
        with open(scene / "scene_gt.json") as f:
            scene_gt = json.load(f)
        for im in sorted(scene_gt, key=int):
            for k, gt in enumerate(scene_gt[im]):
                mask = read_png(str(scene / "mask_visib"
                                    / f"{int(im):06d}_{k:06d}.png")) > 127
                ys, xs = np.nonzero(mask)
                rows.append({
                    "scene_id": int(scene.name), "image_id": int(im),
                    "category_id": int(gt["obj_id"]),
                    "bbox": [float(xs.min()), float(ys.min()),
                             float(xs.max() - xs.min()),
                             float(ys.max() - ys.min())],
                    "score": 1.0, "time": 0.0,
                    "segmentation": mask_to_rle(mask)})
    return rows


def gt_pose_rows(dataset_dir, split: str = "test") -> list[dict]:
    """The GT poses as pose rows (R row-major, t in mm, score 1)."""
    rows = []
    for scene in sorted((Path(dataset_dir) / split).iterdir()):
        with open(scene / "scene_gt.json") as f:
            scene_gt = json.load(f)
        for im in sorted(scene_gt, key=int):
            for gt in scene_gt[im]:
                rows.append({"scene_id": int(scene.name), "im_id": int(im),
                             "obj_id": int(gt["obj_id"]), "score": 1.0,
                             "R": list(gt["cam_R_m2c"]),
                             "t": list(gt["cam_t_m2c"]), "time": 0.0})
    return rows


def save_json(path, obj) -> None:
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
