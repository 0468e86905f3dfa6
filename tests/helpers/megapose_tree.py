"""Write a MegaPose-layout training tree from procedural meshes.

The layout `MegaPoseDataset` reads (reference Pose_Estimation_Model/
provider/training_dataset.py:32-130, utils/data_utils.py io_load_gt /
io_load_masks):

  <root>/MegaPose-GSO/train_pbr_web/key_to_shard.json   {key: shard}
  <root>/MegaPose-GSO/train_pbr_web/gso_models.json     [{obj_id, gso_id}]
  .../shard-000000/<key>.{rgb.jpg, depth.png, camera.json, gt.json,
                          gt_info.json, mask_visib.json}
  <root>/MegaPose-GSO/templates/<gso_id>/{rgb,mask}_{0,1}.png, xyz_{0,1}.npy

gt.json and gt_info.json are lists (one entry an instance), mask_visib
is a dict keyed by the instance's index holding column-major RLE that
starts with the zero run, template xyz are float16 10x metres.  Each
frame shows one to three of the objects, composited by depth over a
textured background; its JPEG comes from `jpeg_writer.py` (quality 95,
4:2:0).  Numpy and the port only (no PIL, no JAX), so the
card's machine can write it too: `chip_smoke.py` loads this file by
its path, as the CPU tests do.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

from sam6d_tpu_torch.provider.training_dataset import (
    _render_view,
    make_procedural_mesh,
    random_rotation,
)
from sam6d_tpu_torch.utils.png import write_png
from sam6d_tpu_torch.utils.rle import mask_to_rle


def _jpeg_writer():
    path = Path(__file__).with_name("jpeg_writer.py")
    spec = importlib.util.spec_from_file_location("jpeg_writer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _background(rng, H, W):
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([110 + 60 * np.sin(x / 23.0 + p) * np.cos(y / 31.0 - p)
                    for p in phase], axis=-1)
    img += rng.randn(H, W, 3) * 6.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _template_pose(view: int, dist_mm: float):
    """Two canonical template views: from the front, and turned 90
    degrees about y and 0.3 rad about x."""
    ay, ax = ((0.0, 0.0), (np.pi / 2, 0.3))[view]
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]], np.float32)
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]], np.float32)
    return Rx @ Ry, np.array([0.0, 0.0, dist_mm], np.float32)


def write_megapose_tree(root, n_keys: int = 4, height: int = 120,
                        width: int = 160, n_objects: int = 2, seed: int = 0,
                        template_size: int = 96) -> dict:
    """Write the tree under `root`; returns {"keys", "meshes", "K"}."""
    jw = _jpeg_writer()
    rng = np.random.RandomState(seed)
    web = Path(root) / "MegaPose-GSO" / "train_pbr_web"
    shard = web / "shard-000000"
    shard.mkdir(parents=True, exist_ok=True)
    meshes = [make_procedural_mesh(rng, radius_mm=50.0)
              for _ in range(n_objects)]
    models = [{"obj_id": i, "gso_id": f"obj_{i:03d}"}
              for i in range(n_objects)]

    S = template_size
    Kt = np.array([[S, 0, S / 2], [0, S, S / 2], [0, 0, 1]], np.float32)
    for i, mesh in enumerate(meshes):
        tdir = Path(root) / "MegaPose-GSO" / "templates" / models[i]["gso_id"]
        tdir.mkdir(parents=True, exist_ok=True)
        for v in (0, 1):
            R, t = _template_pose(v, 3.2 * mesh.radius)
            rgb, mask, xyz_mm, _ = _render_view(mesh, R, t, Kt, (S, S))
            write_png(str(tdir / f"rgb_{v}.png"), rgb)
            write_png(str(tdir / f"mask_{v}.png"),
                      (mask * 255).astype(np.uint8))
            np.save(tdir / f"xyz_{v}.npy",
                    (xyz_mm / 1000.0 * 10.0).astype(np.float16))

    H, W = height, width
    f = 1.25 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    keys = []
    for n in range(n_keys):
        key = f"{n // 100:06d}_{n % 100:06d}"
        keys.append(key)
        n_inst = rng.randint(1, 4)
        rgb = _background(rng, H, W)
        depth = np.full((H, W), np.inf, np.float32)
        views, gt = [], []
        for _ in range(n_inst):
            obj = int(rng.randint(n_objects))
            R = random_rotation(rng)
            z = rng.uniform(450.0, 650.0)
            t = np.array([rng.uniform(-0.3, 0.3) * W * z / f,
                          rng.uniform(-0.3, 0.3) * H * z / f, z], np.float32)
            views.append(_render_view(meshes[obj], R, t, K, (H, W)))
            gt.append({"obj_id": obj, "cam_R_m2c": R.flatten().tolist(),
                       "cam_t_m2c": t.tolist()})
        for vrgb, vmask, _, vdepth in views:
            near = vmask & (vdepth < depth)
            rgb[near] = vrgb[near]
            depth[near] = vdepth[near]
        info, masks = [], {}
        for i, (_, vmask, _, vdepth) in enumerate(views):
            visib = vmask & (vdepth <= depth)
            info.append({"px_count_valid": int(visib.sum()),
                         "visib_fract": float(visib.sum())
                         / max(int(vmask.sum()), 1)})
            masks[str(i)] = mask_to_rle(visib)
        base = str(shard / key)
        jw.write_jpeg(base + ".rgb.jpg", rgb, 95, "4:2:0")
        write_png(base + ".depth.png",
                  np.where(np.isfinite(depth), depth, 0).astype(np.uint16))
        for suffix, obj in ((".camera.json", {"cam_K": K.flatten().tolist(),
                                              "depth_scale": 1.0}),
                            (".gt.json", gt), (".gt_info.json", info),
                            (".mask_visib.json", masks)):
            with open(base + suffix, "w") as fh:
                json.dump(obj, fh)
    with open(web / "key_to_shard.json", "w") as fh:
        json.dump({k: 0 for k in keys}, fh)
    with open(web / "gso_models.json", "w") as fh:
        json.dump(models, fh)
    return {"keys": keys, "meshes": meshes, "K": K}
