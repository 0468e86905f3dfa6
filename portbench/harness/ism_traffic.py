"""The ISM frame traffic: onboarded objects and RGB-D frames.

The objects are `objects.make_object` boxes from the traffic file's
`object_seed`, each seen from the 42 icosphere views at 0.5 m (masked
224 x 224 crops in [0, 1], their masks, the view poses, and 2048 surface
points a model): every run onboards the same bank.  The frames are a
frozen copy of `chip_smoke.synthetic_scene` (a few flat-coloured boxes
and ellipses on a textured background, their depth 0.6-0.8 m on a 1.0 m
plane, LINEMOD-like intrinsics), drawn from `--seed`.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import objects


def synthetic_scene(rng: np.random.Generator, H: int = 480, W: int = 640,
                    shapes: int = 5):
    """(uint8 RGB (H, W, 3), metric depth (H, W), K (3, 3))."""
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    bg = (0.5 + 0.25 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 13.0)[..., None]
          + 0.1 * rng.random((H, W, 3)))
    img = bg * np.array([0.6, 0.7, 0.8], np.float32)
    depth = np.ones((H, W), np.float32)
    for _ in range(shapes):
        color = rng.random(3)
        cy, cx = rng.integers(80, H - 80), rng.integers(80, W - 80)
        ry, rx = rng.integers(30, 80), rng.integers(30, 80)
        if rng.random() < 0.5:
            inside = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[inside] = color
        depth[inside] = 0.6 + 0.2 * rng.random()
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), depth, K


def templates(tr: dict, size: int, n_points: int) -> dict:
    """The onboarding bank: images (O, T, S, S, 3) in [0, 1] masked,
    masks (O, T, S, S), poses (T, 4, 4) object-to-camera rotations of the
    views, pointcloud (O, n_points, 3)."""
    rng = np.random.default_rng(tr["object_seed"])
    views = objects.icosphere_views()[:tr["template_views"]]
    poses = np.tile(np.eye(4, dtype=np.float32), (len(views), 1, 1))
    for v, d in enumerate(views):
        poses[v, :3, :3], _ = objects.look_at(d, 0.5)
    images, masks, clouds = [], [], []
    for _ in range(tr["objects"]):
        obj = objects.make_object(rng, tuple(tr["diameter_m"]))
        ims, ms = [], []
        for v, d in enumerate(views):
            R, t = objects.look_at(d, 0.5)
            r = objects.render_crop(obj, R, t, size, rng)
            rgb = r["rgb"] * objects.IMAGENET_STD + objects.IMAGENET_MEAN
            ims.append(rgb * r["mask"][..., None])
            ms.append(r["mask"])
        images.append(np.stack(ims))
        masks.append(np.stack(ms))
        clouds.append(objects.sample_surface(obj, n_points, rng))
    return {"images": np.stack(images).astype(np.float32),
            "masks": np.stack(masks), "poses": poses,
            "pointcloud": np.stack(clouds)}


def frames(tr: dict, seed: int) -> list:
    rng = np.random.default_rng([tr["object_seed"], seed])
    return [synthetic_scene(rng, shapes=tr["shapes"])
            for _ in range(tr["frames"])]
