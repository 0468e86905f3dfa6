"""Procedural objects and their views: the PEM's templates and observed
instances, made from a seed.

An object is a box of 5-20 cm diameter whose six faces carry a colour and
a stripe texture.  A view is ray-cast straight into the square crop that
the serving pipeline would cut around the object and resize to S x S:
each crop pixel's ray is intersected with the box, which gives the mask,
the camera-frame point (with depth noise for an observed instance) and the
object-frame point (a template's xyz map).  Images are masked and
ImageNet-normalised as `pipeline/pem_data.py` does.  Occlusion between
instances is not modelled: every instance is rendered alone.
"""

from __future__ import annotations

import numpy as np

# LINEMOD's intrinsics (BOP lm / lmo camera).
K_LM = np.array([[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
                 [0.0, 0.0, 1.0]])
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
H_IMG, W_IMG = 480, 640


def make_object(rng: np.random.Generator, diameter=(0.05, 0.20)) -> dict:
    """A box: half extents (3,) in metres, face colours (6, 3) in [0, 1]
    and stripe frequencies (6,)."""
    d = rng.uniform(*diameter)
    h = rng.uniform(0.4, 1.0, 3)
    h = h * (d / 2.0) / np.linalg.norm(h)
    return {"half": h, "colors": rng.uniform(0.15, 0.95, (6, 3)),
            "freq": rng.uniform(40.0, 160.0, 6)}


def sample_surface(obj: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n points uniform over the box's surface, (n, 3) float32."""
    h = obj["half"]
    areas = np.array([h[1] * h[2], h[0] * h[2], h[0] * h[1]] * 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    axis, sign = face % 3, np.where(face < 3, 1.0, -1.0)
    pts = rng.uniform(-1.0, 1.0, (n, 3)) * h
    pts[np.arange(n), axis] = sign * h[axis]
    return pts.astype(np.float32)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def icosphere_views() -> np.ndarray:
    """The 42 vertices of a once-subdivided icosahedron, (42, 3) unit."""
    t = (1.0 + 5 ** 0.5) / 2.0
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    v = [np.array(p, float) / np.linalg.norm(p) for p in v]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    mids = {}
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                mids[key] = m / np.linalg.norm(m)
    return np.stack(v + [mids[k] for k in sorted(mids)])


def look_at(direction: np.ndarray, distance: float):
    """Camera at `distance` along `direction` from the object, looking at
    its centre: (R, t) with x_cam = R x_obj + t."""
    z = -direction / np.linalg.norm(direction)  # camera z points at it
    up = np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9 else np.array(
        [0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, np.array([0.0, 0.0, distance])


def render_crop(obj: dict, R: np.ndarray, t: np.ndarray, S: int,
                rng: np.random.Generator, depth_noise: float = 0.0,
                K: np.ndarray = K_LM) -> dict:
    """Ray-cast the box under pose (R, t) into the square crop around its
    projection, resized to S x S.  Returns mask (S, S) bool, cam and obj
    (S, S, 3) float32 points, and rgb (S, S, 3) ImageNet-normalised, with
    the crop masked as the pipeline masks it."""
    h = obj["half"]
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * h
    cam = corners @ R.T + t
    uv = cam[:, :2] / cam[:, 2:] * np.array([K[0, 0], K[1, 1]]) + K[:2, 2]
    lo, hi = uv.min(0), uv.max(0)
    c, side = (lo + hi) / 2.0, (hi - lo).max() * 1.1 + 2.0
    px = (np.arange(S) + 0.5) * side / S + (c[0] - side / 2.0)
    py = (np.arange(S) + 0.5) * side / S + (c[1] - side / 2.0)
    u, v = np.meshgrid(px, py)
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                  np.ones_like(u)], -1).reshape(-1, 3)
    o = -R.T @ t  # camera centre in the object frame
    dirs = d @ R  # ray directions in the object frame (R^T d)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-h - o) / dirs
        t2 = (h - o) / dirs
    tn = np.nanmax(np.minimum(t1, t2), axis=1)
    tf = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (tn <= tf) & (tn > 0)
    depth = np.where(hit, tn, 0.0)
    p_obj = o + dirs * depth[:, None]
    if depth_noise:
        depth = depth + rng.normal(0.0, depth_noise, depth.shape) * hit
    p_cam = d * depth[:, None]
    # The face hit: the axis where |p| reaches the half extent.
    rows = np.arange(len(depth))
    axis = np.argmax(np.abs(p_obj) / h, axis=1)
    face = axis + 3 * (p_obj[rows, axis] < 0)
    stripe = 0.75 + 0.25 * np.sin(obj["freq"][face]
                                  * p_obj[rows, (axis + 1) % 3])
    color = obj["colors"][face] * stripe[:, None] * hit[:, None]
    rgb = ((color.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD)
    return {"mask": hit.reshape(S, S),
            "cam": p_cam.reshape(S, S, 3).astype(np.float32),
            "obj": p_obj.reshape(S, S, 3).astype(np.float32),
            "rgb": rgb.reshape(S, S, 3).astype(np.float32)}


def _choose(mask: np.ndarray, n: int, rng: np.random.Generator):
    idx = np.flatnonzero(mask.reshape(-1))
    return rng.choice(idx, n, replace=len(idx) < n)


def templates(obj: dict, S: int, n_points: int, rng: np.random.Generator,
              n_views: int = 42) -> dict:
    """The onboarding views: tem_rgb (T, S, S, 3), tem_pts (T, Np, 3)
    object-frame metres, tem_choose (T, Np), from the 42 icosphere
    directions at 0.5 m."""
    views = icosphere_views()[:n_views]
    rgb, pts, choose = [], [], []
    for direction in views:
        R, t = look_at(direction, 0.5)
        r = render_crop(obj, R, t, S, rng)
        ch = _choose(r["mask"], n_points, rng)
        rgb.append(r["rgb"])
        pts.append(r["obj"].reshape(-1, 3)[ch])
        choose.append(ch)
    return {"tem_rgb": np.stack(rgb), "tem_pts": np.stack(pts),
            "tem_choose": np.stack(choose).astype(np.int64)}


def instance(obj: dict, S: int, n_obs: int, rng: np.random.Generator,
             z_range=(0.4, 0.9), depth_noise: float = 0.001) -> dict:
    """One observed instance under a random pose: pts (N, 3) camera-frame
    metres with depth noise, rgb (S, S, 3), rgb_choose (N,), and the pose
    (R, t) it was rendered at."""
    R = random_rotation(rng)
    z = rng.uniform(*z_range)
    t = np.array([rng.uniform(-0.15, 0.15) * z, rng.uniform(-0.1, 0.1) * z, z])
    r = render_crop(obj, R, t, S, rng, depth_noise)
    ch = _choose(r["mask"], n_obs, rng)
    return {"pts": r["cam"].reshape(-1, 3)[ch], "rgb": r["rgb"],
            "rgb_choose": ch.astype(np.int64), "R": R.astype(np.float32),
            "t": t.astype(np.float32)}
