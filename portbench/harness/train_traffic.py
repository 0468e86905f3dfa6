"""The PEM training traffic: batches of rendered samples and the pose
noise of each step, made from the seed.

A sample is what the MegaPose loader gives `train_step`: one object (an
`objects.make_object` box, a new one each sample), its observed instance
under a random pose (2048 points with depth noise, the 224 x 224 masked
crop and its pixel indices), two of its 42 template views (crops,
object-frame points, pixel indices) and the ground-truth pose.  The
batches form a ring on the card, built at set-up; every batch holds other
samples.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import objects


def sample(cfg, tcfg, rng: np.random.Generator, tr: dict) -> dict:
    S = tcfg.img_size
    obj = objects.make_object(rng, tuple(tr["diameter_m"]))
    inst = objects.instance(obj, S, tcfg.n_sample_observed_point, rng,
                            tuple(tr["distance_m"]), tr["depth_noise_m"])
    views = objects.icosphere_views()
    rgb, pts, choose = [], [], []
    for v in rng.choice(len(views), tr["template_views"], replace=False):
        R, t = objects.look_at(views[v], 0.5)
        r = objects.render_crop(obj, R, t, S, rng)
        idx = np.flatnonzero(r["mask"].reshape(-1))
        ch = rng.choice(idx, tcfg.n_sample_template_point,
                        replace=len(idx) < tcfg.n_sample_template_point)
        rgb.append(r["rgb"])
        pts.append(r["obj"].reshape(-1, 3)[ch])
        choose.append(ch)
    return {"pts": inst["pts"], "rgb": inst["rgb"],
            "rgb_choose": inst["rgb_choose"], "gt_r": inst["R"],
            "gt_t": inst["t"], "tem_rgb": np.stack(rgb),
            "tem_pts": np.stack(pts), "tem_choose": np.stack(choose)}


def batches(cfg, tcfg, tr: dict, seed: int, device) -> list[dict]:
    """`tr["ring"]` batches of `tcfg.batch_size` samples, as tensors on
    the device."""
    import torch

    rng = np.random.default_rng([tr["object_seed"], seed])
    out = []
    for _ in range(tr["ring"]):
        ss = [sample(cfg, tcfg, rng, tr) for _ in range(tcfg.batch_size)]
        b = {k: np.stack([s[k] for s in ss]) for k in ss[0]}
        out.append({k: torch.as_tensor(v, device=device)
                    for k, v in b.items()})
    return out


def pose_noise(B: int, generator, device, std_rots=(15.0, 10.0, 5.0, 1.25,
                                                    1.0)):
    """One step's pose-noise draws in `aug_pose_noise`'s layout: the
    rotation std (1,) picked from std_rots, n_rot (B, 3), n_trans (B, 3)."""
    import torch

    pick = torch.randint(len(std_rots), (1,), generator=generator,
                         device=device)
    std = torch.tensor(std_rots, device=device)[pick]
    return (std, torch.randn(B, 3, generator=generator, device=device),
            torch.randn(B, 3, generator=generator, device=device))
