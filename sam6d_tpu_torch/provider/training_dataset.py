"""Synthetic PEM training samples, collation and a batch iterator.

A numpy copy of the synthetic part of
`sam6d_tpu/provider/training_dataset.py` (the port imports nothing of the
JAX package): the same seeds give the same arrays.  `SyntheticPoseDataset`
needs no external data and yields samples in the raw-template layout
`train.state.train_step` consumes.
"""

from __future__ import annotations

import numpy as np

from sam6d_tpu_torch.config import TrainConfig


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
