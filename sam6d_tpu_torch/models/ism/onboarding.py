"""ISM template onboarding from rendered template directories.

Counterpart of `sam6d_tpu/models/ism/onboarding.py` (reference
run_inference_custom.py:129-163: load the 42 rendered views, crop and
resize them to the descriptor's input, then detector.set_reference_
objects), with the port's PNG codec and PIL-exact resize in place of
PIL, so the crops equal the JAX package's.  Onboarding from a dataset's
train_pbr renders (`onboard_objects_pbr`) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from sam6d_tpu_torch.utils.bbox import square_bbox
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.resize import pil_resize
from sam6d_tpu_torch.utils.template_poses import (
    get_obj_poses_from_template_level,
)


def load_template_crops(template_dir: str, n_views: int = 42,
                        crop_size: int = 224):
    """Rendered views -> masked square crops at descriptor resolution:
    (images (T, S, S, 3) float [0, 1], masks (T, S, S) bool)."""
    imgs, masks = [], []
    for i in range(n_views):
        rgb = read_png(os.path.join(template_dir, f"rgb_{i}.png"))[..., :3]
        mask = read_png(os.path.join(template_dir, f"mask_{i}.png"))
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = mask == 255
        y1, y2, x1, x2 = square_bbox(mask)
        crop = rgb[y1:y2, x1:x2] * (mask[y1:y2, x1:x2, None] > 0)
        m_crop = mask[y1:y2, x1:x2]
        crop = pil_resize(crop.astype(np.uint8), crop_size, crop_size,
                          "bilinear").astype(np.float32) / 255.0
        m_crop = pil_resize((m_crop * 255).astype(np.uint8), crop_size,
                            crop_size, "nearest") > 127
        imgs.append(crop)
        masks.append(m_crop)
    return np.stack(imgs), np.stack(masks)


def onboard_objects(detector, template_dirs: dict[int, str],
                    pointclouds: dict[int, np.ndarray] | None = None,
                    template_poses: np.ndarray | None = None,
                    n_views: int = 42, cache_path: str | None = None):
    """Onboard objects into an `ISMDetector`.

    template_dirs: obj_id -> rendered-template directory; pointclouds:
    obj_id -> (N, 3) model samples in metres; template_poses: (T, 4, 4),
    the level-0 icosphere's by default.  `cache_path` is the detector's
    `.npz` cache (`ReferenceData.save_npz`).  Returns the sorted ids."""
    obj_ids = sorted(template_dirs)
    size = detector.cfg.descriptor.image_size
    images, masks = [], []
    for oid in obj_ids:
        im, m = load_template_crops(template_dirs[oid], n_views, size)
        images.append(im)
        masks.append(m)
    if template_poses is None:
        template_poses = get_obj_poses_from_template_level(level=0)[:n_views]
    pcs = None
    if pointclouds is not None:
        pcs = np.stack([pointclouds[oid] for oid in obj_ids])
    detector.onboard_templates(
        template_images=np.stack(images),
        template_masks=np.stack(masks),
        template_poses=template_poses,
        pointcloud=pcs,
        cache_path=cache_path,
    )
    return obj_ids
