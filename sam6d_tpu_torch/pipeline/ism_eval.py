"""ISM evaluation sweep over a BOP dataset's test frames.

Counterpart of `sam6d_tpu/pipeline/ism_eval.py` (reference Instance_
Segmentation_Model/run_inference.py:9-80): onboard every object of the
dataset, detect on every test frame, write BOP23 detection json.  The
frames are sharded over the `torch.distributed` ranks and merged as in
`pipeline/bop_eval.py`.
The detector's descriptor cache is the port's `ReferenceData` `.npz`
(`ism_descriptors.npz`), where the JAX package pickles it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from sam6d_tpu_torch.models.ism.onboarding import (
    onboard_objects,
    onboard_objects_pbr,
)
from sam6d_tpu_torch.pipeline.bop_eval import (
    process_rank,
    shard_frames,
    write_shard_and_merge,
)
from sam6d_tpu_torch.provider.bop import (
    list_frames,
    list_scenes,
    load_frame,
    load_objects,
)


def run_ism_eval(detector, dataset_dir: str, template_root: str,
                 output_dir: str, n_views: int = 42,
                 max_frames: int | None = None, onboarding: str = "render"):
    """ISM sweep: onboard all dataset objects, then detect on every frame.

    onboarding: "render" takes template_root's rendered views (reference
    BOPTemplate); "pbr" builds the banks from the dataset's train_pbr
    images (reference BOPTemplatePBR).

    Writes this rank's `ism_shard_<rank>.json`, and on rank 0 the merged
    `detection_ism_bop.json`; returns the merged rows on rank 0 (this
    rank's own elsewhere), each `time` the frame's detect time in s."""
    process_index, process_count = process_rank()
    objects = load_objects(os.path.join(dataset_dir, "models"),
                           n_sample=detector.cfg.pointcloud_sample_num,
                           template_root=template_root)
    os.makedirs(output_dir, exist_ok=True)
    cache_path = os.path.join(output_dir, "ism_descriptors.npz")
    if onboarding == "pbr":
        obj_ids = onboard_objects_pbr(
            detector, dataset_dir, obj_ids=sorted(objects),
            pointclouds={oid: o.model_points for oid, o in objects.items()},
            cache_path=cache_path)
    elif onboarding == "render":
        template_dirs = {oid: o.template_dir for oid, o in objects.items()
                         if o.template_dir and os.path.isdir(o.template_dir)}
        obj_ids = onboard_objects(
            detector, template_dirs,
            pointclouds={oid: objects[oid].model_points
                         for oid in template_dirs},
            n_views=n_views, cache_path=cache_path)
    else:
        raise ValueError(f"onboarding must be 'render' or 'pbr', got "
                         f"{onboarding!r}")

    frames = []
    for scene_dir in list_scenes(dataset_dir):
        scene_id = int(os.path.basename(scene_dir))
        for im_id in list_frames(scene_dir):
            frames.append((scene_id, im_id, scene_dir))
    frames = shard_frames(frames, process_index, process_count)
    if max_frames:
        frames = frames[:max_frames]

    rows = []
    for scene_id, im_id, scene_dir in frames:
        rgb, depth, K = load_frame(scene_dir, im_id)
        t0 = time.perf_counter()
        dets = detector.detect(rgb, depth, K)
        dt = time.perf_counter() - t0
        if len(dets) and dets.object_ids is not None:
            # Onboarded object index -> BOP object id.
            dets.object_ids = np.asarray([obj_ids[i]
                                          for i in dets.object_ids])
        rows.extend(dets.to_bop23(scene_id, im_id, runtime=dt,
                                  object_id_offset=0))
    merged = write_shard_and_merge(output_dir, rows, prefix="ism_shard",
                                   merged_name="detection_ism_bop.json")
    return merged if merged is not None else rows
