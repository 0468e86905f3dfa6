"""BOP evaluation sweep of the PEM, with the filesystem result merge.

Counterpart of `sam6d_tpu/pipeline/bop_eval.py` (reference Instance_
Segmentation_Model/model/detector.py:425-461: every rank writes its
shard, rank 0 globs and merges -- the filesystem as the collective).
Each frame's detections go through `BOPTestset`, are grouped by object
and posed by `PEMRunner.infer` against that object's template bank; the
banks are kept per object, so an object is onboarded once per sweep.

With `torch.distributed` initialised (`parallel.distributed.
init_distributed`; e.g. `torchrun --nproc_per_node N`), each rank poses
its round-robin share of the frames and writes its shard; a barrier
(`sync_hosts`) then lets rank 0 merge every shard.  Without it one
process is rank 0 of 1.

Output: BOP-format pose rows (scene_id, im_id, obj_id, score, R, t in
mm, time), the merged json and `result_bop.csv`.  `time` is the time
since the frame's start, so it includes the frame's onboardings, as in
the JAX package.
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
    sync_hosts,
)
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
from sam6d_tpu_torch.provider.bop import BOPTestset, load_objects


def shard_frames(frames: list, process_index: int, process_count: int):
    """Static round-robin sharding of frames across processes."""
    return frames[process_index::process_count]


def process_rank() -> tuple[int, int]:
    """(rank, count) of this process in the `torch.distributed` world;
    (0, 1) when it is not initialised."""
    return process_index(), process_count()


def run_bop_eval(cfg: PEMConfig, dataset_dir: str, detections_path: str,
                 template_root: str, output_dir: str,
                 runner: PEMRunner | None = None,
                 max_frames: int | None = None, uniforms=None,
                 device="cuda"):
    """Pose every frame's ISM detections.

    runner: a `PEMRunner` (random weights on `device` if None).
    uniforms: None, or a function of the bucket size that returns the
    hypothesis uniforms (u1, u2) of `PEMRunner.infer`; every call of the
    JAX runner reuses one key, so a test can pass that key's draws.
    Writes the shard json, and on rank 0 the merged
    `detection_pem_bop.json` and `result_bop.csv`; returns the merged
    rows on rank 0, this rank's own elsewhere."""
    process_index, process_count = process_rank()
    objects = load_objects(os.path.join(dataset_dir, "models"),
                           n_sample=cfg.n_sample_model_point,
                           template_root=template_root)
    testset = BOPTestset(cfg, dataset_dir, objects).load_detections(
        detections_path)
    frames = shard_frames(testset.frames(), process_index, process_count)
    if max_frames:
        frames = frames[:max_frames]
    if runner is None:
        runner = PEMRunner(cfg, device=device)

    os.makedirs(output_dir, exist_ok=True)
    rows = []
    # obj_id -> the runner's bank; `_onboarded_dir` travels with it, so
    # that `onboard` never takes another object's bank for this one's.
    onboarded: dict[int, tuple] = {}
    for scene_id, image_id in frames:
        batch, _ = testset.get_frame_instances(scene_id, image_id)
        if batch is None:
            continue
        t0 = time.perf_counter()
        # Each object's instances go against its own template bank.
        for obj_id in np.unique(batch["obj_id"]):
            oid = int(obj_id)
            obj = objects[oid]
            if obj.template_dir and oid not in onboarded:
                runner.onboard(obj.template_dir, cache_path=os.path.join(
                    obj.template_dir, "feat_cache.npz"))
                onboarded[oid] = (runner.tem_pts, runner.tem_feat,
                                  runner.template_bank, runner._onboarded_dir)
            elif oid in onboarded:
                (runner.tem_pts, runner.tem_feat, runner.template_bank,
                 runner._onboarded_dir) = onboarded[oid]
            if runner.template_bank is None:
                continue
            sel = np.flatnonzero(batch["obj_id"] == obj_id)
            sub = {k: batch[k][sel]
                   for k in ("pts", "rgb", "rgb_choose", "model_pts", "score")}
            u = uniforms(runner.bucket_for(len(sel))) if uniforms else None
            out = runner.infer(sub, uniforms=u)
            dt = time.perf_counter() - t0
            for j, i in enumerate(sel):
                rows.append({
                    "scene_id": int(scene_id),
                    "im_id": int(image_id),
                    "obj_id": oid,
                    "score": float(out["score"][j]),
                    "R": out["pred_R"][j].reshape(-1).tolist(),
                    "t": (out["pred_t"][j] * 1000.0).tolist(),
                    "time": dt,
                })

    merged = write_shard_and_merge(output_dir, rows, prefix="pem_shard",
                                   merged_name="detection_pem_bop.json")
    if merged is None:
        return rows
    write_bop_csv(merged, os.path.join(output_dir, "result_bop.csv"))
    return merged


def write_shard_and_merge(output_dir: str, rows: list, prefix: str,
                          merged_name: str):
    """The filesystem result collective: every rank writes
    `<prefix>_<rank>.json`, all ranks meet at a barrier (`sync_hosts`;
    without it rank 0 could glob before the others have written), then
    rank 0 globs the shards and writes the merged list.  Returns the
    merged rows on rank 0, None elsewhere."""
    rank, _ = process_rank()
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, f"{prefix}_{rank:04d}.json"),
              "w") as f:
        json.dump(rows, f)
    sync_hosts(f"{prefix}-merge")
    if rank != 0:
        return None
    merged = []
    for p in sorted(glob.glob(os.path.join(output_dir, f"{prefix}_*.json"))):
        with open(p) as f:
            merged.extend(json.load(f))
    with open(os.path.join(output_dir, merged_name), "w") as f:
        json.dump(merged, f)
    return merged


def write_bop_csv(rows: list[dict], path: str):
    """bop_toolkit's csv: scene_id,im_id,obj_id,score,R,t,time."""
    with open(path, "w") as f:
        f.write("scene_id,im_id,obj_id,score,R,t,time\n")
        for r in rows:
            R = " ".join(f"{v:.6f}" for v in r["R"])
            t = " ".join(f"{v:.6f}" for v in r["t"])
            f.write(f"{r['scene_id']},{r['im_id']},{r['obj_id']},"
                    f"{r['score']:.6f},{R},{t},{r['time']:.3f}\n")
