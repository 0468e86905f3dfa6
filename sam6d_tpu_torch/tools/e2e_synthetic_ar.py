"""End-to-end BOP AR on synthetic scenes: trained PEM against random
weights.

Counterpart of `tools/e2e_synthetic_ar.py`: a procedural NOCS-coloured
object -> a BOP-layout dataset (models/ + test scenes with depth and
scene_gt) + its rendered template bank -> `PEMRunner.run_file_pipeline`
a frame on the ground-truth masks (as if the ISM were perfect) ->
`pipeline/bop_score.score_dataset`, the BOP19 AR.  The same seeds give
the same meshes, frames and JSON files as the JAX tool; the PNGs go
through the port's codec (`utils/png.py`).

The checkpoint comes from `smoke_train_eval --ckpt_dir` (the same small
PEM config); a random-weights pass is scored beside it.

Usage:
  python -m sam6d_tpu_torch.tools.smoke_train_eval --steps 2000 \\
      --ckpt_dir .ckpt_smoke
  python -m sam6d_tpu_torch.tools.e2e_synthetic_ar --ckpt_dir .ckpt_smoke \\
      [--frames 12] [--out build/e2e_ar] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sam6d_tpu_torch.config import (
    CoarseMatchingConfig,
    FineMatchingConfig,
    GeoEmbeddingConfig,
    PEMConfig,
    ViTConfig,
)


def build_dataset(out_root: str, seed: int = 424242, frames: int = 12,
                  template_size: int = 96, obj_id: int = 1,
                  scene_id: int = 0, template_root: str | None = None):
    """A synthetic single-object BOP-layout dataset and its rendered
    templates; returns (cad path, template dir, scene dir, GT-mask
    detections).  obj_id / scene_id let `build_multi_dataset` put one
    scene per object under one root (`models_info.json` is merged)."""
    from sam6d_tpu_torch.pipeline.make_example import write_ply
    from sam6d_tpu_torch.pipeline.renderer import render_templates
    from sam6d_tpu_torch.provider.training_dataset import (
        _render_view,
        make_procedural_mesh,
        random_rotation,
    )
    from sam6d_tpu_torch.utils.png import write_png
    from sam6d_tpu_torch.utils.rle import mask_to_rle

    rng = np.random.RandomState(seed)
    mesh = make_procedural_mesh(rng, radius_mm=50.0)

    models = os.path.join(out_root, "models")
    scene = os.path.join(out_root, "test", f"{scene_id:06d}")
    os.makedirs(models, exist_ok=True)
    os.makedirs(os.path.join(scene, "depth"), exist_ok=True)
    os.makedirs(os.path.join(scene, "rgb"), exist_ok=True)

    cad = os.path.join(models, f"obj_{obj_id:06d}.ply")
    write_ply(mesh, cad)
    diameter = 2.0 * float(np.linalg.norm(mesh.vertices, axis=1).max())
    info_path = os.path.join(models, "models_info.json")
    info = {}
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
    info[str(obj_id)] = {"diameter": diameter}
    _dump(info, info_path)

    # Template bank: level-0 icosphere views from the training rasterizer,
    # each object's under its own directory of template_root.
    troot = template_root or out_root
    os.makedirs(troot, exist_ok=True)
    tdir = render_templates(cad, troot, image_size=template_size)

    S = 160
    f = 4.0 * S
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    gt, cam, dets = {}, {}, []
    for i in range(frames):
        R = random_rotation(rng)
        z = rng.uniform(400.0, 600.0)
        lat = z / f
        t = np.array([rng.uniform(-20, 20) * lat,
                      rng.uniform(-20, 20) * lat, z], np.float32)
        rgb, mask, _, depth_mm = _render_view(mesh, R, t, K, (S, S))
        if mask.sum() < 64:
            continue
        write_png(os.path.join(scene, "rgb", f"{i:06d}.png"), rgb)
        write_png(os.path.join(scene, "depth", f"{i:06d}.png"),
                  np.where(mask, depth_mm, 900.0).astype(np.uint16))
        gt[str(i)] = [{"obj_id": obj_id,
                       "cam_R_m2c": R.flatten().tolist(),
                       "cam_t_m2c": t.tolist()}]
        cam[str(i)] = {"cam_K": K.flatten().tolist(), "depth_scale": 1.0}
        rle = mask_to_rle(mask)
        dets.append({
            "scene_id": scene_id, "image_id": i, "category_id": obj_id,
            "score": 0.9,
            "segmentation": {"size": list(rle["size"]),
                             "counts": list(map(int, rle["counts"]))},
        })
    _dump(gt, os.path.join(scene, "scene_gt.json"))
    _dump(cam, os.path.join(scene, "scene_camera.json"))
    _dump({k: [{"visib_fract": 1.0}] for k in gt},
          os.path.join(scene, "scene_gt_info.json"))
    return cad, tdir, scene, dets


def _dump(obj, path: str):
    with open(path, "w") as f:
        json.dump(obj, f)


def build_multi_dataset(out_root: str, n_objects: int = 2,
                        frames: int = 50, seed0: int = 424242,
                        template_size: int = 96):
    """One BOP-layout root with one scene per held-out object; object 0
    is `build_dataset`'s default object (seed0), each further one a fresh
    procedural mesh.  Returns a list of per-object dicts."""
    objects = []
    for j in range(n_objects):
        cad, tdir, scene, dets = build_dataset(
            out_root, seed=seed0 + 100001 * j, frames=frames,
            template_size=template_size, obj_id=j + 1, scene_id=j,
            template_root=os.path.join(out_root, f"obj{j + 1}"),
        )
        objects.append({
            "obj_id": j + 1, "scene_id": j, "cad": cad, "tdir": tdir,
            "scene": scene, "dets": dets,
        })
    return objects


def smoke_pem_config() -> PEMConfig:
    """The small PEM of `smoke_train_eval`: 32 / 128 points, 64-d, label
    thresholds 0.4 / 0.25 (above the sparse template point spacing,
    ~2r / sqrt(32), or every coarse label is background and the
    hypothesis solve gets no foreground weight)."""
    return PEMConfig(
        coarse_npoint=32,
        fine_npoint=128,
        feature_extraction=ViTConfig(
            embed_dim=48, out_dim=32, img_size=32, patch_size=8
        ),
        geo_embedding=GeoEmbeddingConfig(hidden_dim=64),
        coarse_point_matching=CoarseMatchingConfig(
            input_dim=32, hidden_dim=64, out_dim=64, nproposal1=512,
            nproposal2=64, loss_dis_thres=0.4,
        ),
        fine_point_matching=FineMatchingConfig(
            input_dim=32, hidden_dim=64, out_dim=64, pe_nsample1=8,
            pe_nsample2=16, pe_radius1=0.3, pe_radius2=0.6,
            loss_dis_thres=0.25, dis_thres=0.25,
        ),
        n_template_view=8,
        n_sample_template_point=128,
        n_sample_model_point=128,
        n_sample_observed_point=128,
    )


def write_camera(scene: str, path: str) -> str:
    """The scene's camera (one K for every frame) as a demo camera.json."""
    with open(os.path.join(scene, "scene_camera.json")) as f:
        _dump(next(iter(json.load(f).values())), path)
    return path


def gt_rows(objects) -> list[dict]:
    """BOP result rows of the ground-truth poses of every object's scene
    (score 1): the scorer must give them an AR of exactly 1."""
    rows = []
    for o in objects:
        with open(os.path.join(o["scene"], "scene_gt.json")) as f:
            gt = json.load(f)
        for sid, insts in gt.items():
            for g in insts:
                rows.append({"scene_id": o["scene_id"], "im_id": int(sid),
                             "obj_id": g["obj_id"], "score": 1.0,
                             "R": g["cam_R_m2c"], "t": g["cam_t_m2c"],
                             "time": 0.0})
    return rows


def make_runner(state_dict, cfg: PEMConfig, device="cuda"):
    """The PEMRunner an evaluation poses with: `state_dict` the PEM's
    weights (None: random weights from seed 0), float32 compute as the
    JAX runner's."""
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    return PEMRunner(cfg, state_dict=state_dict, device=device)


def pose_rows(runner, objects, out_dir: str, det_score_thresh: float = 0.2,
              uniforms=None):
    """`run_file_pipeline` on every detection of every object (one
    detection json a frame) -> (BOP rows, host seconds a request).
    uniforms: optional (u1, u2) for every request's coarse draws, as the
    JAX runner reuses its seed's key on every frame."""
    rows, times = [], []
    os.makedirs(out_dir, exist_ok=True)
    for o in objects:
        scene = o["scene"]
        cam_path = write_camera(scene, os.path.join(
            out_dir, f"camera_{o['obj_id']}.json"))
        for det in o["dets"]:
            i = det["image_id"]
            seg_path = os.path.join(out_dir, f"det_{o['obj_id']}_{i}.json")
            _dump([det], seg_path)
            t0 = time.perf_counter()
            results, _, _ = runner.run_file_pipeline(
                os.path.join(scene, "rgb", f"{i:06d}.png"),
                os.path.join(scene, "depth", f"{i:06d}.png"),
                cam_path, o["cad"], seg_path, o["tdir"],
                det_score_thresh=det_score_thresh, uniforms=uniforms,
            )
            if runner.device.type == "cuda":
                torch.cuda.synchronize(runner.device)
            times.append(time.perf_counter() - t0)
            for r in results:
                rows.append({
                    "scene_id": o["scene_id"], "im_id": i,
                    "obj_id": o["obj_id"], "score": r["score"],
                    "R": r["R"], "t": r["t"], "time": 0.0,
                })
    return rows, times


def score(rows, dataset_dir: str, tag: str, request_s=()) -> dict:
    """The BOP19 scorer on `rows`, printed as the JAX tool prints it; the
    result also carries the scorer's host seconds and the requests'."""
    from sam6d_tpu_torch.pipeline.bop_score import score_dataset

    t0 = time.perf_counter()
    out = score_dataset(rows, dataset_dir)
    out["score_s"] = time.perf_counter() - t0
    out["request_s"] = list(request_s)
    print(f"[{tag}] AR={out['ar']:.3f} (vsd {out.get('ar_vsd', 0):.3f} "
          f"mssd {out['ar_mssd']:.3f} mspd {out['ar_mspd']:.3f}) "
          f"over {out['n_gt']} GT", flush=True)
    return out


def run_eval_multi(state_dict, cfg, objects, out_dir, tag,
                   det_score_thresh: float = 0.2, device="cuda",
                   uniforms=None):
    """`run_eval` over several objects: one runner (its onboarding kept
    per template directory), one merged scoring pass over every scene."""
    runner = make_runner(state_dict, cfg, device)
    rows, times = pose_rows(runner, objects, out_dir, det_score_thresh,
                            uniforms)
    dataset_dir = os.path.dirname(os.path.dirname(objects[0]["scene"]))
    return score(rows, dataset_dir, tag, times)


def run_eval(state_dict, cfg, cad, tdir, scene, dets, out_dir, tag,
             device="cuda", uniforms=None):
    """The held-out object's frames through the file pipeline on its GT
    masks, scored: the BOP19 result dict (`ar`, `ar_vsd`, `ar_mssd`,
    `ar_mspd`, `n_gt`, ...)."""
    obj = {"obj_id": 1, "scene_id": 0, "cad": cad, "tdir": tdir,
           "scene": scene, "dets": dets}
    return run_eval_multi(state_dict, cfg, [obj], out_dir, tag,
                          device=device, uniforms=uniforms)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt_dir", required=True)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--out", default="build/e2e_ar")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sam6d_tpu_torch.config import OptimConfig
    from sam6d_tpu_torch.train.checkpoint import restore_train_state
    from sam6d_tpu_torch.train.state import create_train_state

    cfg = smoke_pem_config()
    cad, tdir, scene, dets = build_dataset(args.out, frames=args.frames)
    state = create_train_state(cfg, OptimConfig(), device=args.device)
    out_rand = run_eval(state.model.state_dict(), cfg, cad, tdir, scene,
                        dets, args.out, "random", device=args.device)
    state = restore_train_state(args.ckpt_dir, state)
    out_tr = run_eval(state.model.state_dict(), cfg, cad, tdir, scene, dets,
                      args.out, f"trained(step {state.step})",
                      device=args.device)
    print(f"AR improvement random -> trained: "
          f"{out_rand['ar']:.3f} -> {out_tr['ar']:.3f}")
    return {"random": out_rand, "trained": out_tr}


if __name__ == "__main__":
    main()
