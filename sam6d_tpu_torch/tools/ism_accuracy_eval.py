"""ISM accuracy with no ground-truth masks: the trained tiny descriptor
drives the three-score detector on held-out objects, then the PEM poses
its detections for an end-to-end AR.

Counterpart of `tools/ism_accuracy_eval.py`.  The semantic, appearance
and geometric scores (`models/ism/detector.py`) must (a) pick the right
object out of a multi-object template bank, (b) retrieve a near-right
template view, and (c) give detections good enough that the ISM -> PEM
AR approaches the ground-truth-mask ceiling of `e2e_synthetic_ar`.

Proposal sources (--segmentor):
  depth_cc  connected components of the depth foreground plus random
            distractor boxes (no learned weights)
  tiny_sam  the AMG over the tiny SAM of `train_tiny_sam` (K4 and the
            fused tail K6 on the card)
The descriptor serves with K5 on the card.

Three steps: `onboard_bank` (the held-out objects' 42 rendered views and
procedural distractors), `detect_frame` a frame (object selection, the
template-view error, the selected detection), and `score_segmentor` (the
selection accuracy, the median view error and, given a PEM checkpoint,
`run_eval_multi` on the selected detections).

The JAX record: depth_cc selection 0.93, AR 0.848; tiny_sam 0.48, 0.376.

Usage:
  python -m sam6d_tpu_torch.tools.ism_accuracy_eval \\
      --desc_ckpt .ckpt_ism_desc --pem_ckpt .ckpt_flagship \\
      --pem_config flagship --held_out 2 --frames 50 --bank_objects 16 \\
      --segmentor depth_cc,tiny_sam --sam_ckpt .ckpt_tiny_sam
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from sam6d_tpu_torch.config import ISMConfig, OptimConfig, default_pem_config
from sam6d_tpu_torch.tools.e2e_synthetic_ar import (
    build_multi_dataset,
    run_eval_multi,
    smoke_pem_config,
)
from sam6d_tpu_torch.tools.train_ism_descriptor import (
    CKPT_FILE,
    render_object_views,
    tiny_descriptor_config,
)

N_VIEWS = 42


class DepthCCSegmentor:
    """Proposals: the connected components of the depth foreground plus a
    few random distractor boxes (so that selection is not trivial)."""

    def __init__(self, background_mm: float = 890.0, n_distractors: int = 4,
                 seed: int = 0):
        self.background_mm = background_mm
        self.n_distractors = n_distractors
        self.rng = np.random.RandomState(seed)
        self.depth = None  # the frame's depth in mm, set by the caller

    def generate_masks(self, image: np.ndarray, timer=None) -> dict:
        from scipy import ndimage

        if self.depth is None:
            raise RuntimeError("DepthCCSegmentor: set .depth before detect()")
        fg = self.depth < self.background_mm
        labels, n = ndimage.label(fg)
        masks, boxes = [], []
        H, W = fg.shape
        for i in range(1, n + 1):
            m = labels == i
            if m.sum() < 32:
                continue
            ys, xs = np.nonzero(m)
            masks.append(m)
            boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
        for _ in range(self.n_distractors):
            w = self.rng.randint(W // 8, W // 2)
            h = self.rng.randint(H // 8, H // 2)
            x0 = self.rng.randint(0, W - w)
            y0 = self.rng.randint(0, H - h)
            m = np.zeros((H, W), bool)
            m[y0:y0 + h, x0:x0 + w] = True
            masks.append(m)
            boxes.append([x0, y0, x0 + w - 1, y0 + h - 1])
        return {
            "masks": np.stack(masks) if masks else np.zeros((0, H, W), bool),
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        }


def viewing_angle_deg(R_est_tem, R_gt):
    """Angle between the template's viewing direction and the GT one."""
    v1 = R_est_tem[2] / np.linalg.norm(R_est_tem[2])
    v2 = R_gt[2] / np.linalg.norm(R_gt[2])
    return float(np.degrees(np.arccos(np.clip(v1 @ v2, -1, 1))))


def make_segmentor(kind: str, sam_ckpt: str, device="cuda"):
    if kind == "depth_cc":
        return DepthCCSegmentor()
    if kind == "tiny_sam":
        from sam6d_tpu_torch.tools.train_tiny_sam import load_tiny_sam_amg

        return load_tiny_sam_amg(sam_ckpt, device=device)
    raise ValueError(kind)


def template_object_poses() -> np.ndarray:
    """The level-0 template library's object-in-camera rotations (42, 4,
    4): the inverse of each camera pose's rotation."""
    from sam6d_tpu_torch.utils.template_poses import get_camera_poses

    cam_poses = get_camera_poses(0, radius=1.0)[:N_VIEWS]
    tem_poses = np.zeros((N_VIEWS, 4, 4), np.float32)
    for i, cp in enumerate(cam_poses):
        tem_poses[i, :3, :3] = cp[:3, :3].T
        tem_poses[i, 3, 3] = 1.0
    return tem_poses


def bank_arrays(objects, crop_size: int, bank_objects: int):
    """The bank's crops (O, 42, S, S, 3), masks (O, 42, S, S) and 1024-point
    clouds in metres (O, 1024, 3): the held-out objects' rendered views,
    then procedural distractors (`RandomState(777)`) up to bank_objects."""
    from sam6d_tpu_torch.models.ism.onboarding import load_template_crops
    from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh
    from sam6d_tpu_torch.utils.mesh import load_mesh

    rngd = np.random.RandomState(777)
    imgs_all, masks_all, pcs = [], [], []
    for o in objects:
        imgs, msks = load_template_crops(o["tdir"], n_views=N_VIEWS,
                                         crop_size=crop_size)
        imgs_all.append(imgs)
        masks_all.append(msks)
        mesh = load_mesh(o["cad"])
        pcs.append(mesh.vertices[np.random.RandomState(0).choice(
            len(mesh.vertices), 1024, replace=True)] / 1000.0)
    for _ in range(bank_objects - len(objects)):
        dmesh = make_procedural_mesh(rngd)
        imgs, msks = render_object_views(dmesh, N_VIEWS, crop_size, rngd,
                                         jitter=False)
        while len(imgs) < N_VIEWS:
            imgs = np.concatenate([imgs, imgs[:N_VIEWS - len(imgs)]])
            msks = np.concatenate([msks, msks[:N_VIEWS - len(msks)]])
        imgs_all.append(imgs[:N_VIEWS])
        masks_all.append(msks[:N_VIEWS])
        pcs.append(dmesh.vertices[np.random.RandomState(1).choice(
            len(dmesh.vertices), 1024, replace=True)] / 1000.0)
    return np.stack(imgs_all), np.stack(masks_all), np.stack(pcs)


def make_detector(desc_ckpt: str | None, segmentor, device="cuda",
                  dcfg=None):
    """The ISM detector over the tiny descriptor (K5 on the card): its
    trained weights from desc_ckpt (`train_ism_descriptor`), else seeded
    random ones; float32 compute."""
    from dataclasses import replace

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.tools.train_ism_descriptor import make_descriptor
    from sam6d_tpu_torch.train.checkpoint import params_file, restore_params

    dcfg = dcfg or tiny_descriptor_config()
    model = make_descriptor(dcfg, "cpu", use_flash=True)
    if desc_ckpt:
        restore_params(params_file(desc_ckpt, CKPT_FILE), model.vit)
    icfg = replace(ISMConfig(), descriptor=dcfg, compute_dtype="float32")
    return ISMDetector(icfg, segmentor, model, device=device)


def onboard_bank(det, objects, bank_objects: int):
    """Bank step: onboard the held-out objects and the distractors;
    returns the template object poses."""
    tem_poses = template_object_poses()
    imgs, masks, pcs = bank_arrays(objects, det.cfg.descriptor.image_size,
                                   bank_objects)
    det.onboard_templates(imgs, masks, tem_poses, pointcloud=pcs)
    return tem_poses


def _scores_at(dets, j):
    ex = dets.extras
    return {"final": float(dets.scores[j]),
            "sem": float(ex["semantic_score"][j]),
            "appe": float(ex["appe_score"][j]),
            "geo": float(ex["geometric_score"][j]),
            "vis": float(ex["visible_ratio"][j]),
            "template": int(ex["best_template"][j])}


def detect_frame(det, o, bank_idx: int, frame: int, gt_inst: dict,
                 K: np.ndarray, tem_poses: np.ndarray):
    """Per-frame step: detect on the frame's files, the selected object,
    its score decomposition (and the true object's best detection when
    it lost), the template-view error and the BOP detection when the
    selection is right.  Returns (diagnostic row, view error or None,
    detection or None)."""
    from sam6d_tpu_torch.utils.png import read_png
    from sam6d_tpu_torch.utils.rle import mask_to_rle

    scene = o["scene"]
    image = read_png(os.path.join(scene, "rgb", f"{frame:06d}.png"))[..., :3]
    depth = read_png(os.path.join(scene, "depth", f"{frame:06d}.png")
                     ).astype(np.float32)
    if hasattr(det.segmentor, "depth"):
        det.segmentor.depth = depth
    dets = det.detect(image, depth=depth * 1e-3, K=K)
    if len(dets) == 0:
        # Where the proposals were lost: the detector's counts by stage.
        return ({"true_obj": bank_idx, "frame": frame, "selected_obj": None,
                 "n_dets": 0, "mode": "no_detections",
                 "counts": dict(det.last_counts)}, None, None)
    best = int(np.argmax(dets.scores))
    obj = int(dets.object_ids[best])
    row = {"true_obj": bank_idx, "frame": frame, "selected_obj": obj,
           "n_dets": int(len(dets)), "winner": _scores_at(dets, best)}
    if obj != bank_idx:
        own = np.flatnonzero(np.asarray(dets.object_ids) == bank_idx)
        if len(own):
            row["mode"] = "outscored"
            row["best_true_obj_det"] = _scores_at(
                dets, int(own[np.argmax(dets.scores[own])]))
        else:
            row["mode"] = "true_object_unmatched"
        return row, None, None
    R_gt = np.asarray(gt_inst["cam_R_m2c"], np.float32).reshape(3, 3)
    ti = int(dets.extras["best_template"][best])
    rle = mask_to_rle(dets.masks[best])
    detection = {
        "scene_id": o["scene_id"], "image_id": frame,
        "category_id": o["obj_id"], "score": float(dets.scores[best]),
        "segmentation": {"size": list(rle["size"]),
                         "counts": list(map(int, rle["counts"]))},
    }
    return row, viewing_angle_deg(tem_poses[ti, :3, :3], R_gt), detection


def run_frames(det, objects, tem_poses):
    """Every held-out frame through `detect_frame`: (diagnostic rows,
    view errors, detections by object id, host seconds a frame)."""
    rows, view_errs, times = [], [], []
    by_obj = {o["obj_id"]: [] for o in objects}
    for bank_idx, o in enumerate(objects):
        scene = o["scene"]
        with open(os.path.join(scene, "scene_gt.json")) as f:
            gt = json.load(f)
        with open(os.path.join(scene, "scene_camera.json")) as f:
            scene_cam = json.load(f)
        for sid in sorted(gt, key=int):
            i = int(sid)
            if not os.path.exists(os.path.join(scene, "rgb", f"{i:06d}.png")):
                continue
            K = np.asarray(scene_cam[sid]["cam_K"], np.float32).reshape(3, 3)
            t0 = time.perf_counter()
            row, err, detection = detect_frame(det, o, bank_idx, i,
                                               gt[sid][0], K, tem_poses)
            times.append(time.perf_counter() - t0)
            rows.append(row)
            if detection is not None:
                view_errs.append(err)
                by_obj[o["obj_id"]].append(detection)
    return rows, view_errs, by_obj, times


def load_pem(kind: str, ckpt: str | None, device="cuda"):
    """(config, weights) of the PEM that poses the detections: the small
    (`smoke`) or shipped (`flagship`) config, its train state's model
    weights from `ckpt` (the newest step), or seeded random ones."""
    from sam6d_tpu_torch.train.checkpoint import restore_train_state
    from sam6d_tpu_torch.train.state import create_train_state

    cfg = default_pem_config() if kind == "flagship" else smoke_pem_config()
    state = create_train_state(cfg, OptimConfig(), device=device)
    if ckpt:
        restore_train_state(ckpt, state)
        print(f"[pem] {kind} checkpoint at step {state.step}", flush=True)
    return cfg, state.model.state_dict(), state.step


def score_segmentor(seg_kind, objects, rows, view_errs, by_obj, out_dir,
                    pem=None, device="cuda", pem_kind="smoke"):
    """Scoring step: selection accuracy, median template-view error and,
    with pem = (config, weights), the ISM -> PEM AR on the selected
    detections.  Writes the per-frame table to
    selection_diag_<kind>.json."""
    diag_path = os.path.join(out_dir, f"selection_diag_{seg_kind}.json")
    os.makedirs(out_dir, exist_ok=True)
    with open(diag_path, "w") as f:
        json.dump(rows, f, indent=1)
    fails = [r for r in rows if r.get("selected_obj") != r["true_obj"]]
    if fails:
        modes = {}
        for r in fails:
            modes[r.get("mode", "?")] = modes.get(r.get("mode", "?"), 0) + 1
        print(f"[ism/{seg_kind}] {len(fails)} selection failures by mode: "
              f"{modes} (full table: {diag_path})", flush=True)
    n_frames = len(rows)
    acc = (n_frames - len(fails)) / max(n_frames, 1)
    med = float(np.median(view_errs)) if view_errs else float("nan")
    print(f"[ism/{seg_kind}] frames {n_frames} ({len(objects)} held-out "
          f"objects), object-selection acc {acc:.3f}, median template-view "
          f"error {med:.1f} deg (random would be ~90)", flush=True)
    rec = {"frames": n_frames, "object_selection_acc": acc,
           "median_template_view_err_deg": med}
    if pem is not None:
        cfg, weights = pem
        eval_objects = [dict(o, dets=by_obj[o["obj_id"]]) for o in objects]
        out = run_eval_multi(weights, cfg, eval_objects, out_dir,
                             f"ism-{seg_kind}->pem-{pem_kind}", device=device)
        rec["e2e_ar_no_gt_masks"] = out["ar"]
        rec["e2e_detail"] = out
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--desc_ckpt", default=".ckpt_ism_desc")
    p.add_argument("--pem_ckpt", default="")
    p.add_argument("--pem_config", choices=("smoke", "flagship"),
                   default="smoke")
    p.add_argument("--bank_objects", type=int, default=4)
    p.add_argument("--held_out", type=int, default=1,
                   help="held-out target objects (one scene each, bank "
                        "indices 0..h-1)")
    p.add_argument("--frames", type=int, default=12,
                   help="frames per held-out object")
    p.add_argument("--segmentor", default="depth_cc",
                   help="comma-joined subset of {depth_cc,tiny_sam}; all "
                        "share one bank and PEM, the last is the headline")
    p.add_argument("--sam_ckpt", default=".ckpt_tiny_sam")
    p.add_argument("--out", default="build/ism_acc")
    p.add_argument("--bench_out", default=None,
                   help="the record (default <out>/ism_acc.json)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    seg_kinds = args.segmentor.split(",")
    objects = build_multi_dataset(args.out, n_objects=args.held_out,
                                  frames=args.frames)
    det = make_detector(args.desc_ckpt,
                        make_segmentor(seg_kinds[0], args.sam_ckpt,
                                       args.device), args.device)
    tem_poses = onboard_bank(det, objects, args.bank_objects)
    pem = step = None
    if args.pem_ckpt:
        cfg, weights, step = load_pem(args.pem_config, args.pem_ckpt,
                                      args.device)
        pem = (cfg, weights)
    per_seg = {}
    for kind in seg_kinds:
        # One detector and bank, the proposal generator swapped.
        det.segmentor = make_segmentor(kind, args.sam_ckpt, args.device)
        rows, errs, by_obj, times = run_frames(det, objects, tem_poses)
        per_seg[kind] = score_segmentor(kind, objects, rows, errs, by_obj,
                                        args.out, pem, args.device,
                                        args.pem_config)
        per_seg[kind]["frame_s"] = times
    head = per_seg[seg_kinds[-1]]
    rec = {"frames": head["frames"], "held_out_objects": args.held_out,
           "object_selection_acc": head["object_selection_acc"],
           "median_template_view_err_deg":
               head["median_template_view_err_deg"],
           "bank_objects": args.bank_objects, "segmentor": seg_kinds[-1],
           "pem_config": args.pem_config}
    if "e2e_ar_no_gt_masks" in head:
        rec.update(e2e_ar_no_gt_masks=head["e2e_ar_no_gt_masks"],
                   pem_step=step, e2e_detail=head["e2e_detail"])
    if len(seg_kinds) > 1:
        rec["per_segmentor"] = per_seg
    bench = args.bench_out or os.path.join(args.out, "ism_acc.json")
    with open(bench, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("e2e_detail", "per_segmentor")}),
          flush=True)
    return rec


if __name__ == "__main__":
    main()
