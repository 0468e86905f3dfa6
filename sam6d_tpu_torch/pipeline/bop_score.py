"""The BOP19 scorer: VSD, MSSD and MSPD, then the Average Recall.

Counterpart of `sam6d_tpu/pipeline/bop_score.py`, which implements the
protocol of bop_toolkit's eval_bop19_pose.py in-repo (the reference
defers scoring to the external toolkit, Pose_Estimation_Model/README.md:
110-121):

  * MSSD -- maximum symmetry-aware surface distance; recall thresholds
    theta in {0.05..0.5} x the object's diameter.
  * MSPD -- maximum symmetry-aware projection distance (pixels); recall
    thresholds r * w/640, r in {5..50}.
  * VSD  -- visible surface discrepancy on depth-rendered visibility
    masks; misalignment tolerance tau in {0.05..0.5} x diameter, recall
    thresholds {0.05..0.5}.
  * AR   -- each metric's mean recall over its thresholds, then
    AR = (AR_VSD + AR_MSSD + AR_MSPD) / 3.

Matching follows bop_toolkit's pose_matching.py: per correctness
threshold (and per VSD tau), each metric on its own error matrix; only
pairs with an error below the threshold match; estimates go in
confidence order and each claims its lowest-error unclaimed GT.  GTs
below the visibility cutoff stay matchable but are excluded from the
recall's numerator and denominator.

Numpy float64 on the host, as in the JAX package, so the recalls are
equal to its.  The depth maps of VSD are rendered by the port's
`pipeline/renderer.rasterize` (the native library, else numpy, as the
JAX scorer), the scene depth is
read with `utils/png.py`, and MSPD's image width comes from the frame's
file header (`utils/image_header.py`), in the JAX package's order of
files and with its 2 * cx fallback.

Units follow BOP: R/t in the csv and scene_gt are mm; depth images are
mm after depth_scale.

CLI:
  python -m sam6d_tpu_torch.pipeline.bop_score --csv result_bop.csv \
      --dataset_dir <bop_root/dataset> [--split test] [--no_vsd]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from sam6d_tpu_torch.pipeline import renderer
from sam6d_tpu_torch.utils import image_header
from sam6d_tpu_torch.utils.mesh import load_mesh
from sam6d_tpu_torch.utils.png import read_png

VSD_TAUS = np.arange(0.05, 0.51, 0.05)  # x diameter
VSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)
MSSD_THRESHOLDS = np.arange(0.05, 0.51, 0.05)  # x diameter
MSPD_THRESHOLDS = np.arange(5.0, 51.0, 5.0)  # x w/640 pixels
VSD_DELTA_MM = 15.0  # occlusion tolerance (BOP default)


def symmetry_transforms(
    meta: dict,
    n_continuous: int | None = None,
    max_sym_disc_step: float = 0.01,
) -> np.ndarray:
    """All symmetry transforms of an object as (S, 4, 4), identity first.

    meta: a models_info.json entry; discrete symmetries are flattened
    4x4s under 'symmetries_discrete', continuous ones are
    {'axis': [x,y,z], 'offset': [x,y,z]} discretized into rotations
    (bop_toolkit misc.get_symmetry_transformations).  With
    n_continuous=None the step count follows the toolkit's arc-length
    bound: ceil(pi / max_sym_disc_step) steps, i.e. a vertex at radius
    diameter/2 moves at most max_sym_disc_step x diameter per step
    (default 1% of diameter, the toolkit default).
    """
    if n_continuous is None:
        n_continuous = int(np.ceil(np.pi / max_sym_disc_step))
    trans = [np.eye(4)]
    for sym in meta.get("symmetries_discrete", []) or []:
        trans.append(np.asarray(sym, np.float64).reshape(4, 4))
    base = list(trans)
    for sym in meta.get("symmetries_continuous", []) or []:
        axis = np.asarray(sym["axis"], np.float64)
        axis = axis / np.linalg.norm(axis)
        offset = np.asarray(sym.get("offset", [0, 0, 0]), np.float64)
        for k in range(1, n_continuous):
            angle = 2.0 * np.pi * k / n_continuous
            K = np.array(
                [
                    [0, -axis[2], axis[1]],
                    [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0],
                ]
            )
            R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = offset - R @ offset
            for B in base:
                trans.append(T @ B)
    return np.stack(trans)


def _gt_sym_poses(R_gt, t_gt, syms):
    """GT pose composed with every symmetry: (S, 3, 3), (S, 3)."""
    Rs = R_gt[None] @ syms[:, :3, :3]
    ts = (R_gt[None] @ syms[:, :3, 3:]).squeeze(-1) + t_gt[None]
    return Rs, ts


def mssd(R_est, t_est, R_gt, t_gt, pts, syms) -> float:
    """Maximum symmetry-aware surface distance (mm).

    pts: (N, 3) model vertices/samples in mm; syms: (S, 4, 4).
    """
    Rs, ts = _gt_sym_poses(R_gt, t_gt, syms)
    est = pts @ R_est.T + t_est  # (N, 3)
    gt = np.einsum("sij,nj->sni", Rs, pts) + ts[:, None]  # (S, N, 3)
    d = np.linalg.norm(est[None] - gt, axis=-1).max(axis=1)  # (S,)
    return float(d.min())


def _project(pts_cam, K):
    uv = pts_cam @ K.T
    return uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)


def mspd(R_est, t_est, R_gt, t_gt, pts, syms, K) -> float:
    """Maximum symmetry-aware projection distance (pixels)."""
    est_uv = _project(pts_cam=pts @ R_est.T + t_est, K=K)
    Rs, ts = _gt_sym_poses(R_gt, t_gt, syms)
    gt = np.einsum("sij,nj->sni", Rs, pts) + ts[:, None]  # (S, N, 3)
    uv = gt @ K.T
    uv = uv[..., :2] / np.maximum(uv[..., 2:3], 1e-9)
    d = np.linalg.norm(est_uv[None] - uv, axis=-1).max(axis=1)  # (S,)
    return float(d.min())


def _render_depth(mesh, R, t_mm, K, hw):
    verts_cam = mesh.vertices @ R.T + t_mm
    _, mask, depth = renderer.rasterize(
        verts_cam, mesh.faces, K, hw,
        np.zeros((len(mesh.vertices), 1), np.float32),
    )
    return np.where(mask, depth, 0.0)


def vsd(
    R_est, t_est, R_gt, t_gt, depth_scene_mm, K, mesh,
    diameter_mm: float, taus=VSD_TAUS, delta_mm: float = VSD_DELTA_MM,
) -> np.ndarray:
    """Visible surface discrepancy, one error per tau (BOP19).

    Visibility: a rendered pixel is visible if the scene depth there is
    invalid or not closer than the render by more than delta; the GT
    visibility set is ADDED to the estimate's (bop_toolkit
    visibility.estimate_visib_mask_est) so the estimate cannot hide
    behind occluders.
    """
    hw = depth_scene_mm.shape
    d_gt = _render_depth(mesh, R_gt, t_gt, K, hw)
    d_est = _render_depth(mesh, R_est, t_est, K, hw)
    return vsd_from_depths(
        d_est, d_gt, depth_scene_mm, diameter_mm, taus, delta_mm
    )


def vsd_from_depths(
    d_est, d_gt, depth_scene_mm, diameter_mm: float,
    taus=VSD_TAUS, delta_mm: float = VSD_DELTA_MM,
) -> np.ndarray:
    """VSD errors from pre-rendered est/GT depth maps (mm).

    Split out of vsd() so score_dataset can render each estimate and
    each GT once and evaluate all est x GT pairs from the cache —
    per-threshold matching (BOP19) needs the full error matrix.
    """

    def visib(d_render):
        valid = d_render > 0
        scene = depth_scene_mm > 0
        return valid & (~scene | (d_render <= depth_scene_mm + delta_mm))

    v_gt = visib(d_gt)
    v_est = visib(d_est) | (v_gt & (d_est > 0))
    union = v_gt | v_est
    n_union = union.sum()
    if n_union == 0:
        return np.ones(len(taus))

    inter = v_gt & v_est
    dist = np.abs(d_gt - d_est)[inter]
    errs = []
    for tau in np.asarray(taus) * diameter_mm:
        n_ok = (dist < tau).sum()
        errs.append(1.0 - n_ok / n_union)
    return np.asarray(errs)


def _match_per_threshold(
    errs: np.ndarray, thresholds: np.ndarray
) -> np.ndarray:
    """BOP19 greedy matching, run independently at every threshold.

    errs: (n_est, n_gt) with estimates pre-sorted by confidence desc.
    At each threshold theta only pairs with error < theta may match;
    each estimate claims its lowest-error unclaimed GT (bop_toolkit
    pose_matching.match_poses).  Returns (T, n_gt) bool: GT matched at
    threshold k.
    """
    n_est, n_gt = errs.shape
    T = len(thresholds)
    matched = np.zeros((T, n_gt), bool)
    for k, th in enumerate(thresholds):
        taken = np.zeros(n_gt, bool)
        for i in range(n_est):
            ok = ~taken & (errs[i] < th)
            if not ok.any():
                continue
            j = int(np.argmin(np.where(ok, errs[i], np.inf)))
            matched[k, j] = True
            taken[j] = True
    return matched


def score_dataset(
    rows: list[dict],
    dataset_dir: str,
    split: str = "test",
    use_vsd: bool = True,
    n_continuous_sym: int | None = None,
    model_sample: int | None = None,
    visib_gt_min: float = 0.1,
    image_width: int | None = None,
) -> dict:
    """Score BOP-format result rows against a BOP-layout dataset.

    rows: dicts with scene_id, im_id, obj_id, score, R (9 floats,
    row-major), t (3 floats, mm) — the format written by
    pipeline/bop_eval.write_bop_csv.

    model_sample: optional cap on MSSD/MSPD model points (None = all
    vertices, the bop_toolkit behavior; subsampling underestimates max
    distances and inflates recall).  image_width: explicit MSPD scale
    override; by default the width is read from the frame's rgb/depth
    image, falling back to 2*cx only when no image exists on disk.

    Returns dict with per-metric recalls and the combined AR.
    """
    models_dir = os.path.join(dataset_dir, "models")
    info = json.load(open(os.path.join(models_dir, "models_info.json")))

    meshes, pts, syms, diam = {}, {}, {}, {}

    def get_obj(obj_id: int):
        if obj_id not in meshes:
            mesh = load_mesh(
                os.path.join(models_dir, f"obj_{obj_id:06d}.ply")
            )
            meta = info.get(str(obj_id), {})
            meshes[obj_id] = mesh
            rng = np.random.RandomState(0)
            v = mesh.vertices
            if model_sample is not None and len(v) > model_sample:
                v = v[rng.choice(len(v), model_sample, replace=False)]
            pts[obj_id] = v
            syms[obj_id] = symmetry_transforms(meta, n_continuous_sym)
            diam[obj_id] = meta.get(
                "diameter", 2.0 * np.linalg.norm(mesh.vertices, axis=1).max()
            )
        return meshes[obj_id], pts[obj_id], syms[obj_id], diam[obj_id]

    _width_cache: dict[tuple, int] = {}

    def frame_width(sdir, im_id, K) -> int:
        """MSPD pixel scale: the true image width from disk; the 2*cx
        principal-point heuristic only as a last resort.  Memoized per
        (scene dir, frame) — multi-object frames hit this once per
        object otherwise."""
        ck = (sdir, im_id)
        if ck in _width_cache:
            return _width_cache[ck]
        w = int(round(2 * K[0, 2]))
        for sub, ext in (
            ("rgb", "png"), ("rgb", "jpg"), ("depth", "png"),
            ("gray", "tif"),
        ):
            p = os.path.join(sdir, sub, f"{im_id:06d}.{ext}")
            if os.path.exists(p):
                w = image_header.image_width(p)
                break
        _width_cache[ck] = w
        return w

    # Group estimates by (scene, im, obj), sorted by score desc.
    groups: dict[tuple, list] = {}
    for r in rows:
        key = (int(r["scene_id"]), int(r["im_id"]), int(r["obj_id"]))
        groups.setdefault(key, []).append(r)
    for key in groups:
        groups[key].sort(key=lambda r: -float(r["score"]))

    # True-positive counts per threshold (x tau for VSD) and valid-GT
    # denominators (VSD counted only on frames with a depth image).
    tp_mssd = np.zeros(len(MSSD_THRESHOLDS))
    tp_mspd = np.zeros(len(MSPD_THRESHOLDS))
    tp_vsd = np.zeros((len(VSD_TAUS), len(VSD_THRESHOLDS)))
    n_valid = 0
    n_valid_vsd = 0
    scene_cache: dict[int, tuple] = {}

    def load_scene(scene_id):
        if scene_id not in scene_cache:
            sdir = os.path.join(dataset_dir, split, f"{scene_id:06d}")
            gt = json.load(open(os.path.join(sdir, "scene_gt.json")))
            cam = json.load(open(os.path.join(sdir, "scene_camera.json")))
            gi_path = os.path.join(sdir, "scene_gt_info.json")
            gt_info = (
                json.load(open(gi_path)) if os.path.exists(gi_path) else {}
            )
            scene_cache[scene_id] = (sdir, gt, cam, gt_info)
        return scene_cache[scene_id]

    # Score EVERY GT annotation in the split (a GT with no estimate is a
    # miss at every threshold — bop_toolkit semantics), not just frames
    # that happen to have estimates.
    frames = set()
    for sdir in sorted(
        glob.glob(os.path.join(dataset_dir, split, "*"))
    ):
        if not os.path.isdir(sdir):
            continue
        scene_id = int(os.path.basename(sdir))
        gt = json.load(open(os.path.join(sdir, "scene_gt.json")))
        for im_id in gt:
            frames.add((scene_id, int(im_id)))
    frames |= {(s, i) for (s, i, _) in groups}
    frames = sorted(frames)
    for scene_id, im_id in frames:
        sdir, gt_all, cam_all, gt_info_all = load_scene(scene_id)
        if str(im_id) not in gt_all:
            continue
        cam = cam_all[str(im_id)]
        K = np.asarray(cam["cam_K"], np.float64).reshape(3, 3)
        depth_mm = None
        if use_vsd:
            dp = os.path.join(sdir, "depth", f"{im_id:06d}.png")
            if os.path.exists(dp):
                depth_mm = read_png(dp).astype(np.float64) * cam.get(
                    "depth_scale", 1.0)

        gts = gt_all[str(im_id)]
        infos = gt_info_all.get(str(im_id), [{}] * len(gts))
        # ALL GT instances per object: sub-visibility GTs stay matchable
        # (they consume estimates) but only valid ones are scored.
        by_obj: dict[int, list] = {}
        for gi, g in enumerate(gts):
            by_obj.setdefault(int(g["obj_id"]), []).append(gi)

        for obj_id, gt_idx in by_obj.items():
            valid = np.array(
                [
                    infos[gi].get("visib_fract", 1.0) >= visib_gt_min
                    for gi in gt_idx
                ],
                bool,
            )
            n_valid += int(valid.sum())
            has_depth = use_vsd and depth_mm is not None
            if has_depth:
                n_valid_vsd += int(valid.sum())
            if not valid.any():
                continue
            mesh, p, S, d = get_obj(obj_id)
            # bop_toolkit n_top = -1: consider the top-k estimates by
            # confidence, k = number of GT instances of the object.
            ests = groups.get((scene_id, im_id, obj_id), [])[: len(gt_idx)]
            if not ests:
                continue
            w = image_width or frame_width(sdir, im_id, K)

            Rg = [
                np.asarray(gts[gi]["cam_R_m2c"], np.float64).reshape(3, 3)
                for gi in gt_idx
            ]
            tg = [
                np.asarray(gts[gi]["cam_t_m2c"], np.float64)
                for gi in gt_idx
            ]
            Re = [
                np.asarray(e["R"], np.float64).reshape(3, 3) for e in ests
            ]
            te = [np.asarray(e["t"], np.float64) for e in ests]

            def err_matrix(fn):
                E = np.full((len(ests), len(gt_idx)), np.inf)
                for i in range(len(ests)):
                    for j in range(len(gt_idx)):
                        E[i, j] = fn(Re[i], te[i], Rg[j], tg[j])
                return E

            E_mssd = err_matrix(lambda a, b, c, e: mssd(a, b, c, e, p, S))
            E_mspd = err_matrix(
                lambda a, b, c, e: mspd(a, b, c, e, p, S, K)
            )

            m = _match_per_threshold(E_mssd, MSSD_THRESHOLDS * d)
            tp_mssd += (m & valid[None]).sum(axis=1)
            m = _match_per_threshold(E_mspd, MSPD_THRESHOLDS * (w / 640.0))
            tp_mspd += (m & valid[None]).sum(axis=1)

            if has_depth:
                # Render each estimate and each GT once; evaluate the
                # full pairwise VSD error matrix from the cache, then
                # match per (tau, threshold) on VSD's own errors.
                hw = depth_mm.shape
                d_est = [
                    _render_depth(mesh, R, t, K, hw)
                    for R, t in zip(Re, te)
                ]
                d_gt = [
                    _render_depth(mesh, R, t, K, hw)
                    for R, t in zip(Rg, tg)
                ]
                E_vsd = np.full(
                    (len(ests), len(gt_idx), len(VSD_TAUS)), np.inf
                )
                for i in range(len(ests)):
                    for j in range(len(gt_idx)):
                        E_vsd[i, j] = vsd_from_depths(
                            d_est[i], d_gt[j], depth_mm, d
                        )
                for ti in range(len(VSD_TAUS)):
                    m = _match_per_threshold(
                        E_vsd[:, :, ti], VSD_THRESHOLDS
                    )
                    tp_vsd[ti] += (m & valid[None]).sum(axis=1)

    out = {}
    out["ar_mssd"] = float(tp_mssd.mean() / n_valid) if n_valid else 0.0
    out["ar_mspd"] = float(tp_mspd.mean() / n_valid) if n_valid else 0.0
    ars = [out["ar_mssd"], out["ar_mspd"]]
    if n_valid_vsd:
        out["ar_vsd"] = float(tp_vsd.mean() / n_valid_vsd)
        ars.append(out["ar_vsd"])
    out["ar"] = float(np.mean(ars))
    out["n_gt"] = n_valid
    return out


def read_bop_csv(path: str) -> list[dict]:
    """Parse the csv written by bop_eval.write_bop_csv."""
    rows = []
    with open(path) as f:
        header = f.readline()
        assert header.startswith("scene_id"), header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            rows.append(
                {
                    "scene_id": int(parts[0]),
                    "im_id": int(parts[1]),
                    "obj_id": int(parts[2]),
                    "score": float(parts[3]),
                    "R": [float(v) for v in parts[4].split()],
                    "t": [float(v) for v in parts[5].split()],
                    "time": float(parts[6]),
                }
            )
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="BOP19 AR scoring (in-repo)")
    p.add_argument("--csv", required=True)
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--no_vsd", action="store_true")
    args = p.parse_args(argv)
    rows = read_bop_csv(args.csv)
    out = score_dataset(
        rows, args.dataset_dir, args.split, use_vsd=not args.no_vsd
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
