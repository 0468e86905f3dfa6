"""End-to-end demo: render templates -> ISM -> PEM on one RGB-D frame.

Counterpart of `sam6d_tpu/pipeline/demo.py` (reference demo.sh /
ov_demo.sh): three stages that communicate through files (templates/,
detection_ism.json, detection_pem.json), so each stage's artifacts are
interchangeable with the JAX demo's and the reference's; the PEM stage
can consume a reference detection_ism.json.

Usage:
  python -m sam6d_tpu_torch.pipeline.demo \\
      --cad_path obj.ply --rgb_path rgb.png --depth_path depth.png \\
      --cam_path camera.json --output_dir out [--stages render,ism,pem] \\
      [--device cuda|cpu]

The ISM's segmentor is SAM's automatic mask generator, SAM 2.1 Hiera-L
under the same generator with `--segmentor_model sam2` (its
`SegmentorConfig.model_type` "sam2.1_hiera_l", `models/ism/sam2/`), or
FastSAM with `--segmentor_model fastsam` (`cfg.fastsam`: FastSAM-x at
640 px).
Weights are drawn at random from fixed seeds unless `--sam_params`,
`--fastsam_params`, `--dinov2_params` or `--pem_params` give the port's
`.npz` state dicts: `python -m sam6d_tpu_torch.convert_weights` writes
them from the released checkpoints (or `params.save_npz` of a bridged
JAX variable tree).  FastSAM's load is strict; the others are tolerant
(`train.checkpoint.restore_params_tolerant`), as in the JAX demo.  The
ISM runs in the config's compute dtype (bfloat16) and FastSAM in
float32, the PEM in float32, as in the JAX demo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from sam6d_tpu_torch.config import default_ism_config, default_pem_config
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.ism.fastsam import FastSAM
from sam6d_tpu_torch.models.ism.sam.model import SAM
from sam6d_tpu_torch.models.ism.sam2.model import SAM2
from sam6d_tpu_torch.utils.timer import StageTimer

SAM2_MODEL = "sam2.1_hiera_l"


def run_render(args, timer: StageTimer):
    from sam6d_tpu_torch.pipeline.renderer import render_templates

    with timer.stage("render_templates"):
        render_templates(args.cad_path, args.output_dir,
                         image_size=args.template_size)


def run_ism(args, timer: StageTimer):
    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.onboarding import onboard_objects
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.pipeline.pem_data import read_depth
    from sam6d_tpu_torch.train.checkpoint import (
        restore_params,
        restore_params_tolerant,
    )
    from sam6d_tpu_torch.utils.detections import save_json_bop23
    from sam6d_tpu_torch.utils.mesh import load_mesh
    from sam6d_tpu_torch.utils.png import read_png
    from sam6d_tpu_torch.utils.template_poses import (
        get_obj_poses_from_template_level,
    )

    cfg = default_ism_config()
    dev = args.device
    dtype = getattr(torch, cfg.compute_dtype)
    with timer.stage("ism_model_init"):
        if args.segmentor_model == "fastsam":
            f = cfg.fastsam
            segmentor = FastSAM(img_size=f.img_size, conf=f.conf_threshold,
                                iou=f.iou_threshold, max_det=f.max_det,
                                scale=f.scale, device=dev)
            init_random_(segmentor.net, torch.Generator().manual_seed(0))
            if args.fastsam_params:
                restore_params(args.fastsam_params, segmentor.net)
        else:
            seg = cfg.segmentor
            if args.segmentor_model == "sam2":
                seg = dataclasses.replace(seg, model_type=SAM2_MODEL)
                sam = SAM2(seg.model_type, dtype=dtype, device=dev)
            else:
                sam = SAM(seg.model_type, dtype=dtype, device=dev)
            init_random_(sam, torch.Generator().manual_seed(0))
            if args.sam_params:
                restore_params_tolerant(args.sam_params, sam)
            segmentor = SamAutomaticMaskGenerator(
                cast_dense_weights(sam.eval()), seg)
        descriptor = DescriptorModel(cfg.descriptor, dtype=dtype).to(dev)
        init_random_(descriptor, torch.Generator().manual_seed(1))
        if args.dinov2_params:
            restore_params_tolerant(args.dinov2_params, descriptor.vit)
        detector = ISMDetector(cfg, segmentor,
                               cast_dense_weights(descriptor.eval()),
                               device=dev)

    with timer.stage("ism_onboarding"):
        # The descriptors' inputs are the rendered template PNGs
        # (reference run_inference_custom.py:129-163).
        tdir = os.path.join(args.output_dir, "templates")
        pc = load_mesh(args.cad_path).sample(cfg.pointcloud_sample_num,
                                             seed=1) / 1000.0
        onboard_objects(
            detector, {1: tdir}, pointclouds={1: pc},
            template_poses=get_obj_poses_from_template_level(level=0),
            n_views=default_pem_config().n_template_view,
            cache_path=os.path.join(tdir, "descriptors.npz"))

    with timer.stage("ism_detect"):
        image = read_png(args.rgb_path)[..., :3]
        with open(args.cam_path) as f:
            cam = json.load(f)
        K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
        dets = detector.detect(image, read_depth(args.depth_path, cam), K)

    with timer.stage("ism_serialize"):
        save_json_bop23(os.path.join(args.output_dir, "detection_ism.json"),
                        dets.to_bop23(scene_id=0, image_id=0))
    print(f"[ISM] {len(dets)} detections")


def run_pem(args, timer: StageTimer):
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
    from sam6d_tpu_torch.utils.draw import draw_detections, save_image

    with timer.stage("pem_model_init"):
        runner = PEMRunner(default_pem_config(), device=args.device)
        if args.pem_params:
            runner.load_params(args.pem_params)

    tdir = os.path.join(args.output_dir, "templates")
    with timer.stage("pem_onboarding"):
        runner.onboard(tdir)
    with timer.stage("pem_forward"):
        results, img, model_points = runner.run_file_pipeline(
            args.rgb_path, args.depth_path, args.cam_path, args.cad_path,
            os.path.join(args.output_dir, "detection_ism.json"), tdir,
            det_score_thresh=args.det_score_thresh)
    with timer.stage("pem_serialize"):
        with open(os.path.join(args.output_dir, "detection_pem.json"),
                  "w") as f:
            json.dump(results, f)
        if results:
            with open(args.cam_path) as f:
                cam = json.load(f)
            K = np.array(cam["cam_K"], np.float32).reshape(3, 3)
            R = np.array([r["R"] for r in results]).reshape(-1, 3, 3)
            t = np.array([r["t"] for r in results]) / 1000.0
            save_image(os.path.join(args.output_dir, "vis_pem.png"),
                       draw_detections(img, R, t, model_points, K))
    print(f"[PEM] {len(results)} poses")


def main(argv=None) -> dict:
    """Runs the stages; returns the `StageTimer` report: the wall time of
    each stage in ms (each stage waits for its device work)."""
    p = argparse.ArgumentParser(description="SAM-6D demo (PyTorch port)")
    p.add_argument("--cad_path", required=True)
    p.add_argument("--rgb_path", required=True)
    p.add_argument("--depth_path", required=True)
    p.add_argument("--cam_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--stages", default="render,ism,pem")
    p.add_argument("--segmentor_model", default="sam",
                   choices=["sam", "sam2", "fastsam"])
    p.add_argument("--fastsam_params", default="",
                   help=".npz state dict of FastSAM (convert_weights "
                        "--kind fastsam), loaded strictly")
    p.add_argument("--pem_params", default="",
                   help=".npz state dict of the PEM (convert_weights "
                        "--kind pem)")
    p.add_argument("--sam_params", default="",
                   help=".npz state dict of SAM (convert_weights --kind "
                        "sam), or of SAM 2 in the port's layout with "
                        "--segmentor_model sam2")
    p.add_argument("--dinov2_params", default="",
                   help=".npz state dict of the DINOv2 ViT (convert_weights "
                        "--kind dinov2)")
    p.add_argument("--det_score_thresh", type=float, default=0.2)
    p.add_argument("--template_size", type=int, default=420)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    stages = args.stages.split(",")
    args.device = resolve_device(args.device)

    os.makedirs(args.output_dir, exist_ok=True)
    timer = StageTimer(args.device, sync=True)
    if "render" in stages:
        run_render(args, timer)
    if "ism" in stages:
        run_ism(args, timer)
    if "pem" in stages:
        run_pem(args, timer)
    report = timer.report()
    for name, ms in report.items():
        print(f"[timer] {name}: {ms:.1f} ms")
    return report


if __name__ == "__main__":
    main()
