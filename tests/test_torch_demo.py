"""The port's file demo (render -> ISM -> PEM through files) on the CPU.

* The PEM stage from files against the JAX package: test_torch_demo_pem.py
  (a file of its own, so that its eager JAX run goes to another worker).
* The ISM from files: `onboard_objects` + `detect` against the JAX
  package's at the tiny SAM and DINOv2 of test_torch_ism.py with its
  opened thresholds, on a 64 x 64 example scene (a 20 mm cube), so that
  SAM's resize is the identity on both sides.  Tolerances:
  `test_onboard_and_detect_match`'s (descriptors 1e-5; the same number
  of detections, masks agreeing on more than 99.9% of pixels, boxes
  within 3 px, scores 1e-4, the same object ids).
* `demo.main(..., "--device", "cpu")` with the port's configs replaced by
  the tiny ones writes every artifact, and its PEM stage also runs on the
  scene's ground-truth detection.
"""

import dataclasses
import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from chip_smoke import write_gt_detection
from sam6d_tpu.models.ism.detector import ISMDetector as JDetector
from sam6d_tpu.models.ism.dinov2 import DescriptorModel as JDesc
from sam6d_tpu.models.ism.onboarding import onboard_objects as j_onboard
from sam6d_tpu.models.ism.sam.amg import SamAutomaticMaskGenerator as JAMG
from sam6d_tpu.models.ism.sam.model import SAM as JSAM
from sam6d_tpu.utils.mesh import load_mesh
from sam6d_tpu_torch.models.ism.detector import ISMDetector as TDetector
from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel as TDesc
from sam6d_tpu_torch.models.ism.onboarding import onboard_objects as t_onboard
from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator as TAMG
from sam6d_tpu_torch.models.ism.sam.model import SAM as TSAM
from sam6d_tpu_torch.params import flax_to_state_dict, sam_state_dict
from sam6d_tpu_torch.pipeline import demo
from sam6d_tpu_torch.pipeline.make_example import make_cube_mesh, make_example
from sam6d_tpu_torch.pipeline.make_example import write_ply
from sam6d_tpu_torch.pipeline.renderer import render_templates
from sam6d_tpu_torch.utils.png import read_png
from sam6d_tpu_torch.utils.template_poses import (
    get_obj_poses_from_template_level,
)
from tests.test_torch_ism import (
    ATOL,
    TINY_DESC,
    TINY_ENCODER,
    by_score,
    random_variables as ism_variables,
    sam_variables,
    seg_kwargs,
)
from tests.test_torch_pem import tiny_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The example scene (480 x 640, the 60 mm cube), its 96-px
    templates and its ground-truth detection."""
    tmp = tmp_path_factory.mktemp("scene")
    cad = make_example(str(tmp))
    tdir = render_templates(cad, str(tmp), image_size=96)
    seg = str(tmp / "gt_detection.json")
    write_gt_detection(str(tmp), seg)
    return dict(dir=tmp, cad=cad, tdir=tdir, seg=seg,
                files=[str(tmp / n) for n in ("rgb.png", "depth.png",
                                              "camera.json")])


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """A 64 x 64 example scene of a 20 mm cube and its 96-px templates."""
    tmp = tmp_path_factory.mktemp("small")
    cube = make_cube_mesh(20.0)
    cad = str(tmp / "cube20.ply")
    write_ply(cube, cad)
    make_example(str(tmp), cad_path=cad, image_hw=(64, 64))
    return dict(dir=tmp, cad=cad, tdir=render_templates(cad, str(tmp), 96))


def test_ism_file_onboarding_and_detect_match_jax(small_scene):
    jsam = JSAM(model_type="vit_b", img_size=64, encoder_kwargs=TINY_ENCODER)
    jsam.variables = sam_variables(jsam, 0)
    tsam = TSAM("vit_b", 64, encoder_kwargs=TINY_ENCODER, device="cpu")
    tsam.load_state_dict(sam_state_dict(jsam.variables))
    jdesc = JDesc(jc.DescriptorConfig(**TINY_DESC))
    desc_vars = ism_variables(
        jax.eval_shape(jdesc.init, jax.random.PRNGKey(1)), 1)
    tdesc = TDesc(tc.DescriptorConfig(**TINY_DESC))
    tdesc.vit.load_state_dict(flax_to_state_dict(desc_vars))
    seg = seg_kwargs(None)
    jcfg = jc.ISMConfig(segmentor=jc.SegmentorConfig(**seg),
                        descriptor=jc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    tcfg = tc.ISMConfig(segmentor=tc.SegmentorConfig(**seg),
                        descriptor=tc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    jdet = JDetector(jcfg, JAMG(jsam, jcfg.segmentor), jdesc, desc_vars)
    tdet = TDetector(tcfg, TAMG(tsam.eval(), tcfg.segmentor), tdesc.eval(),
                     device="cpu")
    pc = load_mesh(small_scene["cad"]).sample(64, seed=1) / 1000.0
    kw = dict(template_dirs={1: small_scene["tdir"]}, pointclouds={1: pc},
              template_poses=get_obj_poses_from_template_level(level=0))
    assert j_onboard(jdet, **kw) == t_onboard(tdet, **kw) == [1]
    np.testing.assert_allclose(tdet.ref_data.descriptors,
                               jdet.ref_data.descriptors, atol=ATOL)
    np.testing.assert_allclose(tdet.ref_data.appe_descriptors,
                               jdet.ref_data.appe_descriptors, atol=ATOL)

    d = small_scene["dir"]
    image = read_png(str(d / "rgb.png"))
    depth = read_png(str(d / "depth.png")).astype(np.float32) / 1000.0
    with open(d / "camera.json") as f:
        K = np.array(json.load(f)["cam_K"], np.float32).reshape(3, 3)
    want = jdet.detect(image, depth, K)
    got = tdet.detect(image, depth, K)
    assert len(want) > 0 and len(got) == len(want)
    wm, wb, wo = by_score(want.masks, want.boxes, want.scores)
    gm, gb, go = by_score(got.masks, got.boxes, got.scores)
    assert (gm == wm).mean() > 0.999
    np.testing.assert_allclose(gb, wb, atol=3.0)
    np.testing.assert_allclose(got.scores[go], want.scores[wo], atol=1e-4)
    np.testing.assert_array_equal(got.object_ids[go], want.object_ids[wo])
    assert got.to_bop23(0, 0)[0].keys() == want.to_bop23(0, 0)[0].keys()


def tiny_ism_config():
    seg = tc.SegmentorConfig(**seg_kwargs(None))
    return tc.ISMConfig(segmentor=seg,
                        descriptor=tc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0, compute_dtype="float32",
                        pointcloud_sample_num=64)


def test_demo_main_on_the_cpu_writes_every_artifact(scene, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(demo, "default_ism_config", tiny_ism_config)
    monkeypatch.setattr(demo, "default_pem_config",
                        lambda: dataclasses.replace(
                            tiny_config(tc), n_sample_template_point=500))
    monkeypatch.setattr(demo, "SAM", functools.partial(
        TSAM, img_size=64, encoder_kwargs=TINY_ENCODER))
    d, out = scene["dir"], tmp_path / "out"
    args = ["--cad_path", scene["cad"], "--rgb_path", str(d / "rgb.png"),
            "--depth_path", str(d / "depth.png"),
            "--cam_path", str(d / "camera.json"), "--output_dir", str(out),
            "--template_size", "96", "--det_score_thresh", "-1",
            "--device", "cpu"]
    report = demo.main(args)
    assert list(report) == [
        "render_templates", "ism_model_init", "ism_onboarding", "ism_detect",
        "ism_serialize", "pem_model_init", "pem_onboarding", "pem_forward",
        "pem_serialize"]
    tdir = out / "templates"
    for i in range(42):
        assert (read_png(str(tdir / f"mask_{i}.png")) == 255).any()
        assert read_png(str(tdir / f"rgb_{i}.png")).shape == (96, 96, 3)
        assert np.load(tdir / f"xyz_{i}.npy").shape == (96, 96, 3)
    assert (tdir / "descriptors.npz").exists()
    ism = json.loads((out / "detection_ism.json").read_text())
    assert ism and all(0.0 <= r["score"] <= 1.0 for r in ism)
    assert all(r["segmentation"]["size"] == [480, 640] for r in ism)
    pem = json.loads((out / "detection_pem.json").read_text())
    assert len(pem) >= 1
    assert read_png(str(out / "vis_pem.png")).shape == (480, 640, 3)

    # The PEM stage alone, on the scene's own object.
    shutil.copy(scene["seg"], out / "detection_ism.json")
    demo.main(args[:-4] + ["--stages", "pem", "--device", "cpu"])
    pem = json.loads((out / "detection_pem.json").read_text())
    assert len(pem) == 1
    R = np.array(pem[0]["R"]).reshape(3, 3)
    assert abs(np.linalg.det(R) - 1.0) < 1e-2
    assert np.isfinite(pem[0]["t"]).all()


def test_demo_refuses_fastsam(scene, tmp_path):
    with pytest.raises(NotImplementedError, match="B6"):
        demo.main(["--cad_path", scene["cad"], "--rgb_path", "x",
                   "--depth_path", "x", "--cam_path", "x",
                   "--output_dir", str(tmp_path), "--stages", "ism",
                   "--segmentor_model", "fastsam", "--device", "cpu"])
    assert not os.listdir(tmp_path)
