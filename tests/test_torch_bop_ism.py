"""The port's ISM sweep over a BOP dataset against the JAX package's.

`run_ism_eval` on the JAX tests' mini_bop frame (tests/test_bop_eval.py),
onboarded from its rendered templates and from train_pbr images
(tests/test_bop_pbr.py's `_make_pbr_dataset`), at the tiny SAM (img 80,
so the 60 x 80 frame is not resized) and DINOv2 of test_torch_ism.py,
their weights carried across, its opened thresholds.  Rows equal in scene_id,
image_id, category_id, bbox and the segmentation's RLE; scores within
1e-4 (test_torch_demo.py's tolerance); descriptors within 1e-5
(test_torch_ism.py's); the onboarded object index mapped to the BOP id;
the `.npz` descriptor cache read back.  The PEM sweep:
test_torch_bop_pem.py.
"""

import json
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from sam6d_tpu.models.ism.detector import ISMDetector as JDetector
from sam6d_tpu.models.ism.dinov2 import DescriptorModel as JDesc
from sam6d_tpu.models.ism.sam.amg import SamAutomaticMaskGenerator as JAMG
from sam6d_tpu.models.ism.sam.model import SAM as JSAM
from sam6d_tpu.pipeline.ism_eval import run_ism_eval as j_ism_eval
from sam6d_tpu_torch.models.ism.detector import ISMDetector as TDetector
from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel as TDesc
from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator as TAMG
from sam6d_tpu_torch.models.ism.sam.model import SAM as TSAM
from sam6d_tpu_torch.params import flax_to_state_dict, sam_state_dict
from sam6d_tpu_torch.pipeline.ism_eval import run_ism_eval as t_ism_eval
from tests.test_bop_eval import mini_bop  # noqa: F401  (the fixture)
from tests.test_bop_pbr import _make_pbr_dataset
from tests.test_torch_ism import (
    TINY_DESC,
    TINY_ENCODER,
    random_variables as ism_variables,
    sam_variables,
    seg_kwargs,
)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import bop_tree  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    """test_torch_ism.py's tiny SAM at img 80, so that mini_bop's 60 x 80
    frame goes in unresized (the port's torch BILINEAR is within a grey
    level of PIL's, test_torch_ism.py), and its tiny DINOv2."""
    jsam = JSAM(model_type="vit_b", img_size=80, encoder_kwargs=TINY_ENCODER)
    jsam.variables = sam_variables(jsam, 0)
    tsam = TSAM("vit_b", 80, encoder_kwargs=TINY_ENCODER, device="cpu")
    tsam.load_state_dict(sam_state_dict(jsam.variables))
    jdesc = JDesc(jc.DescriptorConfig(**TINY_DESC))
    desc_vars = ism_variables(
        jax.eval_shape(jdesc.init, jax.random.PRNGKey(1)), 1)
    tdesc = TDesc(tc.DescriptorConfig(**TINY_DESC))
    tdesc.vit.load_state_dict(flax_to_state_dict(desc_vars))
    return dict(jsam=jsam, tsam=tsam.eval(), jdesc=jdesc,
                desc_vars=desc_vars, tdesc=tdesc.eval())


def detectors(tiny):
    seg = seg_kwargs(None)
    jcfg = jc.ISMConfig(segmentor=jc.SegmentorConfig(**seg),
                        descriptor=jc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    tcfg = tc.ISMConfig(segmentor=tc.SegmentorConfig(**seg),
                        descriptor=tc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    jdet = JDetector(jcfg, JAMG(tiny["jsam"], jcfg.segmentor), tiny["jdesc"],
                     tiny["desc_vars"])
    tdet = TDetector(tcfg, TAMG(tiny["tsam"], tcfg.segmentor), tiny["tdesc"],
                     device="cpu")
    return jdet, tdet


def ism_rows_match(got, want):
    assert len(want) > 0 and len(got) == len(want)

    def by_score(rows):
        return sorted(rows, key=lambda r: -r["score"])

    for g, w in zip(by_score(got), by_score(want)):
        assert g.keys() == w.keys()
        for k in ("scene_id", "image_id", "category_id", "bbox",
                  "segmentation"):
            assert g[k] == w[k], k
        assert abs(g["score"] - w["score"]) <= 1e-4


@pytest.mark.parametrize("onboarding", ["render", "pbr"])
def test_ism_sweep_matches_jax(mini_bop, tiny, onboarding):  # noqa: F811
    ds = mini_bop["dataset_dir"]
    if onboarding == "pbr" and not os.path.isdir(os.path.join(ds,
                                                              "train_pbr")):
        _make_pbr_dataset(ds)
    jdet, tdet = detectors(tiny)
    out = os.path.join(mini_bop["out_dir"], f"ism_{onboarding}")
    want = j_ism_eval(jdet, ds, mini_bop["template_root"], out + "_jax",
                      onboarding=onboarding)
    got = t_ism_eval(tdet, ds, mini_bop["template_root"], out,
                     onboarding=onboarding)
    np.testing.assert_allclose(tdet.ref_data.descriptors,
                               jdet.ref_data.descriptors, atol=1e-5)
    assert tdet.ref_data.descriptors.shape[:2] == (1, 42)
    ism_rows_match(got, want)
    assert all(r["category_id"] == 1 for r in got)
    with open(os.path.join(out, "detection_ism_bop.json")) as f:
        assert json.load(f) == got
    # Again on the same directory: the descriptors come from the .npz.
    assert os.path.exists(os.path.join(out, "ism_descriptors.npz"))
    _, tdet2 = detectors(tiny)
    again = t_ism_eval(tdet2, ds, mini_bop["template_root"], out,
                       onboarding=onboarding)
    assert [dict(r, time=0) for r in again] == [dict(r, time=0) for r in got]


def test_ism_sweep_maps_indices_to_bop_ids(tiny, tmp_path):
    """Two objects (ids 1 and 5): the detector's object index 1 is BOP
    id 5, and an unknown onboarding is refused."""
    root = tmp_path / "lmo"
    bop_tree.write_bop_tree(root, height=64, width=64, n_test=1, n_pbr=2)
    _, tdet = detectors(tiny)
    rows = t_ism_eval(tdet, str(root), None, str(tmp_path / "out"),
                      onboarding="pbr")
    assert rows and {r["category_id"] for r in rows} <= {1, 5}
    assert tdet.ref_data.descriptors.shape[:2] == (2, 42)
    with pytest.raises(ValueError, match="onboarding"):
        t_ism_eval(tdet, str(root), None, str(tmp_path / "o2"),
                   onboarding="blender")
