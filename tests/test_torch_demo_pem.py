"""The PEM stage of the port's file demo against the JAX package's.

`PEMRunner.run_file_pipeline` against the JAX runner's on the example
scene, its 96-px rendered templates and its ground-truth detection
(test_torch_demo.py's `scene`), at the tiny PEM config of
test_torch_pem.py with 300 points a template view; the weights bridged
by `flax_to_state_dict` and passed through a `.npz` file
(`PEMRunner.load_params`), the JAX key's hypothesis uniforms injected.
JAX runs op by op (`jax.disable_jit`, for the reason test_torch_pem.py
gives); its first run of each op compiles it, which takes most of this
file's time, so the file stands alone and its eager run goes to another
worker.  Tolerances: `close_poses`' (R and t / radius 2e-3, scores 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from sam6d_tpu.models.pem.model import PEM as JPEM
from sam6d_tpu.pipeline.pem_runner import PEMRunner as JRunner
from sam6d_tpu_torch.params import flax_to_state_dict, save_npz
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner as TRunner
from tests.test_torch_demo import scene  # noqa: F401  (the fixture)
from tests.test_torch_pem import (
    close_poses,
    coarse_uniforms,
    make_inputs,
    random_variables,
    tiny_config,
)

torch.set_num_threads(2)


def test_pem_file_pipeline_matches_jax(scene, tmp_path):
    # 300 points a view keep the eager JAX onboarding short.
    jcfg, tcfg = (dataclasses.replace(tiny_config(c),
                                      n_sample_template_point=300)
                  for c in (jc, tc))
    N, S = jcfg.fine_npoint, jcfg.feature_extraction.img_size
    inst, tem_pts, tem_feat = make_inputs(
        np.random.RandomState(0), 1, N, jcfg.n_sample_model_point, S,
        jcfg.feature_extraction.out_dim)
    example = {k: v for k, v in inst.items() if k != "score"}
    example.update(dense_po=tem_pts, dense_fo=tem_feat)
    variables = random_variables(JPEM(jcfg), example)
    jrun = JRunner(jcfg, variables=variables)
    args = (*scene["files"], scene["cad"], scene["seg"], scene["tdir"])
    with jax.disable_jit():
        want, wimg, wpts = jrun.run_file_pipeline(*args)

    weights = str(tmp_path / "pem.npz")
    save_npz(flax_to_state_dict(variables), weights)
    trun = TRunner(tcfg, device="cpu", seed=7)  # other weights until loaded
    assert trun.load_params(weights) == []
    uniforms = coarse_uniforms(jax.random.PRNGKey(0), 1,
                               tcfg.coarse_point_matching.nproposal1)
    got, gimg, gpts = trun.run_file_pipeline(*args, uniforms=uniforms)
    np.testing.assert_array_equal(gimg, wimg)
    np.testing.assert_array_equal(gpts, wpts)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("scene_id", "image_id", "category_id",
                                  "segmentation")} == \
            {k: w[k] for k in ("scene_id", "image_id", "category_id",
                               "segmentation")}

    def poses(rows):
        return {"pred_R": np.array([r["R"] for r in rows]).reshape(-1, 3, 3),
                "pred_t": np.array([r["t"] for r in rows]) / 1000.0,
                "score": np.array([r["score"] for r in rows])}

    radius = np.asarray(jrun.template_bank["radius"])
    close_poses(poses(got), poses(want), radius, score_key="score")
    # The same directory again reuses the bank; load_params drops it.
    bank = trun.template_bank
    trun.onboard(scene["tdir"])
    assert trun.template_bank is bank
    trun.load_params(weights)
    assert trun.template_bank is None


def test_load_params_is_tolerant_of_missing_entries(tmp_path):
    cfg = tiny_config(tc)
    runner = TRunner(cfg, device="cpu", seed=0)
    state = {k: v.clone() for k, v in runner.model.state_dict().items()}
    other = TRunner(cfg, device="cpu", seed=1).model.state_dict()
    missing = "geo_embedding.proj_d.weight"
    partial = {k: v for k, v in other.items() if k != missing}
    path = str(tmp_path / "partial.npz")
    save_npz(partial, path)
    assert runner.load_params(path) == [missing]
    now = runner.model.state_dict()
    torch.testing.assert_close(now[missing], state[missing], rtol=0, atol=0)
    for k in partial:
        torch.testing.assert_close(now[k], other[k], rtol=0, atol=0)
    # A file of another architecture matches too few entries: refused.
    save_npz({k: v for k, v in list(other.items())[:5]}, path)
    with pytest.raises(ValueError, match="matched only"):
        runner.load_params(path)
