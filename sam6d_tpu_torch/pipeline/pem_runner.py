"""PEM inference runner: template onboarding + batched pose estimation.

Counterpart of `sam6d_tpu/pipeline/pem_runner.py` on one device: the
onboarding of template arrays (with an optional `.npz` cache), the
template bank, and `infer`, which pads each frame's instances to a
power-of-two bucket and runs frames with more than `max_bucket`
instances in sequential chunks.  Its file end (`load_params`, `onboard`
from a rendered template directory, `run_file_pipeline`) is the PEM
stage of the demo; the weights file is the port's `.npz` state dict
(`params.save_npz`) where the JAX package reads an orbax directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.layers import cast_dense_weights
from sam6d_tpu_torch.models.pem.model import PEM
from sam6d_tpu_torch.params import init_random_, load_npz_tolerant
from sam6d_tpu_torch.pipeline.pem_data import (
    load_all_templates,
    prepare_test_data,
)


class PEMRunner:
    def __init__(self, cfg: PEMConfig, state_dict=None, device="cuda",
                 dtype=torch.float32, seed: int = 0,
                 max_bucket: int | None = None):
        """state_dict: the PEM's weights (see `params.py`); None draws
        random weights from `seed` (`params.init_random_`).  `seed` also
        seeds the generator of the coarse hypothesis draws."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = PEM(cfg, dtype=dtype, device=self.device).eval()
        if state_dict is None:
            init_random_(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict)
        cast_dense_weights(self.model)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.max_bucket = max_bucket
        self.tem_pts = None
        self.tem_feat = None
        self.template_bank = None
        self._onboarded_dir = None

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def onboard_arrays(self, tem_rgb, tem_pts, tem_choose,
                       cache_path: str | None = None):
        """Template views (T, S, S, 3), (T, Np, 3), (T, Np) -> FPS'd
        template cloud and features, then the template bank.  With
        `cache_path`, an existing `.npz` (pts, feat) replaces the feature
        extraction, and a fresh extraction is saved there."""
        if cache_path and os.path.exists(cache_path):
            data = np.load(cache_path)
            self.tem_pts = self._tensor(data["pts"], torch.float32)
            self.tem_feat = self._tensor(data["feat"])
        else:
            self.tem_pts, self.tem_feat = self.model.get_obj_feats(
                self._tensor(tem_rgb, torch.float32),
                self._tensor(tem_pts, torch.float32),
                self._tensor(tem_choose, torch.long),
            )
            if cache_path:
                os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
                np.savez(cache_path, pts=self.tem_pts.cpu().numpy(),
                         feat=self.tem_feat.float().cpu().numpy())
        self.make_template_bank(self.tem_pts, self.tem_feat)

    def make_template_bank(self, tem_pts, tem_feat):
        self._onboarded_dir = None
        self.template_bank = self.model.make_template_bank(
            torch.as_tensor(tem_pts, device=self.device),
            torch.as_tensor(tem_feat, device=self.device),
        )
        return self.template_bank

    def load_params(self, path: str) -> list[str]:
        """Weights from a `.npz` state dict (`params.save_npz`), tolerant
        of missing entries (`params.load_npz_tolerant`; reference
        run_inference_custom_pytorch.py:383-420).  The template bank is
        stale afterwards.  Returns the names that kept their values."""
        misses = load_npz_tolerant(self.model, path)
        self.template_bank = None
        self._onboarded_dir = None
        return misses

    def onboard(self, template_dir: str, cache_path: str | None = None):
        """Template bank from a rendered template directory (reference
        feature_extraction.get_obj_feats with the caching of detector.py:
        76-128).  The object onboarded last is kept: onboarding the same
        directory again does nothing, as in a per-frame file loop."""
        if (self._onboarded_dir == template_dir
                and self.template_bank is not None):
            return
        if cache_path and os.path.exists(cache_path):
            self.onboard_arrays(None, None, None, cache_path=cache_path)
        else:
            rgbs, chooses, xyzs = load_all_templates(template_dir, self.cfg)
            self.onboard_arrays(rgbs, xyzs, chooses, cache_path=cache_path)
        self._onboarded_dir = template_dir

    def bucket_for(self, n: int) -> int:
        bucket = 1
        while bucket < n and (not self.max_bucket
                              or bucket < self.max_bucket):
            bucket *= 2
        return bucket

    def infer(self, input_data: dict, uniforms=None) -> dict:
        """Pose for every instance in input_data (pts, rgb, rgb_choose,
        model_pts, score: numpy arrays with the instances first).

        uniforms: optional (u1, u2) of shape (bucket, 3 * nproposal1, 1),
        reused by every chunk (as the JAX runner reuses its key); else
        each chunk draws from the runner's generator.

        Returns numpy pred_R (n, 3, 3), pred_t (n, 3), pose_score (n,)
        and score = pose_score * detection score.
        """
        if self.template_bank is None:
            raise RuntimeError("call onboard() or onboard_arrays() first")
        n = len(input_data["pts"])
        bucket = self.bucket_for(n)
        if uniforms is not None:
            uniforms = tuple(self._tensor(u, torch.float32) for u in uniforms)
        parts = []
        for lo in range(0, n, bucket):
            hi = min(lo + bucket, n)
            pad = bucket - (hi - lo)

            def padded(x, dtype=None):
                x = np.asarray(x)[lo:hi]
                if pad:  # pad rows repeat the chunk's first row
                    x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
                return self._tensor(x, dtype)

            out = self.model.forward_with_bank(
                padded(input_data["pts"], torch.float32),
                padded(input_data["rgb"], torch.float32),
                padded(input_data["rgb_choose"], torch.long),
                padded(input_data["model_pts"], torch.float32),
                self.template_bank, generator=self.generator,
                uniforms=uniforms,
            )
            m = hi - lo
            parts.append([out[k][:m].float().cpu().numpy()
                          for k in ("pred_R", "pred_t", "pred_pose_score")])
        pred_R, pred_t, pose_score = (np.concatenate(p) for p in zip(*parts))
        return {
            "pred_R": pred_R,
            "pred_t": pred_t,
            "pose_score": pose_score,
            "score": pose_score * np.asarray(input_data["score"]),
        }

    def run_file_pipeline(self, rgb_path: str, depth_path: str,
                          cam_path: str, cad_path: str, seg_path: str,
                          template_dir: str, det_score_thresh: float = 0.2,
                          uniforms=None):
        """The PEM stage of the demo on one frame's files: onboard the
        templates, read the ISM's detections, pose each kept instance.

        Returns (BOP rows: R flattened, t in mm, score = pose score x
        detection score, the detection's segmentation passed through;
        the RGB frame; the model points in metres).  `uniforms` goes to
        `infer`."""
        self.onboard(template_dir)
        input_data, img, _, model_points, dets = prepare_test_data(
            rgb_path, depth_path, cam_path, cad_path, seg_path, self.cfg,
            det_score_thresh)
        if input_data is None:
            return [], img, model_points
        out = self.infer(input_data, uniforms=uniforms)
        results = []
        for i, det in enumerate(dets):
            results.append({
                "scene_id": det.get("scene_id", 0),
                "image_id": det.get("image_id", 0),
                "category_id": det.get("category_id", 1),
                "score": float(out["score"][i]),
                "R": out["pred_R"][i].reshape(-1).tolist(),
                "t": (out["pred_t"][i] * 1000.0).tolist(),  # BOP: mm
                "segmentation": det.get("segmentation"),
            })
        return results, img, model_points
