"""PEM inference runner: template onboarding + batched pose estimation.

Counterpart of `sam6d_tpu/pipeline/pem_runner.py`: the onboarding of
template arrays (with an optional `.npz` cache), the template bank, and
`infer`, which pads each frame's instances to a power-of-two bucket and
runs frames with more than `max_bucket` instances in sequential chunks.
On a mesh (`parallel/mesh.py`) the instances split over its `dp` axis
and the coarse hypotheses over its `hyp` axis (`parallel/
hyp_parallel.py`), every rank returning the whole frame.  Its file end
(`load_params`, `onboard` from a rendered template directory,
`run_file_pipeline`) is the PEM stage of the demo; the weights file is
the port's `.npz` state dict (`params.save_npz`) where the JAX package
reads an orbax directory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.layers import cast_dense_weights
from sam6d_tpu_torch.models.pem.model import PEM
from sam6d_tpu_torch.params import init_random_
from sam6d_tpu_torch.parallel.collectives import all_gather_rows
from sam6d_tpu_torch.parallel.mesh import (
    DP,
    HYP,
    axis_group,
    axis_index,
    axis_size,
    has_axis,
)
from sam6d_tpu_torch.pipeline.pem_data import (
    load_all_templates,
    prepare_test_data,
)
from sam6d_tpu_torch.train.checkpoint import restore_params_tolerant
from sam6d_tpu_torch.utils.timer import count, stage


class PEMRunner:
    def __init__(self, cfg: PEMConfig, state_dict=None, device="cuda",
                 dtype=torch.float32, seed: int = 0,
                 max_bucket: int | None = None, mesh=None):
        """state_dict: the PEM's weights (see `params.py`); None draws
        random weights from `seed` (`params.init_random_`).  `seed` also
        seeds the generator of the coarse hypothesis draws.

        mesh: an optional DeviceMesh (`parallel.make_mesh`), weights and
        template bank replicated on every rank.  With a "dp" axis
        (`mesh.DP`) each bucket is at least the axis's size and splits
        into one slice a rank, the poses gathered back; with a "hyp" axis
        (`mesh.HYP`) the coarse solve spreads its hypothesis budget over
        that axis (`sharded_compute_coarse_Rt`).  Every rank calls
        `infer` with the same frame."""
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
        self.mesh = mesh
        self._split_batch = has_axis(mesh, DP)
        self._split_hyp = has_axis(mesh, HYP)
        self._min_bucket = axis_size(mesh, DP)
        self.tem_pts = None
        self.tem_feat = None
        self.template_bank = None
        self._onboarded_dir = None
        self.requests = 0  # infer calls, numbering their spans

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
        of missing entries (`checkpoint.restore_params_tolerant`; reference
        run_inference_custom_pytorch.py:383-420).  The template bank is
        stale afterwards.  Returns the names that kept their values."""
        misses = restore_params_tolerant(path, self.model)
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
        """The padded batch of a frame of n instances: a power of two
        times the batch axis's size, capped at max(max_bucket, that
        size)."""
        cap = (max(self.max_bucket, self._min_bucket) if self.max_bucket
               else None)
        bucket = self._min_bucket
        while bucket < n and (cap is None or bucket < cap):
            bucket *= 2
        return bucket

    def _coarse_solver(self):
        """The hypothesis-parallel solve on this runner's mesh, or None."""
        if not self._split_hyp:
            return None
        from sam6d_tpu_torch.parallel.hyp_parallel import (
            sharded_compute_coarse_Rt,
        )

        c = self.cfg.coarse_point_matching

        def solve(atten, p1, p2, norm_model, dist_field, uniforms,
                  generator):
            return sharded_compute_coarse_Rt(
                self.mesh, HYP, atten, p1, p2, norm_model,
                n_proposal1=c.nproposal1, n_proposal2=c.nproposal2,
                dist_field=dist_field, uniforms=uniforms,
                generator=generator)

        return solve

    def _rows(self, bucket: int) -> slice:
        """This rank's rows of a padded bucket."""
        if not self._split_batch:
            return slice(0, bucket)
        per = bucket // self._min_bucket
        lo = axis_index(self.mesh, DP) * per
        return slice(lo, lo + per)

    def infer(self, input_data: dict, uniforms=None) -> dict:
        """Pose for every instance in input_data (pts, rgb, rgb_choose,
        model_pts, score: numpy arrays with the instances first).

        uniforms: optional (u1, u2) of shape (bucket, 3 * nproposal1, 1),
        reused by every chunk (as the JAX runner reuses its key); else
        each chunk draws from the runner's generator.  On a mesh with a
        hyp axis they are this rank's, (bucket / dp, 3 * its share of
        nproposal1, 1) (`hyp_parallel.local_budget`), equal across the
        batch axis as the JAX solve's folded key; on a dp-only mesh the
        bucket's, of which each rank takes its rows (one global draw, as
        under the JAX runner's jit), also when they come from the
        generator.

        Returns numpy pred_R (n, 3, 3), pred_t (n, 3), pose_score (n,)
        and score = pose_score * detection score.

        Spans (`utils/timer.stage`): `pem_runner.infer` (its request the
        call's number), and for each chunk `pem_runner.upload` (padding,
        host to device), `pem.forward` and `pem_runner.download` (the
        poses back to the host); counters `pem_runner.rows` and
        `pem_runner.pad_rows`.
        """
        if self.template_bank is None:
            raise RuntimeError("call onboard() or onboard_arrays() first")
        self.requests += 1
        with stage(None, "pem_runner.infer", request=self.requests):
            return self._infer(input_data, uniforms)

    def _infer(self, input_data: dict, uniforms) -> dict:
        n = len(input_data["pts"])
        bucket = self.bucket_for(n)
        rows = self._rows(bucket)
        solver = self._coarse_solver()
        if uniforms is not None:
            with stage(None, "pem_runner.upload"):
                uniforms = tuple(self._tensor(u, torch.float32)
                                 for u in uniforms)
            if solver is None:
                uniforms = tuple(u[rows] for u in uniforms)
        parts = []
        for lo in range(0, n, bucket):
            hi = min(lo + bucket, n)
            pad = bucket - (hi - lo)
            count("pem_runner.rows", hi - lo)
            count("pem_runner.pad_rows", pad)

            def padded(x, dtype=None):
                x = np.asarray(x)[lo:hi]
                if pad:  # pad rows repeat the chunk's first row
                    x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
                return self._tensor(x[rows], dtype)

            u = uniforms
            if u is None and self._split_batch and solver is None:
                shape = (bucket, 3 * self.cfg.coarse_point_matching
                         .nproposal1, 1)
                u = tuple(torch.rand(shape, generator=self.generator,
                                     device=self.device)[rows]
                          for _ in range(2))
            with stage(None, "pem_runner.upload"):
                args = (padded(input_data["pts"], torch.float32),
                        padded(input_data["rgb"], torch.float32),
                        padded(input_data["rgb_choose"], torch.long),
                        padded(input_data["model_pts"], torch.float32))
            with stage(None, "pem.forward"):
                out = self.model.forward_with_bank(
                    *args, self.template_bank, generator=self.generator,
                    uniforms=u, coarse_solver=solver)
            with stage(None, "pem_runner.download"):
                res = [out[k].float() for k in ("pred_R", "pred_t",
                                                "pred_pose_score")]
                if self._split_batch:
                    group = axis_group(self.mesh, DP)
                    res = [all_gather_rows(r, group).flatten(0, 1)
                           for r in res]
                m = hi - lo
                parts.append([r[:m].cpu().numpy() for r in res])
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
