"""PEM inference runner: template onboarding + batched pose estimation.

Counterpart of `sam6d_tpu/pipeline/pem_runner.py` on one device: the
onboarding of template arrays (with an optional `.npz` cache), the
template bank, and `infer`, which pads each frame's instances to a
power-of-two bucket and runs frames with more than `max_bucket`
instances in sequential chunks.
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
        self.template_bank = self.model.make_template_bank(
            torch.as_tensor(tem_pts, device=self.device),
            torch.as_tensor(tem_feat, device=self.device),
        )
        return self.template_bank

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
            raise RuntimeError("call onboard_arrays() first")
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
