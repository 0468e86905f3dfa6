"""PEM: the two-stage background-token point-matching pose estimator.

Counterpart of `sam6d_tpu/models/pem/model.py`: serving through
`get_obj_feats` (template onboarding), `make_template_bank` (every
template-static quantity, once per object) and `forward_with_bank` (per
request), all under `torch.inference_mode`; training through `forward`
(the JAX `__call__` with `train=True`) and `train_forward` (template
features extracted in the same graph), which record gradients.  Submodule names
follow the JAX parameter tree, so `params.py` carries JAX weights across
by name.
"""

from __future__ import annotations

import torch
from torch import nn

from sam6d_tpu_torch.config import PEMConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.pem.feature_extraction import ViTEncoder
from sam6d_tpu_torch.models.pem.geo_embedding import GeometricStructureEmbedding
from sam6d_tpu_torch.models.pem.matching import (
    CoarsePointMatching,
    FinePointMatching,
)
from sam6d_tpu_torch.ops.distance_field import build_min_dist_field
from sam6d_tpu_torch.ops.fps import sample_pts_feats
from sam6d_tpu_torch.utils.timer import stage

BG_POINT = 100.0  # the bg token's coordinate (reference model:30)


def _radius(po):
    return torch.linalg.vector_norm(po, dim=2).amax(dim=1)


class PEM(nn.Module):
    def __init__(self, cfg: PEMConfig, dtype=torch.float32, device="cuda"):
        """Built on `device` (the card unless the caller asks for the
        CPU), with zero weights: load a state dict or call
        `params.init_random_`."""
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.feature_extraction = ViTEncoder(cfg.feature_extraction,
                                             cfg.fine_npoint, dtype)
        self.geo_embedding = GeometricStructureEmbedding(cfg.geo_embedding,
                                                         dtype)
        self.coarse_point_matching = CoarsePointMatching(
            cfg.coarse_point_matching, dtype)
        self.fine_point_matching = FinePointMatching(
            cfg.fine_point_matching, dtype)
        self.to(resolve_device(device))

    def _with_bg(self, sparse):
        bg = torch.full((sparse.shape[0], 1, 3), BG_POINT,
                        dtype=sparse.dtype, device=sparse.device)
        return torch.cat([bg, sparse], dim=1)

    @torch.inference_mode()
    def get_obj_feats(self, tem_rgb, tem_pts, tem_choose):
        """Template onboarding: per-view ViT features -> FPS'd
        (1, fine_npoint, 3) cloud and (1, fine_npoint, C) features."""
        return self.feature_extraction.get_obj_feats(tem_rgb, tem_pts,
                                                     tem_choose)

    @torch.inference_mode()
    def make_template_bank(self, dense_po, dense_fo):
        """dense_po (1, N, 3) FPS'd template cloud (metric), dense_fo
        (1, N, C) -> dict bank of template-static tensors (leading dim 1).
        The coarse-rescore distance field is built over the template
        cloud."""
        radius = _radius(dense_po)
        denom = radius[:, None, None] + 1e-6
        dense_po_n = dense_po / denom
        sparse_po, sparse_fo, fps_idx_o = sample_pts_feats(
            dense_po_n, dense_fo, self.cfg.coarse_npoint, return_index=True
        )
        geo_o = self.geo_embedding(self._with_bg(sparse_po))
        fpm = self.fine_point_matching
        pe_o = fpm.compute_pe(dense_po_n)
        fine_f2 = fpm.compute_f2_init(dense_fo.to(self.dtype), pe_o)
        return {
            "radius": radius,
            "dense_po_n": dense_po_n,
            "dense_fo": dense_fo,
            "sparse_po": sparse_po,
            "sparse_fo": sparse_fo,
            "fps_idx_o": fps_idx_o,
            "geo_o": geo_o,
            "pe_o": pe_o,
            "fine_f2": fine_f2,
            "dist_field": build_min_dist_field(dense_po_n.float()),
        }

    @torch.inference_mode()
    def forward_with_bank(self, pts, rgb, rgb_choose, model_pts, bank,
                          generator=None, uniforms=None, coarse_solver=None):
        """Per-request forward.

        pts (B, N, 3) observed cloud (metric), rgb (B, S, S, 3),
        rgb_choose (B, N), model_pts (B, M, 3).  uniforms: optional
        (u1, u2), each (B, 3 * nproposal1, 1), for the coarse hypothesis
        draws; else drawn from `generator`.  coarse_solver: optional
        replacement of the coarse hypothesis solve, (atten, p1, p2,
        norm_model, dist_field, uniforms, generator) -> (R, t), e.g. the
        hypothesis-parallel `parallel/hyp_parallel.py` (the JAX
        forward_with_bank's `coarse_solver`).  Spans (`utils/timer.stage`):
        pem.features (ViT-B), pem.sample (K1), pem.geo_embed (K2),
        pem.coarse and pem.fine (their solves inside, `matching.py`).
        """
        B = pts.shape[0]

        def tile(x):
            return x.expand((B,) + x.shape[1:])

        with stage(None, "pem.features"):
            radius = bank["radius"].expand(B)
            dense_pm = pts / (radius[:, None, None] + 1e-6)
            dense_fm = self.feature_extraction.get_img_feats(rgb, rgb_choose)
        with stage(None, "pem.sample"):
            sparse_pm, sparse_fm, fps_idx_m = sample_pts_feats(
                dense_pm.contiguous(), dense_fm, self.cfg.coarse_npoint,
                return_index=True,
            )
        with stage(None, "pem.geo_embed"):
            geo_m = self.geo_embedding(self._with_bg(sparse_pm))
        geo_o = tile(bank["geo_o"])
        with stage(None, "pem.coarse"):
            init_R, init_t, _ = self.coarse_point_matching(
                sparse_pm, sparse_fm, geo_m, tile(bank["sparse_po"]),
                tile(bank["sparse_fo"]), geo_o, radius, model_pts,
                dist_field=bank["dist_field"], uniforms=uniforms,
                generator=generator, solver=coarse_solver,
            )
        with stage(None, "pem.fine"):
            pred_R, pred_t, score, _ = self.fine_point_matching(
                dense_pm, dense_fm, geo_m, fps_idx_m,
                tile(bank["dense_po_n"]), geo_o, tile(bank["fps_idx_o"]),
                radius, model_pts, init_R, init_t,
                f2_init=tile(bank["fine_f2"]),
            )
        return {
            "pred_R": pred_R,
            "pred_t": pred_t,
            "pred_pose_score": score,
            "init_R": init_R,
            "init_t": init_t,
            "radius": radius,
        }

    def forward(self, pts, rgb, rgb_choose, dense_po, dense_fo, gt_r, gt_t,
                generator=None, noise=None):
        """The JAX `PEM.__call__(train=True)`: observed crop and template
        cloud in one pass, without a bank, recording gradients.

        pts (B, N, 3) observed cloud (metric), rgb (B, S, S, 3),
        rgb_choose (B, N), dense_po (B, N, 3) FPS'd template cloud
        (metric), dense_fo (B, N, C), gt_r (B, 3, 3), gt_t (B, 3) metric.
        The observed and template sides run FPS and the geometric
        embedding as one 2B batch.  Returns every block's attention maps
        and the normalised clouds the loss reads; the fine stage starts
        from the perturbed ground truth (draws from `noise`, see
        `aug_pose_noise`, or `generator`).
        """
        dense_pm, dense_fm, dense_po_n, dense_fo_n, radius = (
            self.feature_extraction(pts, rgb, rgb_choose, dense_po, dense_fo))
        B = dense_pm.shape[0]
        both_pts = torch.cat([dense_pm, dense_po_n], dim=0).contiguous()
        both_feats = torch.cat([dense_fm, dense_fo_n.to(dense_fm.dtype)],
                               dim=0)
        sparse_both, sparse_feat_both, fps_idx_both = sample_pts_feats(
            both_pts, both_feats, self.cfg.coarse_npoint, return_index=True)
        geo_both = self.geo_embedding(self._with_bg(sparse_both))
        sparse_pm, sparse_po = sparse_both[:B], sparse_both[B:]
        sparse_fm, sparse_fo = sparse_feat_both[:B], sparse_feat_both[B:]
        fps_idx_m, fps_idx_o = fps_idx_both[:B], fps_idx_both[B:]
        geo_m, geo_o = geo_both[:B], geo_both[B:]
        init_R, init_t, coarse_attens = self.coarse_point_matching(
            sparse_pm, sparse_fm, geo_m, sparse_po, sparse_fo, geo_o, radius,
            None, generator=generator, train=True, gt_r=gt_r,
            gt_t=gt_t / (radius[:, None] + 1e-6), noise=noise,
        )
        pred_R, pred_t, score, fine_attens = self.fine_point_matching(
            dense_pm, dense_fm, geo_m, fps_idx_m, dense_po_n, geo_o,
            fps_idx_o, radius, None, init_R, init_t, f2=dense_fo_n,
            train=True,
        )
        return {
            "pred_R": pred_R,
            "pred_t": pred_t,
            "pred_pose_score": score,
            "init_R": init_R,
            "init_t": init_t,
            "radius": radius,
            "coarse_attens": coarse_attens,
            "fine_attens": fine_attens,
            "sparse_pm": sparse_pm,
            "sparse_po": sparse_po,
            "dense_pm": dense_pm,
            "dense_po": dense_po_n,
        }

    def train_forward(self, pts, rgb, rgb_choose, tem_rgb, tem_pts,
                      tem_choose, gt_r, gt_t, generator=None, noise=None):
        """Training forward with the template features extracted in the
        same graph: tem_rgb (B, T, S, S, 3), tem_pts (B, T, Np, 3) and
        tem_choose (B, T, Np) of T views per sample; their FPS'd union
        (fine_npoint points) is the template cloud and the model cloud."""
        B, T, S = tem_rgb.shape[:3]
        feat = self.feature_extraction.get_img_feats(
            tem_rgb.reshape(B * T, S, S, 3), tem_choose.reshape(B * T, -1))
        feat = feat.reshape(B, -1, feat.shape[-1])
        all_pts = tem_pts.reshape(B, -1, 3).contiguous()
        dense_po, dense_fo = sample_pts_feats(all_pts, feat,
                                              self.cfg.fine_npoint)
        return self(pts, rgb, rgb_choose, dense_po, dense_fo, gt_r, gt_t,
                    generator=generator, noise=noise)
