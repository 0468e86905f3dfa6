"""Judging the PEM's served poses against the plain reference.

The coarse stage picks one of thousands of sampled hypotheses by argmax,
so two correct computations of it (bfloat16 and float32, or a custom 3x3
SVD and LAPACK's) pick different hypotheses on some instances, and their
final poses then differ by any angle.  The check therefore follows the
program's discrete choice and judges each stage by itself, per instance:

* coarse_attn: the coarse head's last attention map (the program's, taken
  by a forward hook) against the reference's, computed in float32 from
  the same inputs and a template bank the reference builds itself; the
  relative Frobenius error.  This covers the ViT features, the template
  bank, the geometric embedding and the coarse transformer.
* coarse_pick: the reference's hypothesis solve run on the program's
  attention with the same uniforms gives its best hypothesis score; the
  program's coarse pose, scored by the same function, may lie below it by
  this share.
* fine_attn, pose_deg, pose_t, score: the fine stage computed by the
  reference from the program's coarse pose: its attention's relative
  error, the angle between the final rotations, the distance between the
  final translations over the object's radius, and the pose scores'
  difference.
* solve_deg, solve_t, solve_score: the reference's fine pose solve run
  on the program's own fine attention, against the program's final pose
  and score: the last stage by itself.

The control puts the reference in the program's place with its networks
in bfloat16 and every Dense product in float8 e4m3 (`layers.use_fp8`),
the geometry's float32 products in TF32, and the pose solves (the
Procrustes of every hypothesis and of the fine pose, the rescoring and
the inlier distances: elementwise float32 in the port, where TF32 has
nothing to lower) in bfloat16.
"""

from __future__ import annotations

import torch

from portbench.reference.ops.fps import sample_pts_feats
from portbench.reference.pem.matching import (
    _rescore,
    compute_coarse_Rt,
    compute_fine_Rt,
)
from portbench.reference.pem.model import PEM
from portbench.reference.layers import use_fp8
from portbench.harness.precision import tf32
from portbench.harness.weights import draw_state_dict

NUMBERS = ("coarse_attn", "coarse_pick", "fine_attn", "pose_deg", "pose_t",
           "score", "solve_deg", "solve_t", "solve_score")


def reference_model(rcfg, weights_seed: int, device, control: bool = False):
    """The reference PEM with the benchmark's weights: float32, or the
    control's bfloat16 with float8 Dense products."""
    dtype = torch.bfloat16 if control else torch.float32
    with torch.device(device):
        model = PEM(rcfg, dtype=dtype, device=device).eval()
    model.load_state_dict(draw_state_dict(model, weights_seed, device))
    return use_fp8(model) if control else model


@torch.inference_mode()
def bank(model, tem: dict, device) -> dict:
    """The template bank, onboarded by the reference from the arrays."""
    def t(k, dt):
        return torch.as_tensor(tem[k], device=device, dtype=dt)

    pts, feat = model.get_obj_feats(t("tem_rgb", torch.float32),
                                    t("tem_pts", torch.float32),
                                    t("tem_choose", torch.long))
    return model.make_template_bank(pts, feat)


def row(inputs: dict, i: int, device) -> dict:
    """Instance i of a frame's inputs as (1, ...) device tensors."""
    types = {"pts": torch.float32, "rgb": torch.float32,
             "rgb_choose": torch.long, "model_pts": torch.float32}
    return {k: torch.as_tensor(inputs[k][i:i + 1], device=device, dtype=dt)
            for k, dt in types.items()}


@torch.inference_mode()
def coarse_stage(model, bk: dict, r: dict) -> dict:
    """Observed features, FPS, geometric embedding and the coarse head's
    last attention (1, 1+N1, 1+N2) of one instance."""
    cfg = model.cfg
    radius = bk["radius"]
    denom = radius[:, None, None] + 1e-6
    dense_pm = r["pts"] / denom
    dense_fm = model.feature_extraction.get_img_feats(r["rgb"], r["rgb_choose"])
    sparse_pm, sparse_fm, fps_idx_m = sample_pts_feats(
        dense_pm.contiguous(), dense_fm, cfg.coarse_npoint, return_index=True)
    geo_m = model.geo_embedding(model._with_bg(sparse_pm))
    atten = model.coarse_point_matching.attentions(
        sparse_fm, geo_m, bk["sparse_fo"], bk["geo_o"])[-1]
    return {"dense_pm": dense_pm, "dense_fm": dense_fm,
            "sparse_pm": sparse_pm, "fps_idx_m": fps_idx_m, "geo_m": geo_m,
            "atten": atten, "model_n": r["model_pts"] / denom}


@torch.inference_mode()
def coarse_solve(model, st: dict, bk: dict, atten, u,
                 solve_dtype=torch.float32):
    """The hypothesis solve on `atten`: (R, t, best score)."""
    c = model.cfg.coarse_point_matching
    return compute_coarse_Rt(atten, st["sparse_pm"], bk["sparse_po"],
                             st["model_n"], c.nproposal1, c.nproposal2,
                             dist_field=bk["dist_field"], uniforms=u,
                             return_score=True, solve_dtype=solve_dtype)


@torch.inference_mode()
def hypothesis_score(atten, R, t, st: dict):
    """The solve's score of one pose (R (1, 3, 3), t (1, 3)) on `atten`."""
    pred = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    w1 = (torch.argmax(pred[:, 1:, :], dim=2) > 0).to(pred.dtype)
    return _rescore(R[:, None], t[:, None], st["sparse_pm"], st["model_n"],
                    w1, w1.sum(dim=1))[:, 0]


@torch.inference_mode()
def fine_stage(model, st: dict, bk: dict, init_R, init_t,
               solve_dtype=torch.float32):
    """The fine head from a coarse pose: (attention, R, t metric, score)."""
    fpm = model.fine_point_matching
    atten = fpm.attentions(st["dense_pm"], st["dense_fm"], st["geo_m"],
                           st["fps_idx_m"], bk["dense_po_n"], bk["geo_o"],
                           bk["fps_idx_o"], init_R, init_t,
                           f2_init=bk["fine_f2"])[-1]
    R, t, score = compute_fine_Rt(atten, st["dense_pm"], bk["dense_po_n"],
                                  st["model_n"], fpm.cfg.dis_thres,
                                  solve_dtype)
    return atten, R, t * (bk["radius"][:, None] + 1e-6), score


@torch.inference_mode()
def _fine_solve(model, st: dict, bk: dict, atten):
    """The fine pose solve on a given attention: (R, t metric, score)."""
    R, t, score = compute_fine_Rt(atten.float(), st["dense_pm"],
                                  bk["dense_po_n"], st["model_n"],
                                  model.fine_point_matching.cfg.dis_thres)
    return R, t * (bk["radius"][:, None] + 1e-6), score


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def _angle_deg(Ra, Rb) -> float:
    c = ((Ra.double().transpose(-1, -2) @ Rb.double()).diagonal(
        dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return float(torch.rad2deg(torch.arccos(c.clamp(-1.0, 1.0))).max())


def judge_instance(model, bk: dict, r: dict, u, prog: dict) -> dict:
    """The numbers of one instance.  prog holds the program's coarse
    attention (1+N1, 1+N2), init_R (3, 3), init_t (3,), fine attention,
    pred_R, pred_t (metric) and score, on the reference's device."""
    st = coarse_stage(model, bk, r)
    p_att = prog["coarse_atten"][None].float()
    _, _, best = coarse_solve(model, st, bk, p_att, u)
    mine = hypothesis_score(p_att, prog["init_R"][None].float(),
                            prog["init_t"][None].float(), st)
    f_att, R, t, score = fine_stage(model, st, bk, prog["init_R"][None].float(),
                                    prog["init_t"][None].float())
    R_s, t_s, score_s = _fine_solve(model, st, bk, prog["fine_atten"][None])
    radius = float(bk["radius"][0])
    return {
        "coarse_attn": _rel(prog["coarse_atten"], st["atten"][0]),
        "coarse_pick": max(0.0, float((best - mine) / best)),
        "fine_attn": _rel(prog["fine_atten"], f_att[0]),
        "pose_deg": _angle_deg(prog["pred_R"][None], R),
        "pose_t": float((prog["pred_t"].float() - t[0]).norm()) / radius,
        "score": abs(float(prog["score"]) - float(score[0])),
        "solve_deg": _angle_deg(prog["pred_R"][None], R_s),
        "solve_t": float((prog["pred_t"].float() - t_s[0]).norm()) / radius,
        "solve_score": abs(float(prog["score"]) - float(score_s[0])),
    }


def control_instance(cmodel, cbk: dict, r: dict, u) -> dict:
    """What the control, in the program's place, serves for one instance,
    in the form `judge_instance` takes."""
    bf16 = torch.bfloat16
    with tf32(True):
        st = coarse_stage(cmodel, cbk, r)
        R0, t0, _ = coarse_solve(cmodel, st, cbk, st["atten"], u, bf16)
        f_att, R, t, score = fine_stage(cmodel, st, cbk, R0, t0, bf16)
    return {"coarse_atten": st["atten"][0], "init_R": R0[0], "init_t": t0[0],
            "fine_atten": f_att[0], "pred_R": R[0], "pred_t": t[0],
            "score": score[0]}


def worst(per_instance: list[dict]) -> dict:
    """Each number's largest value over the judged instances."""
    return {k: max(d[k] for d in per_instance) for k in NUMBERS}
