"""Judging the ISM's detections against the plain reference.

SAM's automatic mask generation keeps a top-K of 3072 candidates, then
a greedy NMS, and the detector picks each proposal's object by argmax:
two correct computations keep different sets.  The check therefore takes
the program's kept masks and choices as given and judges each stage by
itself:

* embed: the SAM encoder's image embedding (the program's, taken by a
  forward hook) against the reference's, computed in float32 from the
  frame; the relative Frobenius error.
* tokens: the mask decoder's output tokens for every grid prompt (the
  program's, by a hook on the two-way transformer) against the
  reference's, which it decodes from its own embedding; relative error.
* mask_miss: 1 - the best IoU between a kept mask and any of the
  reference's 3072 candidate masks (every prompt, three outputs,
  upscaled to the frame as the generator does); the worst kept mask.
* sem, appe, score: for each final detection, the reference's DINOv2-L
  descriptors of the program's mask and box (crops cut by the
  reference), against templates it onboards itself: the semantic score
  of the program's object, the appearance score against the program's
  best template, and the final score with the geometric score and the
  visible ratio; the largest absolute difference from the program's.
* pick: how far the semantic score of the program's object lies below
  the reference's best object for the same proposal (0 when they agree).

The control puts the reference in the program's place: SAM and DINOv2-L
in bfloat16 with every Dense product in float8 e4m3, the scores' float32
products in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.weights import draw_state_dict
from portbench.reference.ism import amg, scoring
from portbench.reference.ism.bbox import crop_resize_pad, crop_resize_pad_masks
from portbench.reference.ism.dinov2 import DescriptorModel
from portbench.reference.ism.sam import SAM
from portbench.reference.layers import use_fp8
from portbench.reference.ops.geometry import project_points

NUMBERS = ("embed", "tokens", "mask_miss", "sem", "appe", "score", "pick")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_rgb(images):
    return ((images - images.new_tensor(IMAGENET_MEAN))
            / images.new_tensor(IMAGENET_STD))


def models(cc: dict, rcfg, device, control: bool = False):
    """The reference SAM and DINOv2 with the benchmark's weights."""
    dtype = torch.bfloat16 if control else torch.float32
    with torch.device(device):
        sam = SAM(rcfg.segmentor.model_type, dtype=dtype, device=device,
                  **{k: cc[k] for k in ("img_size", "encoder_kwargs")
                     if k in cc})
        desc = DescriptorModel(rcfg.descriptor, dtype=dtype)
    sam.load_state_dict(draw_state_dict(sam, cc["weights_seed"], device,
                                        rel_pos_std=cc["rel_pos_std"]))
    desc.load_state_dict(draw_state_dict(desc, cc["weights_seed"] + 1,
                                         device))
    sam.eval()
    desc.eval()
    if control:
        use_fp8(sam)
        use_fp8(desc)
    return sam, desc


@torch.no_grad()
def onboard(desc, tem: dict, device) -> dict:
    """Template descriptors: (O, T, D) CLS and (O, T, Np, D) patches."""
    cls_all, patch_all = [], []
    for o in range(tem["images"].shape[0]):
        img = torch.as_tensor(tem["images"][o], device=device)
        m = torch.as_tensor(tem["masks"][o], device=device, dtype=torch.bool)
        cls, patch = desc.compute_cls_and_patch(normalize_rgb(img), m)
        cls_all.append(cls.float())
        patch_all.append(patch.float())
    return {"cls": torch.stack(cls_all), "patch": torch.stack(patch_all),
            "poses": torch.as_tensor(tem["poses"], device=device),
            "pointcloud": torch.as_tensor(tem["pointcloud"], device=device)}


@torch.no_grad()
def segment(sam, seg, image: np.ndarray):
    """The reference's embedding, its decoder tokens for every grid
    prompt and its candidate logits (3P, h, w), with what upscaling
    needs."""
    img, scale, eff, mid = amg.prepare(sam, image, seg.segmentor_width_size)
    emb = sam.encode(img[None])
    pts = amg.grid_points(seg.points_per_side, eff, sam.device)
    logits, tokens = amg.candidate_logits(sam, emb, pts, seg.points_per_batch)
    return {"embedding": emb.float(), "tokens": tokens, "logits": logits,
            "eff": eff, "mid": mid}


@torch.no_grad()
def mask_miss(seg_out: dict, masks: np.ndarray, seg, chunk: int = 128):
    """1 - the best IoU of each kept mask (K, H, W) with any candidate."""
    if len(masks) == 0:
        return np.zeros(0)
    dev = seg_out["logits"].device
    H, W = masks.shape[1:]
    P = torch.as_tensor(masks, device=dev).reshape(len(masks), -1).float()
    area_p = P.sum(1)
    best = torch.zeros(len(masks), device=dev)
    logits = seg_out["logits"]
    for lo in range(0, len(logits), chunk):
        R = amg.upscale_masks(logits[lo:lo + chunk], *seg_out["eff"], H, W,
                              seg.mask_threshold, *seg_out["mid"])
        R = R.reshape(len(R), -1).float()
        inter = P @ R.T
        union = area_p[:, None] + R.sum(1)[None] - inter
        iou = torch.where(union > 0, inter / union.clamp_min(1), 1.0)
        best = torch.maximum(best, iou.amax(1))
    return (1.0 - best).cpu().numpy()


@torch.no_grad()
def scores(desc, bank: dict, cfg, image: np.ndarray, depth, K, dets: dict):
    """The reference's scores of the program's final detections under the
    program's object and template choices: sem, appe, geo, vis, final,
    and the best object's semantic score."""
    dev = bank["cls"].device
    S = cfg.descriptor.image_size
    masks = torch.as_tensor(dets["masks"], device=dev, dtype=torch.bool)
    boxes = torch.as_tensor(dets["boxes"], device=dev, dtype=torch.float32)
    img = torch.as_tensor(image, device=dev, dtype=torch.float32) / 255.0
    crops = crop_resize_pad(img, boxes, S)
    cmask = crop_resize_pad_masks(masks, boxes, S) > 0.5
    cls, patch = desc.compute_cls_and_patch(normalize_rgb(
        crops * cmask[..., None]), cmask)
    cls, patch = cls.float(), patch.float()
    sim = scoring.semantic_similarity_matrix(cls, bank["cls"])
    per_obj = scoring.aggregate_semantic_score(sim, cfg.aggregation_function)
    obj = torch.as_tensor(dets["object_ids"], device=dev, dtype=torch.long)
    tpl = torch.as_tensor(dets["best_template"], device=dev, dtype=torch.long)
    rows = torch.arange(len(obj), device=dev)
    sem = per_obj[rows, obj]
    ref_patch = bank["patch"][obj, tpl]
    appe = scoring.appearance_score(patch, ref_patch)
    vis = scoring.visible_ratio(patch, ref_patch, cfg.visible_thred)
    R = bank["poses"][tpl, :3, :3]
    posed = torch.einsum("qij,qnj->qni", R, bank["pointcloud"][obj])
    d = torch.as_tensor(depth, device=dev, dtype=torch.float32)
    Hh, Ww = d.shape
    ys, xs = torch.meshgrid(torch.arange(Hh, dtype=torch.float32, device=dev),
                            torch.arange(Ww, dtype=torch.float32, device=dev),
                            indexing="ij")
    xmap = (xs - float(K[0, 2])) * d / float(K[0, 0])
    ymap = (ys - float(K[1, 2])) * d / float(K[1, 1])
    flat = (masks & (d > 0)[None]).reshape(len(obj), -1).float()
    cnt = torch.clamp_min(flat.sum(1), 1.0)
    trans = torch.stack([flat @ xmap.reshape(-1), flat @ ymap.reshape(-1),
                         flat @ d.reshape(-1)], -1) / cnt[:, None]
    uv = project_points(posed + trans[:, None, :],
                        torch.as_tensor(K, device=dev, dtype=torch.float32))
    uv = torch.stack([uv[..., 0].clamp(0, Ww - 1),
                      uv[..., 1].clamp(0, Hh - 1)], -1)
    geo = scoring.geometric_score(uv, boxes)
    final = scoring.final_score(sem, appe, geo, vis)
    return {"sem": sem, "appe": appe, "geo": geo, "vis": vis,
            "final": final, "best_sem": per_obj.amax(1)}


def judge_frame(sam, desc, bank, cfg, frame, prog: dict) -> dict:
    """The numbers of one frame.  prog: the program's embedding (1, h, w,
    C), tokens (P, T, C), and final detections {masks, boxes, scores,
    object_ids, semantic_score, appe_score, best_template}."""
    image, depth, K = frame
    seg = cfg.segmentor
    ref = segment(sam, seg, image)
    out = {"embed": _rel(prog["embedding"], ref["embedding"]),
           "tokens": _rel(prog["tokens"], ref["tokens"])}
    d = prog["dets"]
    miss = mask_miss(ref, d["masks"], seg)
    out["mask_miss"] = float(miss.max()) if len(miss) else 0.0
    if len(d["masks"]):
        r = scores(desc, bank, cfg, image, depth, K, d)
        dev = r["sem"].device

        def gap(key, mine):
            return float((r[key] - torch.as_tensor(mine, device=dev,
                                                   dtype=torch.float32))
                         .abs().max())

        out["sem"] = gap("sem", d["semantic_score"])
        out["appe"] = gap("appe", d["appe_score"])
        out["score"] = gap("final", d["scores"])
        out["pick"] = float((r["best_sem"] - r["sem"]).max())
    else:
        out.update(sem=0.0, appe=0.0, score=0.0, pick=0.0)
    out["detections"] = len(d["masks"])
    return out


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def worst(per_frame: list[dict]) -> dict:
    return {k: max(d[k] for d in per_frame) for k in NUMBERS}
