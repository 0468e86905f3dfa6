"""Judging the ISM with SAM 2.1 Hiera-L against the plain reference
(`reference/ism/sam2.py`), as `ism_judge` judges SAM's.

The generator keeps a top-K, a greedy NMS and the detector an argmax per
proposal: two correct computations keep different sets.  The check takes
the program's kept masks and choices as given and judges each stage:

* embed: the image embedding (64 x 64 x 256, with no_mem_embed) and the
  high-resolution features feat_s1 (128 x 128 x 64) and feat_s0 (256 x
  256 x 32), the program's (by a wrapper on its `encode`) against the
  reference's, computed in float32 from the frame; the largest of the
  three relative Frobenius errors.
* tokens: the two-way transformer's output tokens (object score, IoU,
  four masks, two prompt tokens) for every grid prompt, the program's
  (a hook) against the reference's, decoded from its own encoding.
* tail_stats: K6's own output, every candidate's stability score and
  box at the 256 x 256 logit grid (the program's, a wrapper on the
  generator's `fused_candidates`) against the reference's from its
  candidate logits (`ref.candidate_stats`), prompt for prompt and mask
  for mask; the larger of the two relative Frobenius errors.  The kept
  masks below are recomputed by the exact tail, so this is the number
  that reads K6 (and its residual form) itself.
* mask_miss: 1 - the best IoU between a kept mask and any of the
  reference's 3072 candidates (every prompt's masks 1-3, resized from the
  256 x 256 grid straight to the frame), counted over the pixels whose
  reference logit lies at least MARGIN x the candidate's RMS logit from
  the threshold; the worst kept mask.  Without the margin (printed as
  mask_miss_plain, no limit) sound bfloat16 runs on an H100 read up to
  0.268 (76 seeds): random weights leave some masks with wide bands of
  logits near the threshold, where a bfloat16 rounding flips the pixel.
* sem, appe, score, pick: DINOv2-L on the program's masks and choices,
  as `ism_judge.scores` computes them.

The control puts the reference in the program's place: SAM 2 and
DINOv2-L in bfloat16 with every Dense product (and the patch embedding)
in float8 e4m3, the scores' float32 products in TF32.

Weights: `weights.draw_state_dict` (the port's init scheme), and three
parameters it would leave zero drawn here so that they move the output:
Hiera's window position table N(0, 0.02) and `no_mem_embed` N(0, 0.02),
as SAM 2 initialises them, and the object-score token N(0, 1), as an
nn.Embedding is.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import ism_judge
from portbench.harness.weights import draw_state_dict
from portbench.reference.ism import sam2 as ref
from portbench.reference.ism.dinov2 import DescriptorModel
from portbench.reference.layers import use_fp8

NUMBERS = ("embed", "tokens", "tail_stats", "mask_miss", "mask_miss_plain",
           "sem", "appe", "score", "pick")
MARGIN = 0.05
DRAWN_HERE = {"image_encoder.trunk.pos_embed_window": 0.02,
              "no_mem_embed": 0.02, "sam_mask_decoder.obj_score_token": 1.0}


def trunk_options(cc: dict) -> dict:
    """The input size and trunk sizes where the config file sets them
    (the benchmark's own CPU tests; the cell keeps Hiera-L's)."""
    return {k: cc[k] for k in ("img_size", "trunk_kwargs") if k in cc}


def draw(module: torch.nn.Module, seed: int, device) -> dict:
    """SAM 2's float32 state dict for `module` (the port's or the
    reference's, on any device, the meta device too)."""
    sd = draw_state_dict(module, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 7919)
    for name, std in DRAWN_HERE.items():
        sd[name] = torch.randn(tuple(sd[name].shape), generator=g,
                               device=device) * std
    return sd


def models(cc: dict, rcfg, device, control: bool = False):
    """The reference SAM 2 and DINOv2 with the benchmark's weights."""
    dtype = torch.bfloat16 if control else torch.float32
    with torch.device(device):
        sam = ref.SAM2(dtype=dtype, device=device, **trunk_options(cc))
        desc = DescriptorModel(rcfg.descriptor, dtype=dtype)
    sam.load_state_dict(draw(sam, cc["weights_seed"], device))
    desc.load_state_dict(draw_state_dict(desc, cc["weights_seed"] + 1,
                                         device))
    sam.eval()
    desc.eval()
    if control:
        use_fp8(sam)
        use_fp8(desc)
    return sam, desc


@torch.no_grad()
def segment(sam, seg, image: np.ndarray) -> dict:
    """The reference's encoding, tokens and candidate logits of a frame."""
    img, mid = ref.prepare(sam, image, seg.segmentor_width_size)
    feats = sam.encode(img[None])
    pts = ref.grid_points(seg.points_per_side, sam.input_size, sam.device)
    logits, tokens = ref.candidate_logits(sam, feats, pts,
                                          seg.points_per_batch)
    stability, boxes = stats(logits, seg, sam.input_size)
    return {**{k: v.float() for k, v in feats.items()}, "tokens": tokens,
            "logits": logits, "stability": stability, "boxes": boxes,
            "mid": mid}


def stats(logits, seg, input_size: int, chunk: int = 256):
    """`ref.candidate_stats` of (K, h, w) logits with the generator's
    threshold and offset, boxes in input coordinates."""
    parts = [ref.candidate_stats(logits[i:i + chunk], seg.mask_threshold,
                                 seg.stability_score_offset,
                                 input_size / logits.shape[-1])
             for i in range(0, len(logits), chunk)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


@torch.no_grad()
def mask_miss(seg_out: dict, masks: np.ndarray, seg, margin: float,
              chunk: int = 128):
    """1 - the best IoU of each kept mask (K, H, W) with any candidate,
    over the pixels whose candidate logit lies at least `margin` times
    the candidate's RMS logit from the threshold (all pixels at 0)."""
    if len(masks) == 0:
        return np.zeros(0)
    dev = seg_out["logits"].device
    H, W = masks.shape[1:]
    P = torch.as_tensor(masks, device=dev).reshape(len(masks), -1).float()
    best = torch.zeros(len(masks), device=dev)
    logits = seg_out["logits"]
    thr = seg.mask_threshold
    for lo in range(0, len(logits), chunk):
        L = ref.upscale_logits(logits[lo:lo + chunk], H, W, *seg_out["mid"])
        L = L.reshape(len(L), -1)
        rms = L.square().mean(1, keepdim=True).sqrt()
        S = ((L - thr).abs() >= margin * rms).float()  # the pixels counted
        R = (L > thr).float() * S
        inter = P @ R.T
        union = P @ S.T + R.sum(1)[None] - inter
        iou = torch.where(union > 0, inter / union.clamp_min(1), 1.0)
        best = torch.maximum(best, iou.amax(1))
    return (1.0 - best).cpu().numpy()


def judge_frame(sam, desc, bank, cfg, frame, prog: dict) -> dict:
    """The numbers of one frame.  prog: the program's "embedding",
    "feat_s1", "feat_s0" (batch 1, channel-last), "tokens" (P, 8, C),
    every candidate's "stability" (3P,) and "boxes" (3P, 4) in input
    coordinates, prompt-major, and its final detections "dets"
    (`ism_serve.dets_dict`)."""
    image, depth, K = frame
    seg = cfg.segmentor
    r = segment(sam, seg, image)
    out = {"embed": max(_rel(prog[k], r[k])
                        for k in ("embedding", "feat_s1", "feat_s0")),
           "tokens": _rel(prog["tokens"], r["tokens"]),
           "tail_stats": max(_rel(prog[k], r[k])
                             for k in ("stability", "boxes"))}
    d = prog["dets"]
    for key, margin in (("mask_miss", MARGIN), ("mask_miss_plain", 0.0)):
        miss = mask_miss(r, d["masks"], seg, margin)
        out[key] = float(miss.max()) if len(miss) else 0.0
    if len(d["masks"]):
        s = ism_judge.scores(desc, bank, cfg, image, depth, K, d)
        dev = s["sem"].device

        def gap(key, mine):
            return float((s[key] - torch.as_tensor(
                mine, device=dev, dtype=torch.float32)).abs().max())

        out["sem"] = gap("sem", d["semantic_score"])
        out["appe"] = gap("appe", d["appe_score"])
        out["score"] = gap("final", d["scores"])
        out["pick"] = float((s["best_sem"] - s["sem"]).max())
    else:
        out.update(sem=0.0, appe=0.0, score=0.0, pick=0.0)
    out["detections"] = len(d["masks"])
    return out


def _rel(got, want) -> float:
    """The relative Frobenius error; 1e9 where the shapes differ (a
    program that makes other tokens or maps; finite, for the JSON line)."""
    if got.shape != want.shape:
        return 1e9
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def worst(per_frame: list[dict]) -> dict:
    return {k: max(d[k] for d in per_frame) for k in NUMBERS}
