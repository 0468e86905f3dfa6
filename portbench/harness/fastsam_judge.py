"""Judging the FastSAM ISM's proposals and detections against the plain
reference.

FastSAM keeps the 4 max_det best anchors by score, then a greedy NMS on
the host and max_det; the detector picks each proposal's object by
argmax: two correct computations keep different sets.  The check takes
the program's choices as given and judges each stage by itself, in
float32 with TF32 off, on the frames a run checks:

* head: the program's network outputs at every anchor (box logits,
  class logits, mask coefficients) and its prototypes, taken by a
  forward hook on `net`, against the reference network's on the same
  input; the largest of the four relative (Frobenius) errors.  The
  program's input itself (its resize and padding of the frame) is held
  within one grey level of the reference's, else the frame is not
  judged.
* box_px: each of the program's proposals against the reference's box
  at the same anchor, in frame pixels (both clipped to the frame); the
  largest error.
* mask_px: for each anchor the program kept (its 4 max_det best by its
  own scores, and its NMS replayed on its own candidate boxes and
  scores, which gives its keep exactly), the share of pixels in which
  the program's mask and the reference's differ, over the pixels either
  sets, within the program's box.  Pixels whose reference probability
  lies within MARGIN of 0.5 are left out: the two sides round the 32-
  term products, the convolutions before them (another algorithm and
  layout; the head's relative error is about 1e-4 on the H100) and the
  two resize products differently, so such a pixel is decided by
  rounding (on the H100 at most 0.18% of a mask's pixels still differ
  past the margin in sound runs, PERF.md).  A kept anchor whose proposal
  is missing counts 1 if the reference's mask has a pixel above 0.5 +
  MARGIN (the program may drop only empty masks), and so does a frame
  whose proposals the detector's size filter keeps in another number
  than reached the descriptor.
* sem, appe, score, pick: DINOv2-L on the program's final detections,
  as `ism_judge.scores` computes them.

The control puts the reference in the program's place: FastSAM with its
convolutions' operands rounded to TF32 and TF32 products elsewhere
(PyTorch's default on the card, one step below float32), DINOv2-L in
bfloat16 with float8 Dense products (`ism_judge`'s).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import ism_judge, ism_traffic
from portbench.harness.weights import draw_state_dict
from portbench.reference.ism import fastsam as ref
from portbench.reference.ism.dinov2 import DescriptorModel
from portbench.reference.layers import use_fp8

NUMBERS = ("head", "box_px", "mask_px", "sem", "appe", "score", "pick")
MARGIN = 1e-3
CALIBRATION_FRAMES = 4


def scale_of(cc: dict) -> tuple:
    """(depth, width, max_channels) of the configuration's FastSAM."""
    s = cc["fastsam_scale"]
    return s["depth"], s["width"], s["max_channels"]


def network(cc: dict, device, control: bool = False) -> ref.YOLOv8Seg:
    """The reference FastSAM network with the benchmark's weights."""
    net = weights(cc, device)[1]
    return ref.use_tf32(net) if control else net


def weights(cc: dict, device) -> tuple[dict, ref.YOLOv8Seg]:
    """The program's FastSAM state dict (the JAX layout) from
    weights_seed: LeCun-normal kernels, zero biases, unit BatchNorm
    scales (`weights.draw_state_dict`), and each BatchNorm's running mean
    and variance those of its input over CALIBRATION_FRAMES synthetic
    frames drawn from weights_seed (`calibrate`), as a trained network's statistics follow
    its activations.  Also the calibrated reference network."""
    with torch.device("meta"):
        meta = ref.YOLOv8Seg(*scale_of(cc))
    layout = ref.FlaxLayout(meta)
    state = draw_state_dict(layout, cc["weights_seed"], device)
    with torch.device(device):
        net = ref.YOLOv8Seg(*scale_of(cc))
    ref.load_flax(net, state).eval()
    rng = np.random.default_rng(cc["weights_seed"])
    S = cc["ism"]["fastsam"]["img_size"]
    calibrate(net, torch.cat([ref.prepare(ism_traffic.synthetic_scene(rng)[0],
                                          S, device)[0]
                              for _ in range(CALIBRATION_FRAMES)]))
    return ref.flax_state_dict(net, layout), net


@torch.no_grad()
def calibrate(net: ref.YOLOv8Seg, x: torch.Tensor) -> None:
    """Set each BatchNorm's running statistics, in the order the forward
    reaches them, to the mean and (biased) variance of its input over x,
    in float32, so that every normalised activation has zero mean and
    unit variance on x.  With identity statistics the LeCun-normal
    network's activations shrink about fourfold a layer, and its mask
    logits come out near 1e-7, whose sigmoid rounds to 0.5 in float32."""
    def hook(bn, inp):
        v = inp[0].double()
        bn.running_mean.copy_(v.mean((0, 2, 3)).float())
        bn.running_var.copy_(v.var((0, 2, 3), unbiased=False).float())

    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, ref.BatchNorm)]
    try:
        net(x)
    finally:
        for h in hooks:
            h.remove()


def descriptor(cc: dict, rcfg, device, control: bool = False):
    """The reference DINOv2 with the benchmark's weights (weights_seed +
    1), float32, or bfloat16 with float8 Dense products for the control."""
    dtype = torch.bfloat16 if control else torch.float32
    with torch.device(device):
        desc = DescriptorModel(rcfg.descriptor, dtype=dtype)
    desc.load_state_dict(draw_state_dict(desc, cc["weights_seed"] + 1,
                                         device))
    desc.eval()
    return use_fp8(desc) if control else desc


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _groups(outs, proto) -> list:
    """(box logits, class logits, mask coefficients) over every anchor,
    level after level, and the prototypes."""
    flat = [torch.cat([o[k].reshape(-1) for o in outs]) for k in range(3)]
    return flat + [proto.reshape(-1)]


def _clip(boxes: np.ndarray, H: int, W: int) -> np.ndarray:
    out = boxes.astype(np.float32).copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, W - 1)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, H - 1)
    return out


def sized(masks: np.ndarray, boxes: np.ndarray, cfg) -> int:
    """How many proposals the detector's size filter keeps (its rule,
    reference model/utils.py:96-105)."""
    if len(masks) == 0:
        return 0
    H, W = masks.shape[1:]
    area = masks.reshape(len(masks), -1).sum(-1)
    return int(np.sum((boxes[:, 2] - boxes[:, 0] > cfg.min_box_size * W)
                      & (boxes[:, 3] - boxes[:, 1] > cfg.min_box_size * H)
                      & (area > cfg.min_mask_size * H * W)))


@torch.no_grad()
def proposals(net, cfg, frame, prog: dict) -> dict:
    """head, box_px, mask_px of one frame.  prog: the program's network
    input (1, S, S, 3), outputs and prototypes, its candidates' boxes and
    scores (its top 4 max_det), its proposals {masks, boxes}, and how
    many of them reached the descriptor ("sized")."""
    fcfg = cfg.fastsam
    image = frame[0]
    H, W = image.shape[:2]
    S = fcfg.img_size
    x_ref, scale, (eh, ew) = ref.prepare(image, S, prog["input"].device)
    if float((x_ref - prog["input"]).abs().max()) > 1.5 / 255:
        raise ValueError("the program's input is not the frame's")
    outs, proto = net(prog["input"].float())
    head = max(_rel(g, w) for g, w in zip(
        _groups(prog["outs"], prog["proto"]), _groups(outs, proto)))
    boxes_r, _, coefs_r = ref.decode(outs, S)

    # The program's choices: its best anchors by its own scores, then its
    # NMS on its own candidates, replayed.
    conf_p = torch.cat([torch.sigmoid(o[1].reshape(-1)) for o in
                        prog["outs"]])
    best = ref.top_k(conf_p, 4 * fcfg.max_det)
    cand_b = prog["cand_boxes"].cpu().numpy()
    cand_s = prog["cand_conf"].cpu().numpy()
    if not np.array_equal(conf_p[best].cpu().numpy(), cand_s):
        raise ValueError("the program's candidates are not its best anchors")
    above = np.flatnonzero(cand_s > fcfg.conf_threshold)
    keep = above[ref.greedy_nms(cand_b[above], cand_s[above],
                                fcfg.iou_threshold)[:fcfg.max_det]]
    anchors = best.cpu().numpy()[keep]
    p_boxes = _clip(cand_b[keep] / scale, H, W)

    dev = prog["input"].device
    idx = torch.from_numpy(anchors).to(dev)
    prob = ref.mask_probabilities(coefs_r[0][idx], proto[0], eh, ew, H, W)
    region = ref.inside_boxes(torch.from_numpy(cand_b[keep] / scale).to(dev),
                              H, W)
    sure_on = (prob > 0.5 + MARGIN) & region
    sure_off = (prob < 0.5 - MARGIN) | ~region
    r_boxes = _clip((boxes_r[0][idx].cpu().numpy()) / scale, H, W)

    got_m, got_b = prog["proposals"]["masks"], prog["proposals"]["boxes"]
    missing = sure_on.flatten(1).any(1).float().cpu().numpy()

    def share(i, j):
        m = torch.from_numpy(got_m[j]).to(dev)
        differ = (m & sure_off[i]) | (~m & sure_on[i])
        return float(differ.sum()) / max(1, int((m | sure_on[i]).sum()))

    pairs = align(p_boxes, got_b, missing, share)
    if pairs is None or sized(got_m, got_b, cfg) != prog["sized"]:
        mask_px, box_px = 1.0, 0.0
    else:
        mask_px = max([c for _, _, c in pairs] + [0.0])
        box_px = max([float(np.abs(got_b[j] - r_boxes[i]).max())
                      for i, j, _ in pairs if j is not None] + [0.0])
    return {"head": head, "box_px": box_px, "mask_px": mask_px,
            "proposals": len(got_b), "kept": len(keep)}


def align(kept_boxes, got_boxes, missing, share):
    """The program's proposals are its kept anchors less those whose mask
    came out empty, in order, each with its kept anchor's box.  Pair
    them: the alignment of least total cost, where a proposal pairs only
    with a kept anchor of the same box (cost `share(i, j)`) and a kept
    anchor left out costs missing[i] (1 where the reference's mask has a
    pixel past the margin, else 0).  Boxes repeat where they are clipped
    to the frame, so the order alone does not decide.  Returns [(anchor
    i, proposal j or None, cost)], or None where no alignment explains
    the proposals."""
    K, N = len(kept_boxes), len(got_boxes)
    inf = float("inf")
    cost = np.full((K + 1, N + 1), inf)
    cost[0, 0] = 0.0
    back, memo = {}, {}
    for i in range(K):
        for j in range(min(i, N) + 1):
            c = cost[i, j]
            if c == inf:
                continue
            if c + missing[i] < cost[i + 1, j]:
                cost[i + 1, j] = c + missing[i]
                back[i + 1, j] = (j, None)
            if j < N and np.array_equal(got_boxes[j], kept_boxes[i]):
                if (i, j) not in memo:
                    memo[i, j] = share(i, j)
                if c + memo[i, j] < cost[i + 1, j + 1]:
                    cost[i + 1, j + 1] = c + memo[i, j]
                    back[i + 1, j + 1] = (j, memo[i, j])
    if cost[K, N] == inf:
        return None
    pairs, j = [], N
    for i in range(K, 0, -1):
        prev, c = back[i, j]
        pairs.append((i - 1, j - 1, c) if c is not None
                     else (i - 1, None, float(missing[i - 1])))
        j = prev
    return pairs[::-1]


def judge_frame(net, desc, bank, rcfg, frame, prog: dict) -> dict:
    """The numbers of one frame: `proposals`, then `ism_judge.scores` on
    the program's final detections (prog["dets"])."""
    image, depth, K = frame
    out = proposals(net, rcfg, frame, prog)
    d = prog["dets"]
    if len(d["masks"]):
        r = ism_judge.scores(desc, bank, rcfg, image, depth, K, d)
        dev = r["sem"].device

        def gap(key, mine):
            return float((r[key] - torch.as_tensor(
                mine, device=dev, dtype=torch.float32)).abs().max())

        out.update(sem=gap("sem", d["semantic_score"]),
                   appe=gap("appe", d["appe_score"]),
                   score=gap("final", d["scores"]),
                   pick=float((r["best_sem"] - r["sem"]).max()))
    else:
        out.update(sem=0.0, appe=0.0, score=0.0, pick=0.0)
    out["detections"] = len(d["masks"])
    return out


def worst(per_frame: list[dict]) -> dict:
    return {k: max(d[k] for d in per_frame) for k in NUMBERS}
