"""Automatic mask generation (AMG): grid-prompted all-instance proposals.

Counterpart of `sam6d_tpu/models/ism/sam/amg.py` (reference
segment_anything/automatic_mask_generator.py :35, _process_batch :266,
utils/amg.py :156-303, and the width pre/post resize of
model/sam.py:52-155).  Every grid prompt is decoded on the card in
batches of `points_per_batch`; filtering (predicted IoU, stability) and
mask -> box run on the card at the 256 x 256 logit resolution; a fixed
top-K candidate set returns to the host for the greedy NMS; masks are
upscaled to the frame for the kept set only.

Two decode paths, as in the JAX package:
* fused (the default on the card): the transformer per batch, then the
  decode-tail statistics kernel K6 (`ops/decode_tail.py`) once over all
  prompts, and the exact-erf logits recomputed for the top K only;
* unfused: every prompt's logits materialized (the second oracle).
`cfg.fused_tail=None` picks the fused path when the tensors lie on a CUDA
device (the JAX rule is "on TPU").

The model is SAM (`sam/model.py`) or SAM 2 (`sam2/model.py`, whose
SAM2AutomaticMaskGenerator takes the same grid prompts and defaults).
The embedding `encode` returns goes to the model's decode and tail
methods as it is (SAM 2's carries its high-resolution features).  The
model's `preprocess` gives its input-per-pixel scale, one for both axes
(SAM's) or (x, y), and boxes go back by axis.  A model with
`square_resize` stretches the frame to its square input (the scales
differ), grid points map to (S x / W, S y / H), and the kept masks are
resized from the logit grid straight to the frame
(SAM2Transforms.postprocess_masks), not through SAM's padded input.
"""

from __future__ import annotations

import numpy as np
import torch

from sam6d_tpu_torch.config import SegmentorConfig
from sam6d_tpu_torch.ops.decode_tail import decode_tail_stats, fold_stats
from sam6d_tpu_torch.ops.topk import top_k_indices
from sam6d_tpu_torch.utils.bbox import pil_bilinear_resize, resize_matrix
from sam6d_tpu_torch.utils.detections import nms
from sam6d_tpu_torch.utils.timer import stage

MAX_CANDIDATES = 256  # the JAX generator's top-K


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) evenly spaced points in [0, 1]^2, (x, y) order."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.flatten(), ys.flatten()], axis=-1).astype(np.float32)


def calculate_stability_score(logits, mask_threshold: float, offset: float):
    """IoU of the masks thresholded high and low (reference amg.py:156)."""
    high = (logits > mask_threshold + offset).sum((-2, -1))
    low = (logits > mask_threshold - offset).sum((-2, -1))
    return high / torch.clamp_min(low, 1)


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """(..., H, W) bool -> (..., 4) xyxy float32, [xmin, ymin, xmax + 1,
    ymax + 1], zeros for an empty mask."""
    H, W = mask.shape[-2:]
    ys = torch.arange(H, device=mask.device)[:, None].expand(H, W)
    xs = torch.arange(W, device=mask.device)[None, :].expand(H, W)
    big = 10 ** 8
    y_min = torch.where(mask, ys, big).amin((-2, -1))
    x_min = torch.where(mask, xs, big).amin((-2, -1))
    y_max = torch.where(mask, ys, -1).amax((-2, -1))
    x_max = torch.where(mask, xs, -1).amax((-2, -1))
    box = torch.stack([x_min, y_min, x_max + 1, y_max + 1], -1).float()
    return torch.where((y_max < 0)[..., None], 0.0, box)


class SamAutomaticMaskGenerator:
    """Grid-prompted mask proposals over a SAM model (`sam/model.py`)."""

    def __init__(self, sam_model, cfg: SegmentorConfig):
        self.sam = sam_model
        self.cfg = cfg
        self.point_grid = build_point_grid(cfg.points_per_side)
        self.fused = (cfg.fused_tail if cfg.fused_tail is not None
                      else sam_model.device.type == "cuda")

    @torch.no_grad()
    def generate_masks(self, image: np.ndarray, timer=None) -> dict:
        """(H, W, 3) uint8 -> {"masks": (N, H, W) bool, "boxes": (N, 4)
        xyxy float32} at the frame's resolution (reference
        model/sam.py:103-148).  cfg.segmentor_width_size pre-resizes the
        frame to that width; the resize back is composed into the
        upscale matmuls, and boxes are scaled and clipped on the host."""
        cfg = self.cfg
        H, W = image.shape[:2]
        dev = self.sam.device
        ws = cfg.segmentor_width_size or 0
        mid_h = mid_w = None
        box_scale = 1.0
        work = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        if ws and ws != W:
            mid_h, mid_w = int(ws * H / W), ws
            work = pil_bilinear_resize(work, mid_h, mid_w)
            box_scale = W / ws
        square = getattr(self.sam, "square_resize", False)
        with stage(timer, "encoder"):
            img, scale, (eff_h, eff_w) = self.sam.preprocess(work)
            sx, sy = np.broadcast_to(scale, 2)  # SAM's one scale, or two
            embedding = self.sam.encode(img[None])
        pts = self.point_grid * np.array([eff_w, eff_h], np.float32)
        pts = torch.from_numpy(pts).to(dev)[None]
        with stage(timer, "amg_decode"):
            decode = _decode_and_filter_fused if self.fused \
                else _decode_and_filter_all
            logits_k, iou_k, stab_k, boxes_k = decode(
                embedding, pts, sam=self.sam,
                points_per_batch=cfg.points_per_batch,
                mask_threshold=cfg.mask_threshold,
                stability_offset=cfg.stability_score_offset,
                top_k=MAX_CANDIDATES)
            iou_k, stab_k, boxes_k = (t.float().cpu().numpy()
                                      for t in (iou_k, stab_k, boxes_k))

        with stage(timer, "amg_select"):
            keep = ((iou_k > cfg.pred_iou_thresh)
                    & (stab_k > cfg.stability_score_thresh))
            keep &= ((boxes_k[:, 2] > boxes_k[:, 0])
                     & (boxes_k[:, 3] > boxes_k[:, 1]))
            idx = np.flatnonzero(keep)
            if len(idx) == 0:
                return {"masks": np.zeros((0, H, W), bool),
                        "boxes": np.zeros((0, 4), np.float32)}
            idx = idx[nms(boxes_k[idx], iou_k[idx], cfg.box_nms_thresh)]
            masks = _upscale_masks(
                logits_k[torch.from_numpy(idx).to(dev)], eff_h, eff_w, H, W,
                cfg.mask_threshold, mid_h, mid_w, square).cpu().numpy()
            boxes = (boxes_k[idx] / np.array([sx, sy, sx, sy], np.float32)
                     * box_scale)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W - 1)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H - 1)
            if cfg.min_mask_region_area > 0:
                masks, changed = remove_small_regions_batch(
                    masks, cfg.min_mask_region_area)
                # Re-NMS preferring untouched masks, on boxes of the
                # edited masks (reference postprocess_small_regions).
                boxes = masks_to_boxes(masks)
                rescue = nms(boxes, (~changed).astype(np.float32),
                             cfg.box_nms_thresh)
                masks, boxes = masks[rescue], boxes[rescue]
            nonempty = masks.reshape(len(masks), -1).any(axis=1)
        return {"masks": masks[nonempty],
                "boxes": boxes[nonempty].astype(np.float32)}


def _decode_and_filter_all(embedding, points, *, sam, points_per_batch: int,
                           mask_threshold: float, stability_offset: float,
                           top_k: int):
    """Decode every grid prompt to its logits, score, keep the top K."""
    P = points.shape[1]
    logits, iou = [], []
    for b in range(P // points_per_batch):
        p = points[0, b * points_per_batch:(b + 1) * points_per_batch]
        lg, io = sam.decode_points(embedding, p[:, None, :])
        # The 3 multimask outputs; token 0 (single mask) is dropped.
        logits.append(lg[:, 1:])
        iou.append(io[:, 1:])
    logits = torch.cat(logits)
    h, w = logits.shape[-2:]
    logits = logits.reshape(-1, h, w)
    iou = torch.cat(iou).reshape(-1)
    stability = calculate_stability_score(logits, mask_threshold,
                                          stability_offset)
    keep = top_k_indices(iou + 1e-3 * stability, top_k)
    logits_k = logits[keep]
    boxes_k = mask_to_box(logits_k > mask_threshold) * (sam.input_size / h)
    return logits_k, iou[keep], stability[keep], boxes_k


def fused_candidates(embedding, points, *, sam, points_per_batch: int,
                     mask_threshold: float, stability_offset: float):
    """The transformer per prompt batch, then the tail statistics (K6)
    over all prompts: (keys (P, N, C), hyper (P, 3, C / 8), and per
    candidate, prompt-major, iou (3P,), stability (3P,), boxes (3P, 4))."""
    P = points.shape[1]
    keys, hyper, iou = [], [], []
    for b in range(P // points_per_batch):
        p = points[0, b * points_per_batch:(b + 1) * points_per_batch]
        k, hy, io = sam.decode_points_pre(embedding, p[:, None, :])
        keys.append(k.to(sam.dtype))
        hyper.append(hy)
        iou.append(io[:, 1:])
    keys = torch.cat(keys)  # (P, N, C)
    hyper3 = torch.cat(hyper)[:, 1:]  # (P, 3, C / 8)
    iou = torch.cat(iou).reshape(-1)
    N = keys.shape[1]
    stats = decode_tail_stats(
        keys, hyper3.float().contiguous(),
        **sam.decoder_tail_params(embedding), mask_threshold=mask_threshold,
        stability_offset=stability_offset)
    h = int(round(N ** 0.5))
    stability, boxes, _ = fold_stats(stats, sam.input_size / (4 * h))
    return keys, hyper3, iou, stability.reshape(-1), boxes.reshape(-1, 4)


def _decode_and_filter_fused(embedding, points, *, sam,
                             points_per_batch: int, mask_threshold: float,
                             stability_offset: float, top_k: int):
    """`fused_candidates`, then the exact logits of the top K only."""
    keys, hyper3, iou, stability, boxes = fused_candidates(
        embedding, points, sam=sam, points_per_batch=points_per_batch,
        mask_threshold=mask_threshold, stability_offset=stability_offset)
    h = int(round(keys.shape[1] ** 0.5))
    keep = top_k_indices(iou + 1e-3 * stability, top_k)
    prompt_idx, tok = keep // 3, keep % 3
    logits_k = sam.decode_tail(keys[prompt_idx],
                               hyper3[prompt_idx, tok][:, None], h, h,
                               embedding)[:, 0]
    return logits_k, iou[keep], stability[keep], boxes[keep]


def _upscale_masks(logits, eff_h: int, eff_w: int, out_h: int, out_w: int,
                   mask_threshold: float, mid_h: int | None = None,
                   mid_w: int | None = None, direct: bool = False):
    """(K, h, w) logits -> (K, out_h, out_w) bool at the frame's size.

    The reference chain resize(256 -> 1024) -> crop the padding -> resize
    to the work size [-> resize to the frame] is linear per axis, so it
    collapses into one (out_h, h) x (K, h, w) x (w, out_w) product.
    direct (SAM 2): resize(256 -> the work size) [-> the frame]."""
    K, h, w = logits.shape
    dev = logits.device
    S = 4 * h

    def chain(src, eff, mid, out):
        if direct:
            m = resize_matrix(src, mid or out, dev)
            return m if mid is None else resize_matrix(mid, out, dev) @ m
        m = resize_matrix(src, S, dev)[:eff]
        if mid is not None:
            m = resize_matrix(eff, mid, dev) @ m
            eff = mid
        return resize_matrix(eff, out, dev) @ m

    A = chain(h, eff_h, mid_h, out_h)
    Bm = chain(w, eff_w, mid_w, out_w)
    full = torch.einsum("yh,khw,xw->kyx", A, logits.float(), Bm)
    return full > mask_threshold


def remove_small_regions_batch(masks: np.ndarray, area_thresh: int):
    """Remove small islands and fill small holes per mask (reference
    utils/amg.py remove_small_regions; scipy.ndimage here).  Returns
    (masks, changed)."""
    from scipy import ndimage

    out = masks.copy()
    changed = np.zeros(len(masks), bool)
    for i, m in enumerate(masks):
        for mode in ("holes", "islands"):
            work = ~m if mode == "holes" else m
            labels, n = ndimage.label(work)
            if n == 0:
                continue
            sizes = ndimage.sum_labels(np.ones_like(work, np.int32), labels,
                                       np.arange(1, n + 1))
            small = np.flatnonzero(sizes < area_thresh) + 1
            if len(small) == 0:
                continue
            if mode == "islands" and len(small) == n:
                # Every island is small: keep the largest one.
                small = small[small != (int(np.argmax(sizes)) + 1)]
                if len(small) == 0:
                    continue
            fill = np.isin(labels, small)
            m = m | fill if mode == "holes" else m & ~fill
            changed[i] = True
        out[i] = m
    return out, changed


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """XYXY boxes of (K, H, W) bool masks, zeros for empty ones, in the
    convention of `mask_to_box` + the clip of `generate_masks`."""
    H, W = masks.shape[-2:]
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[i] = (xs.min(), ys.min(), min(xs.max() + 1, W - 1),
                        min(ys.max() + 1, H - 1))
    return boxes
