"""Bounding boxes, crops and resampling.

Counterpart of `sam6d_tpu/utils/bbox.py` (reference Instance_Segmentation_
Model/utils/bbox_utils.py: CropResizePad :89-126, xyxy_to_xywh :129,
compute_iou :197; Pose_Estimation_Model/utils/data_utils.py:113-160).

`resample_weights` is the weight matrix of `jax.image.scale_and_translate`
with the triangle ("bilinear") kernel: it antialiases when it scales down
(the kernel widens by 1/scale), renormalises the weights of each output
sample, and zeroes samples that fall outside the input.  `F.interpolate`
does neither, so every resample of the ISM goes through these matrices as
two matmuls.  `pil_bilinear_resize` uses the same weights, which are those
of PIL's BILINEAR resize, with PIL's rounding to uint8 after each pass.
"""

from __future__ import annotations

import numpy as np
import torch


def xyxy_to_xywh(boxes: np.ndarray) -> np.ndarray:
    out = np.array(boxes, np.float32).copy()
    out[..., 2] = boxes[..., 2] - boxes[..., 0]
    out[..., 3] = boxes[..., 3] - boxes[..., 1]
    return out


def xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    out = np.array(boxes, np.float32).copy()
    out[..., 2] = boxes[..., 0] + boxes[..., 2]
    out[..., 3] = boxes[..., 1] + boxes[..., 3]
    return out


def compute_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) IoU matrix of xyxy boxes."""
    ax1, ay1, ax2, ay2 = (a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    inter = (np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
             * np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None))
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / (area_a + area_b - inter + 1e-9)


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translate: torch.Tensor) -> torch.Tensor:
    """(..., out_size, in_size) float32 weights of
    `jax.image.scale_and_translate(..., method="bilinear")` along one axis,
    for a batch of `scale` / `translate` values (float32 tensors of one
    shape; output sample i reads input position (i + 0.5 - t) / s - 0.5)."""
    dev = scale.device
    inv = 1.0 / scale[..., None]
    kernel_scale = torch.clamp_min(inv, 1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (i + 0.5) * inv - translate[..., None] * inv - 0.5
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (sample[..., :, None] - j).abs() / kernel_scale[..., None]
    w = torch.clamp_min(1.0 - x, 0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, 0.0)


def resize_matrix(src: int, dst: int, device=None) -> torch.Tensor:
    """(dst, src) matrix of `jax.image.resize(..., "bilinear")` along one
    axis (the identity when the sizes agree, as JAX skips that axis)."""
    if src == dst:
        return torch.eye(src, device=device)
    one = torch.ones((), device=device)
    return resample_weights(src, dst, one * (dst / src), one * 0.0)


def _crop_weights(boxes: torch.Tensor, H: int, W: int, S: int):
    """Row and column weights (Q, S, H), (Q, S, W) of each box's square
    crop scaled so its longer side is S, and the (Q, S, S) mask of what
    lies inside the scaled crop (the weights sample the whole image)."""
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    h, w = y2 - y1, x2 - x1
    scale = S / torch.clamp_min(torch.maximum(h, w), 1e-6)
    wy = resample_weights(H, S, scale, -scale * y1)
    wx = resample_weights(W, S, scale, -scale * x1)
    ar = torch.arange(S, device=boxes.device)
    valid = ((ar[:, None] < (scale * h)[:, None, None])
             & (ar[None, :] < (scale * w)[:, None, None]))
    return wy, wx, valid


def crop_resize_pad(image: torch.Tensor, boxes: torch.Tensor,
                    target_size: int = 224) -> torch.Tensor:
    """Square crop-scale-pad of proposal boxes from one image, batched.

    Each box is cropped, scaled so its longer side equals `target_size`,
    and zero-padded bottom/right (reference bbox_utils.py:98-126).

    image: (H, W, C) float; boxes: (Q, 4) float xyxy.
    Returns (Q, target_size, target_size, C).
    """
    H, W, _ = image.shape
    wy, wx, valid = _crop_weights(boxes, H, W, target_size)
    rows = torch.einsum("qsh,chw->qcsw", wy, image.float().permute(2, 0, 1))
    return torch.einsum("qcsw,qtw->qstc", rows, wx) * valid[..., None]


def crop_resize_pad_masks(masks: torch.Tensor, boxes: torch.Tensor,
                          target_size: int = 224) -> torch.Tensor:
    """`crop_resize_pad` of one (H, W) mask per box: (Q, H, W) + (Q, 4) ->
    (Q, S, S) float, each mask cropped by its own box."""
    wy, wx, valid = _crop_weights(boxes, *masks.shape[-2:], target_size)
    return torch.bmm(torch.bmm(wy, masks.float()), wx.transpose(1, 2)) * valid


def pil_bilinear_resize(image: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """uint8 (H, W, C) -> uint8 (out_h, out_w, C) as PIL's
    `Image.resize((out_w, out_h), Image.BILINEAR)` computes it: the
    antialiased triangle filter, the horizontal pass first, each pass
    rounded half up and clipped to uint8."""
    x = image.float()
    H, W = x.shape[:2]
    if out_w != W:
        x = torch.einsum("xw,hwc->hxc", resize_matrix(W, out_w, x.device), x)
        x = torch.clamp(torch.floor(x + 0.5), 0, 255)
    if out_h != H:
        x = torch.einsum("yh,hwc->ywc", resize_matrix(H, out_h, x.device), x)
        x = torch.clamp(torch.floor(x + 0.5), 0, 255)
    return x.to(torch.uint8)


def square_bbox(mask: np.ndarray) -> tuple[int, int, int, int]:
    """Square bbox around a binary mask, clipped in-image
    (reference data_utils.py:126-160 get_bbox)."""
    H, W = mask.shape
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    rmax += 1
    cmax += 1
    b = min(max(rmax - rmin, cmax - cmin), min(H, W))
    center = [int((rmin + rmax) / 2), int((cmin + cmax) / 2)]
    rmin = center[0] - b // 2
    rmax = center[0] + b // 2
    cmin = center[1] - b // 2
    cmax = center[1] + b // 2
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > H:
        rmin -= rmax - H
        rmax = H
    if cmax > W:
        cmin -= cmax - W
        cmax = W
    return int(rmin), int(rmax), int(cmin), int(cmax)


def get_resize_rgb_choose(choose: np.ndarray, bbox: tuple[int, int, int, int],
                          img_size: int) -> np.ndarray:
    """Map in-crop flat pixel indices to indices in the crop resized to
    img_size^2 (reference data_utils.py:113-123)."""
    rmin, rmax, cmin, cmax = bbox
    crop_h = rmax - rmin
    crop_w = cmax - cmin
    ratio_h = img_size / crop_h
    ratio_w = img_size / crop_w
    row_idx = choose // crop_w
    col_idx = choose % crop_w
    return (np.floor(row_idx * ratio_h) * img_size
            + np.floor(col_idx * ratio_w)).astype(np.int64)
