"""Bounding boxes, crops and resampling.

Plain copy of `sam6d_tpu_torch/utils/bbox.py` (reference Instance_Segmentation_
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


