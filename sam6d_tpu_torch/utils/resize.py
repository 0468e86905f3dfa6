"""PIL's BILINEAR and NEAREST resize of uint8 images, in numpy.

The host loaders of the JAX package resize with PIL
(`pem_data._resize`, `onboarding.load_template_crops`); the card's
machine has no PIL, so the port computes the same integers:

* BILINEAR follows Pillow's `libImaging/Resample.c`: per output pixel,
  float64 triangle-filter coefficients whose support widens by the
  downscale factor, normalised by their sum (added in order), then
  converted to fixed point with 22 fractional bits; a horizontal pass
  and then a vertical pass, each summing integers from half a unit and
  clipping to uint8, so the intermediate image is rounded to uint8.  A
  pass whose size does not change is skipped.
* NEAREST follows Pillow's `ImagingScaleAffine` (`libImaging/
  Geometry.c`): the source coordinate of output pixel i is the centre
  0.5 * s advanced by s = in / out once per pixel (float64, added in
  order), truncated.

Both give PIL's arrays exactly (`tests/test_torch_demo_io.py` holds them
to PIL at the crop sizes of the pipeline and at random down- and
upscales).  `utils/bbox.pil_bilinear_resize` is the float32 torch
formulation the SAM preprocessing runs on the card, within one grey
level of these.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """(out_size,) first source index, (out_size, ksize) int64 fixed-point
    weights (zero past each pixel's support), as `precompute_coeffs` and
    `normalize_coeffs_8bpc` compute them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # C truncation
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss))
             for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        first[xx] = xmin
    fixed = np.trunc(0.5 + kk * (1 << PRECISION_BITS)).astype(np.int64)
    return first, fixed


def _bilinear_pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of (H, W, C)."""
    in_size = img.shape[axis]
    first, fixed = _bilinear_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(fixed.shape[1]):
        idx = np.minimum(first + k, in_size - 1)
        acc += src[idx] * fixed[:, k].reshape((-1,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = in_size / out_size
    pos = step * 0.5
    idx = np.empty(out_size, np.int64)
    for i in range(out_size):
        idx[i] = -1 if pos < 0.0 else int(pos)
        pos += step
    return idx


def pil_resize(image: np.ndarray, out_h: int, out_w: int,
               resample: str = "bilinear") -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> uint8 (out_h, out_w[, C]), as PIL's
    `Image.fromarray(image).resize((out_w, out_h), BILINEAR | NEAREST)`
    computes it for an L or RGB image."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"pil_resize takes uint8 (H, W[, C]), got "
                         f"{image.dtype} {image.shape}")
    H, W = image.shape[:2]
    if (H, W) == (out_h, out_w):
        return image.copy()
    if resample == "nearest":
        iy, ix = _nearest_index(H, out_h), _nearest_index(W, out_w)
        out = np.zeros((out_h, out_w) + image.shape[2:], np.uint8)
        vy, vx = (iy >= 0) & (iy < H), (ix >= 0) & (ix < W)
        out[np.ix_(vy, vx)] = image[np.ix_(iy[vy], ix[vx])]
        return out
    if resample != "bilinear":
        raise ValueError(f"unsupported resample {resample!r}")
    out = image
    if out_w != W:
        out = _bilinear_pass(out, out_w, 1)
    if out_h != H:
        out = _bilinear_pass(out, out_h, 0)
    return out
