"""PIL's filters and enhancers that the colour augmentation uses, in numpy.

`sam6d_tpu/provider/augment.py` runs `ImageFilter.GaussianBlur`,
`ImageEnhance.{Sharpness,Contrast,Brightness,Color}` on uint8 RGB crops;
the card's machine has no PIL, so the port computes the same integers
(Pillow 12's `libImaging`):

* `gaussian_blur`: `ImagingGaussianBlur` (BoxBlur.c), three passes of
  an extended box blur along x, then three along y.  The box radius r +
  a comes from `_gaussian_blur_radius` in float32; each pass sums the
  2r + 1 samples of the window (edges replicated) with the weight ww =
  2^24 / (2(r + a) + 1) (float32, truncated) and the two samples just
  outside it with fw = (2^24 - (2r + 1) ww) / 2, then rounds to uint8 at
  24 fractional bits.
* `smooth`: `ImageFilter.SMOOTH` (Filter.c, `ImagingFilter3x3`): float32
  sums of the kernel [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 from 0.5,
  row y + 1 first, truncated and clipped; the border pixels are copied.
* `blend`: `ImagingBlend` in float32, im1 + alpha (im2 - im1), truncated
  and clipped; the enhancers are blends of the image with a degenerate
  one: the smoothed image (sharpness), the grey level int(mean luma +
  0.5) (contrast), black (brightness), the luma (colour).
* `to_luma`: `convert("L")`, (19595 R + 38470 G + 7471 B + 2^15) >> 16.

All are held to PIL's arrays bit for bit (tests/test_torch_augment.py).
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def _check(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    return img


def _gaussian_blur_radius(radius: float, passes: int = 3) -> float:
    """BoxBlur.c's `_gaussian_blur_radius`, with C's float / double
    mixing: the box radius (integer part + fraction) of `passes` box
    passes whose variance is radius^2."""
    r = _F32(radius)
    sigma2 = _F32(r * r) / _F32(passes)
    L = _F32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = _F32(math.floor((float(L) - 1.0) / 2.0))  # noqa: E741
    a = _F32(_F32(2) * l + _F32(1)) * _F32(l * _F32(l + _F32(1))
                                           - _F32(3) * sigma2)
    a = _F32(a / _F32(_F32(6) * _F32(sigma2 - _F32(l + 1) * _F32(l + 1))))
    return float(_F32(l + a))


def _box_pass(img: np.ndarray, radius: float, axis: int) -> np.ndarray:
    """One `ImagingHorizontalBoxBlur` pass along `axis` of int64 (H, W, C)."""
    r = int(radius)
    ww = int(_F32(1 << 24) / _F32(_F32(radius) * _F32(2) + _F32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    x = np.moveaxis(img, axis, 0)
    n = x.shape[0]
    pad = np.pad(x, [(r + 1, r + 1)] + [(0, 0)] * (x.ndim - 1), mode="edge")
    csum = np.concatenate([np.zeros((1,) + x.shape[1:], np.int64),
                           np.cumsum(pad, axis=0)])
    # Window [i - r, i + r] of output i, in padded coordinates +r+1.
    idx = np.arange(n)
    window = csum[idx + 2 * r + 2] - csum[idx + 1]
    far = pad[idx] + pad[idx + 2 * r + 2]
    out = (window * ww + far * fw + (1 << 23)) >> 24
    return np.moveaxis(out, 0, axis)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """`img.filter(ImageFilter.GaussianBlur(radius))` of a uint8 RGB array."""
    img = _check(img)
    if radius == 0:
        return img.copy()
    box = _gaussian_blur_radius(radius)
    x = img.astype(np.int64)
    if box != 0:
        for axis in (1, 0):
            for _ in range(3):
                x = _box_pass(x, box, axis)
    return x.astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """`img.filter(ImageFilter.SMOOTH)` of a uint8 RGB array."""
    img = _check(img)
    H, W = img.shape[:2]
    if H < 3 or W < 3:
        return img.copy()
    k1, k5 = _F32(1) / _F32(13), _F32(5) / _F32(13)
    f = img.astype(_F32)
    ss = np.full((H - 2, W - 2, 3), _F32(0.5), _F32)
    for row, centre in ((2, k1), (1, k5), (0, k1)):  # in1, in0, in_1
        r = f[row:row + H - 2]
        ss = ss + (r[:, :-2] * k1 + r[:, 1:-1] * centre + r[:, 2:] * k1)
    out = img.copy()
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(im1, im2, alpha)` of uint8 arrays."""
    a = _F32(alpha)
    i1 = im1.astype(np.int32)
    diff = (im2.astype(np.int32) - i1).astype(_F32)
    temp = i1.astype(_F32) + a * diff
    return np.clip(temp, 0, 255).astype(np.uint8)


def to_luma(img: np.ndarray) -> np.ndarray:
    """`convert("L")` of a uint8 RGB array: (H, W) uint8."""
    x = img.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def enhance_sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    img = _check(img)
    return blend(smooth(img), img, factor)


def enhance_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    img = _check(img)
    luma = to_luma(img)
    mean = int(float(luma.sum(dtype=np.int64)) / luma.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def enhance_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    img = _check(img)
    return blend(np.zeros_like(img), img, factor)


def enhance_color(img: np.ndarray, factor: float) -> np.ndarray:
    img = _check(img)
    grey = np.repeat(to_luma(img)[..., None], 3, axis=2)
    return blend(grey, img, factor)
