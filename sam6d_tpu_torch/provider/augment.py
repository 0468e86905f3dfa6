"""Colour augmentation of training crops, in numpy.

A copy of `sam6d_tpu/provider/augment.py` (the reference's gdrnpp /
cosypose chain, provider/training_dataset.py:81-99) with PIL's filters
and enhancers replaced by `utils/pil_ops.py` and its NEAREST resize by
`utils/resize.py`, which compute PIL's integers: the same generator state
gives the same array and leaves the generator in the same state.  Each of
the 13 ops applies with its own probability, in `rng.permutation`
order, and draws its parameters only when it applies: coarse dropout,
blur, sharpness, contrast, brightness, colour, additive offsets, channel
inversion, multiplicative noise (per channel or shared), Gaussian noise,
linear contrast about 127, blend with the ITU-R 601 luma.
"""

from __future__ import annotations

import numpy as np

from sam6d_tpu_torch.utils import pil_ops
from sam6d_tpu_torch.utils.resize import pil_resize


def _u8(img):
    """`Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))`'s array."""
    return np.clip(img, 0, 255).astype(np.uint8)


def color_augment(rng: np.random.RandomState, img: np.ndarray) -> np.ndarray:
    """Augment a uint8 (H, W, 3) crop."""
    img = img.astype(np.float32)

    def per_channel(prob_pc, lo, hi):
        """imgaug's per_channel: with probability prob_pc one draw per
        channel, else one shared draw."""
        if rng.rand() < prob_pc:
            return rng.uniform(lo, hi, (1, 1, 3))
        return np.full((1, 1, 3), rng.uniform(lo, hi), np.float32)

    def enhance(fn, lo, hi):
        return lambda x: fn(_u8(x), rng.uniform(lo, hi)).astype(np.float32)

    ops = [
        (0.5, lambda x: _coarse_dropout(rng, x, p=0.2, size_percent=0.05)),
        (0.4, enhance(pil_ops.gaussian_blur, 0, 3)),
        (0.3, enhance(pil_ops.enhance_sharpness, 0, 50)),
        (0.3, enhance(pil_ops.enhance_contrast, 0.2, 50)),
        (0.5, enhance(pil_ops.enhance_brightness, 0.1, 6)),
        (0.3, enhance(pil_ops.enhance_color, 0, 20)),
        (0.5, lambda x: x + per_channel(0.3, -25, 25)),
        (0.3, lambda x: _invert_channels(rng, x, p=0.2)),
        (0.5, lambda x: x * per_channel(0.5, 0.6, 1.4)),
        (0.5, lambda x: x * rng.uniform(0.6, 1.4)),
        (0.1, lambda x: x + rng.randn(*x.shape) * 10),
        (0.5, lambda x: 127.0 + (x - 127.0) * per_channel(0.3, 0.5, 2.2)),
        (0.5, lambda x: _grayscale_blend(rng, x)),
    ]
    for i in rng.permutation(len(ops)):
        prob, fn = ops[i]
        if rng.rand() < prob:
            img = np.clip(fn(img), 0, 255).astype(np.float32)
    return img.astype(np.uint8)


def _coarse_dropout(rng, img, p=0.2, size_percent=0.05):
    H, W = img.shape[:2]
    gh = max(1, int(H * size_percent))
    gw = max(1, int(W * size_percent))
    drop = rng.rand(gh, gw) < p
    drop_full = pil_resize((drop * 255).astype(np.uint8), H, W,
                           "nearest") > 127
    out = img.copy()
    out[drop_full] = 0
    return out


def _invert_channels(rng, img, p=0.2):
    out = img.copy()
    for c in range(3):
        if rng.rand() < p:
            out[..., c] = 255 - out[..., c]
    return out


def _grayscale_blend(rng, img):
    alpha = rng.uniform(0, 1)
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]
    return (1 - alpha) * img + alpha * gray
