"""The colour augmentation of the port against PIL and the JAX package.

`utils/pil_ops.py` against Pillow 12 bit for bit: GaussianBlur over
radius 0-3, SMOOTH, and ImageEnhance Sharpness 0-50, Contrast 0.2-50,
Brightness 0.1-6 and Color 0-20 (the ranges `augment.py:46-61` draws),
extremes and the factors 0 and 1 included, on crops of many sizes (1 x 1
and 2 x N too, where SMOOTH copies).  `provider/augment.color_augment`
against `sam6d_tpu.provider.augment.color_augment` for 60 seeds: equal
arrays, and the generator left in the same state.  `dilate_mask_cross`
against the JAX function.  No tolerance anywhere: every comparison is
exact.
"""

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter

from sam6d_tpu.provider.augment import color_augment as j_color_augment
from sam6d_tpu.provider.training_dataset import (
    dilate_mask_cross as j_dilate,
)
from sam6d_tpu_torch.provider.augment import color_augment
from sam6d_tpu_torch.provider.training_dataset import dilate_mask_cross
from sam6d_tpu_torch.utils import pil_ops


def crops(seed, n=12):
    """Crops of random sizes: uniform noise, low-contrast noise, and a
    saturated one, so that clipping and the luma mean both matter."""
    rng = np.random.RandomState(seed)
    out = [np.zeros((1, 1, 3), np.uint8) + 200,
           rng.randint(0, 256, (2, 7, 3)).astype(np.uint8)]
    for i in range(n):
        h, w = rng.randint(3, 48, 2)
        img = rng.randint(0, 256, (h, w, 3))
        if i % 3 == 1:
            img = img // 5 + 90
        elif i % 3 == 2:
            img = np.where(img > 128, 255, img // 8)
        out.append(img.astype(np.uint8))
    return out


def factors(lo, hi, seed):
    rng = np.random.RandomState(seed)
    return [lo, hi, 0.0, 1.0, 0.5, *rng.uniform(lo, hi, 6)]


ENHANCERS = {
    "sharpness": (ImageEnhance.Sharpness, pil_ops.enhance_sharpness, 0, 50),
    "contrast": (ImageEnhance.Contrast, pil_ops.enhance_contrast, 0.2, 50),
    "brightness": (ImageEnhance.Brightness, pil_ops.enhance_brightness,
                   0.1, 6),
    "color": (ImageEnhance.Color, pil_ops.enhance_color, 0, 20),
}


@pytest.mark.parametrize("name", sorted(ENHANCERS))
def test_enhancers_equal_pil(name):
    cls, fn, lo, hi = ENHANCERS[name]
    for i, img in enumerate(crops(len(name))):
        pil = cls(Image.fromarray(img))
        for f in factors(lo, hi, i):
            np.testing.assert_array_equal(
                fn(img, f), np.asarray(pil.enhance(f)),
                err_msg=f"{name} factor {f} shape {img.shape}")


def test_gaussian_blur_equals_pil():
    for i, img in enumerate(crops(1)):
        for r in (0.0, 3.0, 1e-3, 0.5, 1.0, 2.0, *np.random.RandomState(
                i).uniform(0, 3, 4)):
            want = np.asarray(Image.fromarray(img).filter(
                ImageFilter.GaussianBlur(r)))
            np.testing.assert_array_equal(
                pil_ops.gaussian_blur(img, r), want,
                err_msg=f"radius {r} shape {img.shape}")


def test_smooth_and_luma_equal_pil():
    for img in crops(2):
        pil = Image.fromarray(img)
        np.testing.assert_array_equal(
            pil_ops.smooth(img), np.asarray(pil.filter(ImageFilter.SMOOTH)))
        np.testing.assert_array_equal(pil_ops.to_luma(img),
                                      np.asarray(pil.convert("L")))


def test_blend_equals_pil_inside_and_outside_unit_range():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    b = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    for alpha in (0.0, 1.0, 0.3, 0.999, -0.5, 1.7, 37.2, -12.0):
        np.testing.assert_array_equal(
            pil_ops.blend(a, b, alpha),
            np.asarray(Image.blend(Image.fromarray(a), Image.fromarray(b),
                                   alpha)), err_msg=str(alpha))


def test_color_augment_equals_jax_array_and_generator_state():
    for seed in range(60):
        shape_rng = np.random.RandomState(100 + seed)
        h, w = shape_rng.randint(4, 64, 2)
        img = shape_rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        r_jax, r_port = (np.random.RandomState(seed) for _ in range(2))
        want = j_color_augment(r_jax, img)
        got = color_augment(r_port, img)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        s_jax, s_port = r_jax.get_state(), r_port.get_state()
        np.testing.assert_array_equal(s_port[1], s_jax[1])
        assert s_port[2:] == s_jax[2:], seed


def test_dilate_mask_cross_equals_jax():
    rng = np.random.RandomState(0)
    for it in (0, 1, 4):
        m = rng.rand(31, 45) < 0.03
        np.testing.assert_array_equal(dilate_mask_cross(m, it),
                                      j_dilate(m, it))
