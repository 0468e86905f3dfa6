"""SAM's box and mask prompts in the port against the JAX package on the
CPU: `PromptEncoder.encode_boxes`, `encode_masks`, the full prompt
assembly (`forward`, the JAX `__call__`) and `SAM.decode_prompts`, with
and without boxes and masks.

The tiny SAM of test_torch_ism.py (vit_b layout, img 64, embed 32, depth
2), whose variables carry the mask-downscaling weights across
(`params.sam_state_dict`).  Tolerance 1e-5, float32 (test_torch_ism.py's
module tolerance).  With a mask prompt the dense embedding has batch B
while the image embedding stays at batch 1: the decoder's image side is
then per prompt; without one it is shared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.models.ism.sam.prompt import PromptEncoder as JPrompt
from tests.test_torch_ism import ATOL, tiny  # noqa: F401  (fixture)

B = 3


def prompts(rng):
    return dict(
        points=(rng.rand(B, 2, 2) * 64).astype(np.float32),
        labels=np.array([[1, 0], [1, -1], [0, 1]], np.int32),
        # xyxy: the corners' coordinates sorted, (x1, y1) <= (x2, y2).
        boxes=np.sort(rng.rand(B, 2, 2) * 64, axis=1).reshape(B, 4).astype(
            np.float32),
        masks=(rng.randn(B, 16, 16, 1) * 3).astype(np.float32))


def as_jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def as_torch(p):
    out = {k: torch.from_numpy(v) for k, v in p.items()}
    out["labels"] = out["labels"].long()
    return out


def test_encode_boxes_matches(tiny, rng):
    p = prompts(rng)
    want = tiny["jsam"].prompt_encoder.apply(
        tiny["jsam"].variables["prompt"], jnp.asarray(p["boxes"]),
        method=JPrompt.encode_boxes)
    with torch.no_grad():
        got = tiny["tsam"].prompt.encode_boxes(torch.from_numpy(p["boxes"]))
    assert got.shape == (B, 2, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode_masks_matches(tiny, rng):
    # Non-symmetric logits: the 2x2 blocks' (dy, dx, c) nesting shows.
    m = prompts(rng)["masks"]
    want = tiny["jsam"].prompt_encoder.apply(
        tiny["jsam"].variables["prompt"], jnp.asarray(m),
        method=JPrompt.encode_masks)
    with torch.no_grad():
        got = tiny["tsam"].prompt.encode_masks(torch.from_numpy(m))
    assert got.shape == (B, 4, 4, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


CASES = [(False, False), (True, False), (False, True), (True, True)]


def pick(p, boxes, masks):
    return {k: v for k, v in p.items()
            if (k != "boxes" or boxes) and (k != "masks" or masks)}


@pytest.mark.parametrize("boxes,masks", CASES)
def test_prompt_assembly_matches(tiny, rng, boxes, masks):
    p = pick(prompts(rng), boxes, masks)
    want = tiny["jsam"].prompt_encoder.apply(
        tiny["jsam"].variables["prompt"], **as_jax(p))
    with torch.no_grad():
        got = tiny["tsam"].prompt(**as_torch(p))
    # Points are padded with a "not a point" only without boxes.
    assert got[0].shape == (B, 2 + (2 if boxes else 1), 256)
    assert got[1].shape == ((B, 4, 4, 256) if masks else (1, 4, 4, 256))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL)


@pytest.mark.parametrize("boxes,masks", CASES)
def test_decode_prompts_matches(tiny, rng, boxes, masks):
    p = pick(prompts(rng), boxes, masks)
    emb = (rng.randn(1, 4, 4, 256) * 0.5).astype(np.float32)
    want = tiny["jsam"].decode_prompts(jnp.asarray(emb), **as_jax(p))
    with torch.no_grad():
        got = tiny["tsam"].decode_prompts(torch.from_numpy(emb),
                                          **as_torch(p))
    assert got[0].shape == (B, 4, 16, 16) and got[1].shape == (B, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL)
