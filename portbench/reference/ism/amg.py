"""Automatic mask generation, plain: every grid prompt decoded to its
three multimask logits, upscaled to the frame.

Plain copy of the unfused path of `sam6d_tpu_torch/models/ism/sam/amg.py`
(SAM automatic_mask_generator.py and utils/amg.py; the width pre- and
post-resize of SAM-6D's model/sam.py), without the selection: the
reference judges the program's kept masks against every candidate
(`portbench/harness/ism_judge.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ism.bbox import pil_bilinear_resize, resize_matrix


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) evenly spaced points in [0, 1]^2, (x, y) order."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(coords, coords)
    return np.stack([xs.flatten(), ys.flatten()], axis=-1).astype(np.float32)


def prepare(sam, image: np.ndarray, width: int):
    """The frame as the generator feeds SAM: pre-resized to `width`, then
    SAM's preprocess.  Returns (input (S, S, 3), scale, (eff_h, eff_w),
    (mid_h, mid_w) or (None, None))."""
    H, W = image.shape[:2]
    work = torch.from_numpy(np.ascontiguousarray(image)).to(sam.device)
    mid = (None, None)
    if width and width != W:
        mid = (int(width * H / W), width)
        work = pil_bilinear_resize(work, *mid)
    img, scale, eff = sam.preprocess(work)
    return img, scale, eff, mid


def grid_points(n_per_side: int, eff, device) -> torch.Tensor:
    """The grid prompts in input coordinates, (1, P, 2)."""
    pts = build_point_grid(n_per_side) * np.array([eff[1], eff[0]],
                                                  np.float32)
    return torch.from_numpy(pts).to(device)[None]


@torch.no_grad()
def candidate_logits(sam, embedding, points, points_per_batch: int):
    """Every prompt's three multimask logits (3P, h, w), prompt-major,
    and the decoder's output tokens (P, T, C)."""
    logits, tokens = [], []
    P = points.shape[1]
    dec = sam.decoder
    h, w = embedding.shape[1:3]
    out_tokens = torch.cat([dec.iou_token, dec.mask_tokens], dim=0)
    for b in range(0, P, points_per_batch):
        p = points[0, b:b + points_per_batch][:, None, :]
        pe, sparse, dense = sam._prompt_inputs(p)
        B = sparse.shape[0]
        tok = torch.cat([out_tokens[None].expand(B, -1, -1), sparse], dim=1)
        hs, keys = dec.transformer(embedding + dense, pe, tok)
        hyper = torch.stack([
            getattr(dec, f"output_hypernetworks_mlps_{i}")(hs[:, 1 + i])
            for i in range(dec.num_tokens)], dim=1)
        lg = dec.tail(keys, hyper, h, w)
        logits.append(lg[:, 1:].float().reshape(-1, 4 * h, 4 * w))
        tokens.append(hs.float())
    return torch.cat(logits), torch.cat(tokens)


def upscale_masks(logits, eff_h: int, eff_w: int, out_h: int, out_w: int,
                  mask_threshold: float, mid_h=None, mid_w=None):
    """(K, h, w) logits -> (K, out_h, out_w) bool at the frame's size: the
    chain resize(h -> 4h) -> crop the padding -> resize to the work size
    [-> resize to the frame], one product per axis."""
    K, h, w = logits.shape
    dev = logits.device
    S = 4 * h

    def chain(src, eff, mid, out):
        m = resize_matrix(src, S, dev)[:eff]
        if mid is not None:
            m = resize_matrix(eff, mid, dev) @ m
            eff = mid
        return resize_matrix(eff, out, dev) @ m

    A = chain(h, eff_h, mid_h, out_h)
    Bm = chain(w, eff_w, mid_w, out_w)
    full = torch.einsum("yh,khw,xw->kyx", A, logits.float(), Bm)
    return full > mask_threshold
