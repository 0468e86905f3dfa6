"""Seeded random weights, drawn on the device in one call.

The init scheme is the port's `params.init_random_` (the JAX package's):
LeCun-normal Dense and conv kernels (std 1/sqrt(fan_in)), zero biases,
unit norm and LayerScale scales, N(0, 0.02) cls / pos / bg tokens, N(0, 1)
SAM prompt and decoder tokens and Fourier features, zero linear-attention
scales.  SAM's rel-pos tables are drawn from N(0, rel_pos_std) where that
is given (the port's `chip_smoke.fill_rel_pos_` draws N(0, 0.1), so that
the bias moves the logits), else zero.  Every normal draw comes from one
`torch.randn` on the device; the same seed gives the same weights.
"""

from __future__ import annotations

import math

import torch

_UNIT_NORMAL = ("positional_encoding_gaussian_matrix", "not_a_point_embed",
                "no_mask_embed", "iou_token", "mask_tokens")


def _kind(name: str, shape) -> tuple[str, float]:
    """(how, std) of one parameter: how is "normal", "one" or "zero"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" or (leaf == "weight" and len(shape) == 2):
        fan_in = shape[1] if leaf == "weight" else math.prod(shape[:-1])
        return "normal", 1.0 / math.sqrt(fan_in)
    if leaf in ("cls_token", "pos_embed", "bg_token"):
        return "normal", 0.02
    if leaf in _UNIT_NORMAL or leaf.startswith("point_embed_"):
        return "normal", 1.0
    if leaf in ("weight", "gamma"):
        return "one", 0.0
    return "zero", 0.0


def draw_state_dict(module: torch.nn.Module, seed: int, device,
                    rel_pos_std: float | None = None) -> dict:
    """A float32 state dict for `module`'s parameters and buffers (the
    module may live on the meta device): parameters drawn as above,
    buffers as the module initialises them (BatchNorm running mean 0 and
    variance 1)."""
    plan, total = [], 0
    for name, p in module.named_parameters():
        how, std = _kind(name, p.shape)
        if name.rsplit(".", 1)[-1] in ("rel_pos_h", "rel_pos_w") \
                and rel_pos_std:
            how, std = "normal", rel_pos_std
        plan.append((name, tuple(p.shape), how, std, total))
        if how == "normal":
            total += p.numel()
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out = {}
    for name, shape, how, std, off in plan:
        n = math.prod(shape)
        if how == "normal":
            out[name] = flat[off:off + n].view(shape) * std
        elif how == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    for name, b in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            out[name] = torch.ones(b.shape, device=device)
        else:
            out[name] = torch.zeros(b.shape, device=device, dtype=b.dtype)
    return out
