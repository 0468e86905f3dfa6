"""Weight bridge: JAX/flax variable trees -> the port's state dicts, `.npz`
save and load, and seeded random weights.

The port's submodules carry the flax names, so a flax leaf
`params/a/b/kernel` maps to the torch key `a.b.weight`:

* a 2-D Dense `kernel` (in, out) becomes `weight` (out, in), transposed;
* a 1-D LayerNorm / BatchNorm `scale` becomes `weight`;
* `batch_stats` `mean` / `var` become `running_mean` / `running_var`;
* every other leaf keeps its name and shape: biases, tokens, the
  (p, p, C, D) patch kernel and the (kh, kw, C, O) conv and
  ConvTranspose kernels, the rel-pos tables, the Fourier matrix, the
  LayerScale `gamma` and the linear-attention `scale`.

The pointnet2 modules' trees (`mlp/dense_i/kernel`, `mlp/bn_i/scale`,
`bias` and `batch_stats`) map the same way into
`ops/pointnet2_modules.py`'s `PointnetSAModule` / `PointnetFPModule`.
`sam_state_dict` maps the JAX SAM's three trees (encoder, prompt,
decoder) at once; the DINOv2 tree maps as it is, into
`DescriptorModel.vit`, and FastSAM's (`params` and `batch_stats`) into
`FastSAM.net`.  `convert_weights.py` writes the same state dicts from
the released torch checkpoints.

The input is a nested dict of numpy arrays (for example
`jax.tree.map(np.asarray, variables)`); this module imports no JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def flax_to_state_dict(variables) -> dict:
    """{'params': ..., 'batch_stats': ...} -> {torch key: float32 tensor}."""
    out = {}
    for collection, tree in variables.items():
        for path, arr in _flatten(tree):
            *mods, leaf = path
            arr = np.array(arr, dtype=np.float32)  # a writable copy
            if collection == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf == "kernel" and arr.ndim == 2:
                leaf, arr = "weight", arr.T
            elif leaf == "scale" and arr.ndim == 1:
                leaf = "weight"
            out[".".join([*mods, leaf])] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def sam_state_dict(variables) -> dict:
    """The JAX SAM's {"encoder", "prompt", "decoder"} variable trees ->
    the port `SAM`'s state dict (`encoder.*`, `prompt.*`, `decoder.*`).
    4-D conv kernels (neck, mask downscaling, ConvTranspose) keep their
    (kh, kw, C, O) layout."""
    return {f"{part}.{key}": val for part, tree in variables.items()
            for key, val in flax_to_state_dict(tree).items()}


def save_npz(state_dict, path: str) -> None:
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_npz(path: str) -> dict:
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


# Leaves the JAX package draws from N(0, 1): SAM's prompt and decoder
# tokens and its random Fourier features.
_UNIT_NORMAL = ("positional_encoding_gaussian_matrix", "not_a_point_embed",
                "no_mask_embed", "iou_token", "mask_tokens")


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator):
    """Seeded random weights in the JAX package's init scheme: LeCun-normal
    Dense and conv kernels (std 1/sqrt(fan_in)), zero biases, unit norm
    and LayerScale scales, N(0, 0.02) cls / pos / bg tokens, N(0, 1) SAM
    prompt and decoder tokens, zero rel-pos tables and linear-attention
    scales (flax defaults)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel" or (leaf == "weight" and p.dim() == 2):
            fan_in = p.shape[1] if leaf == "weight" else math.prod(p.shape[:-1])
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        elif leaf in ("cls_token", "pos_embed", "bg_token"):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf in _UNIT_NORMAL or leaf.startswith("point_embed_"):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif leaf in ("weight", "gamma"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model
