"""Weight bridge: JAX/flax variable trees -> the port's state dicts, `.npz`
save and load, and seeded random weights.

The port's submodules carry the flax names, so a flax leaf
`params/a/b/kernel` maps to the torch key `a.b.weight`:

* a 2-D Dense `kernel` (in, out) becomes `weight` (out, in), transposed;
* a 1-D LayerNorm / BatchNorm `scale` becomes `weight`;
* `batch_stats` `mean` / `var` become `running_mean` / `running_var`;
* every other leaf (biases, tokens, the (p, p, C, D) patch kernel, the
  linear-attention `scale`) keeps its name and shape.

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
            arr = np.asarray(arr, dtype=np.float32)
            if collection == "batch_stats":
                leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
            elif leaf == "kernel" and arr.ndim == 2:
                leaf, arr = "weight", arr.T
            elif leaf == "scale" and arr.ndim == 1:
                leaf = "weight"
            out[".".join([*mods, leaf])] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out


def save_npz(state_dict, path: str) -> None:
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_npz(path: str) -> dict:
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}


@torch.no_grad()
def init_random_(model: torch.nn.Module, generator: torch.Generator):
    """Seeded random weights in the JAX package's init scheme: LeCun-normal
    Dense kernels (std 1/sqrt(fan_in)), zero biases, unit norm scales,
    N(0, 0.02) tokens, zero linear-attention scales (flax defaults)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel" or (leaf == "weight" and p.dim() == 2):
            fan_in = p.shape[1] if leaf == "weight" else math.prod(p.shape[:-1])
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        elif leaf in ("cls_token", "pos_embed", "bg_token"):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    return model
