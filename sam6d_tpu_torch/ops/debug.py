"""An identity tap that dumps a tensor for side-by-side diffing.

Counterpart of `sam6d_tpu/ops/debug.py` (the reference's CustomDebugNode,
pointnet2_utils.py:528-549, custom_debug_node.cpp), switched on by the
JAX package's own variable, so one setting taps both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DEBUG_ENV = "SAM6D_TPU_DEBUG_TAP"


def debug_tap(x: torch.Tensor, name: str = "tap",
              out_dir: str = "output") -> torch.Tensor:
    """Return `x` unchanged.  When $SAM6D_TPU_DEBUG_TAP is set, first write
    `{out_dir}/torch_debug_node_{name}.npy` from `x.detach().cpu()`
    (bfloat16 as float32, which numpy lacks).  On a CUDA tensor the copy
    to the host synchronises the stream, so a tap costs a sync where it
    is on; off, it costs nothing."""
    if not os.environ.get(DEBUG_ENV):
        return x
    val = x.detach().cpu()
    if val.dtype == torch.bfloat16:
        val = val.float()
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"torch_debug_node_{name}.npy"), val.numpy())
    return x
