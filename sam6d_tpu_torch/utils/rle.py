"""COCO-style run-length encoding for masks (host numpy).

Counterpart of `sam6d_tpu/utils/rle.py` (reference Instance_Segmentation_
Model/model/utils.py:25-43): column-major ('F') order, counts starting
with the zero run.  The JAX package may encode through its native C
helper; this copy is the numpy formulation, which gives the same counts.
Decoding is not on the serving path and is not ported.
"""

from __future__ import annotations

import numpy as np


def mask_to_rle(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> {"counts": [...], "size": [H, W]}."""
    flat = np.asarray(mask, bool).flatten(order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    return {"counts": counts, "size": list(mask.shape)}
