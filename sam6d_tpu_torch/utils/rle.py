"""COCO-style run-length encoding for masks (host numpy).

Counterpart of `sam6d_tpu/utils/rle.py` (reference Instance_Segmentation_
Model/model/utils.py:25-43, Pose_Estimation_Model/utils/data_utils.py:
72-89): column-major ('F') order, counts starting with the zero run.  The
JAX package may encode and decode through its native C helper; this copy
is the numpy formulation, which gives the same counts and masks.
`rle_to_mask` also reads COCO's compressed string counts (pycocotools
`rleFrString`), which reference-produced jsons hold.
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


def rle_to_mask(rle: dict) -> np.ndarray:
    """{"counts", "size"} -> binary (H, W) mask, from the uncompressed
    list form or COCO's compressed string form."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    counts = np.asarray(counts, np.int64)
    vals = np.zeros(len(counts), bool)
    vals[1::2] = True
    flat = np.repeat(vals, counts)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, bool)])
    return flat[: h * w].reshape((h, w), order="F")


def _decode_compressed_counts(s) -> list[int]:
    """COCO compressed RLE string -> run counts (LEB128-style with delta
    coding, cf. pycocotools rleFrString)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts
