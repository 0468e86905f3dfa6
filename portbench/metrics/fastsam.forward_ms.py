"""fastsam.forward_ms: the median over the traced frames of the
segmentor's `fastsam_forward` stage (the frame's upload, FastSAM-x's
network, the box decode and the top 4 max_det anchors, and their boxes
and scores copied to the host), as `utils/timer.StageTimer(sync=True)`
times it: CUDA events around the stage, which waits for its device work
before its end event."""

import statistics


def read(rec):
    ms = rec.stage_ms.get("fastsam_forward")
    return statistics.median(ms) if rec.trace and ms else None
