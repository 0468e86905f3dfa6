"""ism.encoder_ms: the median over the traced frames of the detector's
`encoder` stage (the frame's resize, SAM's preprocess and the ViT-H
encoder), as `utils/timer.StageTimer(sync=True)` times it: CUDA events
around the stage, which waits for its device work before its end event."""

import statistics


def read(rec):
    ms = rec.stage_ms.get("encoder")
    return statistics.median(ms) if rec.trace and ms else None
