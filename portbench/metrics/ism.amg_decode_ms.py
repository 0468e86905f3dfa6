"""ism.amg_decode_ms: the median over the traced frames of the detector's
`amg_decode` stage (the mask decoder over every grid prompt, K6's
statistics, the top-K's exact logits and their copy to the host), as
`utils/timer.StageTimer(sync=True)` times it: CUDA events around the
stage, which waits for its device work before its end event."""

import statistics


def read(rec):
    ms = rec.stage_ms.get("amg_decode")
    return statistics.median(ms) if rec.trace and ms else None
