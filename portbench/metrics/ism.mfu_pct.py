"""ism.mfu_pct: the ISM's floating-point operations for the frames served
in the traced window, over those frames' wall time served once without
the profiler (`harness/trace.plain_seconds`), as a share of one H100's
bf16 peak, 989 TFLOP/s.  A frame's operations are the plain reference's,
counted by FlopCounterMode: the SAM encoder and every grid prompt's
decode once, DINOv2-L once for each proposal that reached the descriptor
(padding rows not counted; `drivers/ism_serve.flops_per_frame`)."""

from portbench.harness.peaks import PEAK_FLOPS


def read(rec):
    plain = rec.extra.get("plain_s")
    if rec.profile is None or not plain or not rec.flops_per_frame:
        return None
    return 100.0 * sum(rec.flops_per_frame) / plain / PEAK_FLOPS["bfloat16"]
