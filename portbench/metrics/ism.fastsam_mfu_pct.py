"""ism.fastsam_mfu_pct: the least time the card could take for the ISM
frames served in the traced window, over those frames' wall time served
once without the profiler (`harness/trace.plain_seconds`), in percent:
FastSAM-x's operations at the float32 peak (67 TFLOP/s; it runs in
float32 with TF32 off) plus DINOv2-L's at the bf16 peak (989 TFLOP/s),
the reference's operations counted by FlopCounterMode, DINOv2-L once
for each proposal that reached the descriptor (padding rows not
counted; `drivers/ism_fastsam_serve.flops_per_frame`).  The whole
frame's share of the card's peaks."""

from portbench.harness.peaks import PEAK_FLOPS


def read(rec):
    plain = rec.extra.get("plain_s")
    if rec.profile is None or not plain or not rec.flops_per_frame:
        return None
    need = sum(f32 / PEAK_FLOPS["float32"] + bf16 / PEAK_FLOPS["bfloat16"]
               for f32, bf16 in rec.flops_per_frame)
    return 100.0 * need / plain
