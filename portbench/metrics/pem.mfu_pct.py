"""pem.mfu_pct: the PEM's floating-point operations for the instances
served in the traced window (padding rows not counted), over those
frames' wall time served once without the profiler
(`harness/trace.plain_seconds`), as a share of one H100's bf16 peak,
989 TFLOP/s.  The operations per instance are the plain reference's,
counted by FlopCounterMode (`drivers/pem_serve.flops_per_instance`)."""

from portbench.harness.peaks import PEAK_FLOPS


def read(rec):
    plain = rec.extra.get("plain_s")
    if rec.profile is None or not plain or not rec.frames \
            or not rec.flops_per_instance:
        return None
    flops = rec.flops_per_instance * sum(f["n"] for f in rec.frames
                                         if f["ok"])
    return 100.0 * flops / plain / PEAK_FLOPS["bfloat16"]
