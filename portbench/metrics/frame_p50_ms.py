"""frame_p50_ms: the median over all frames completed in the window,
each from its submission to its result on the host."""

from portbench.harness.stats import percentile


def read(rec):
    ms = [f["ms"] for f in rec.frames if f["ok"]]
    return percentile(ms, 50) if ms and not rec.trace else None
