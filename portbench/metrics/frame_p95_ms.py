"""frame_p95_ms: the 95th percentile over all frames completed in the
window, each from its submission to its result on the host."""

from portbench.harness.stats import percentile


def read(rec):
    ms = [f["ms"] for f in rec.frames if f["ok"]]
    return percentile(ms, 95) if ms and not rec.trace else None
