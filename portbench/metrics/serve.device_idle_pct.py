"""serve.device_idle_pct: the share of the traced frames' wall time in
which no kernel, copy or set ran on the card: the device's busy time
from torch.profiler over the same frames served once without the
profiler (`harness/trace.plain_seconds`)."""


def read(rec):
    p, plain = rec.profile, rec.extra.get("plain_s")
    if p is None or not rec.frames or not plain:
        return None
    return 100.0 * (1.0 - p.busy_s / plain)
