"""ism.descriptor_pad_pct: the padding rows of the descriptor's
power-of-two proposal buckets over all their rows, in the profiled
window, from the program's counters `ism.descriptor_pad_rows` and
`ism.descriptor_rows` (`ISMDetector._detect`).  While torch.profiler
runs, `utils/timer.count` appends (name, n, time, request) to the port's
`timer.PROFILED.counts`; the harness reads that record from the module
the run has loaded, and reads None where the program counts neither."""

import sys

from portbench.harness.spans import RECORDER


def read(rec):
    got = getattr(sys.modules.get(RECORDER), "PROFILED", None)
    if not rec.trace or rec.profile is None or got is None:
        return None
    rows = pad = 0
    for name, n, _, _ in got.counts:
        if name == "ism.descriptor_rows":
            rows += n
        elif name == "ism.descriptor_pad_rows":
            pad += n
    return 100.0 * pad / rows if rows else None
