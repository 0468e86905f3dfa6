"""hiera_attn_roofline: K5's (`csrc/flash_rpe.cu` without a bias) least
possible time for SAM 2's Hiera attention in the profiled window over
K5's device time there inside the program's `encoder` spans, in percent
(DINOv2's K5 calls lie outside them).  A call on BH heads of Nq queries
against Nk keys of width d: q k^T and P v, 4 BH Nq Nk d operations; q
and the output, k and v each read or written once, es BH d (2 Nq + 2 Nk)
bytes, through `peaks.bound_s`.  The calls are those that
`drivers/ism_sam2_serve.hiera_calls` lists (every block of every traced
frame); a
kernel launched inside `encoder` is placed by its launch's host time, as
`harness/spans.py` places kernels.  None where the program's counters
show no Hiera rows served by K5 (`hiera.attn_rows_window`, `_pooled`,
`_global`), where the profile or the spans are missing, or where the
K5 launches inside `encoder` are not the calls counted."""

import sys

from portbench.harness import spans
from portbench.harness.peaks import bound_s
from portbench.harness.trace import SKIP, is_flash_bias

KINDS = ("hiera.attn_rows_window", "hiera.attn_rows_pooled",
         "hiera.attn_rows_global")


def encoder_k5_s(profile):
    """(seconds, launches) of K5 launched inside an `encoder` span, or
    None without the profiler's events or the program's spans."""
    prof = getattr(profile, "_prof", None)
    got = spans.program_spans()
    if prof is None or got is None:
        return None
    windows = [(s[1], s[2]) for s in got[0]
               if s[0] == "encoder" and s[2] is not None]
    durations, launches = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in SKIP or e.is_hidden_event():
            continue
        c = e.correlation_id()
        if str(e.device_type()).endswith("CUDA"):
            if is_flash_bias(name) is False:
                durations[c] = durations.get(c, 0) + e.duration_ns()
        elif c:
            launches[c] = min(launches.get(c, e.start_ns()), e.start_ns())
    sec, n = 0.0, 0
    for c, ns in durations.items():
        t = launches.get(c)
        if t is not None and any(a <= t <= b for a, b in windows):
            sec += ns / 1e9
            n += 1
    return sec, n


def read(rec):
    calls = rec.extra.get("calls", {}).get("hiera_attn")
    got = spans.program_spans()
    if not rec.trace or rec.profile is None or not calls or got is None:
        return None
    counts = sys.modules[spans.RECORDER].PROFILED.counts
    if not sum(n for name, n, _, _ in counts if name in KINDS):
        return None
    k5 = encoder_k5_s(rec.profile)
    if k5 is None or k5[0] <= 0 or k5[1] != len(calls):
        return None
    need = sum(bound_s(es * BH * d * (2 * Nq + 2 * Nk), 4 * BH * Nq * Nk * d,
                       "bfloat16" if es == 2 else "float32")
               for BH, Nq, Nk, d, es in calls)
    return 100.0 * need / k5[0]
