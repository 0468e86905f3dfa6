"""The program's spans laid over the device trace of a --trace 1 run.

While torch.profiler runs, the port records a span at each of its layer
boundaries (`sam6d_tpu_torch/utils/timer.stage`, into `timer.PROFILED`,
which starts anew with each profiler session): name, start and end on
`time.time_ns()`'s clock, which the profiler's events carry too, the
enclosing span and the frame or step it serves.
The harness imports nothing of the port: it reads that record from the
port's module the run has loaded, and finds nothing in a checkout whose
program records no spans.

`attribute` places each device operation in the innermost span open
when the host launched it (the runtime call with the operation's
correlation id; backward kernels are launched from autograd's thread
while the main thread waits in its span), and each idle gap between
device intervals (cut as `trace.Profile` cuts them) in the innermost
span open at the gap's midpoint.  The spans read are those of the thread
that recorded the most (the profiler's thread ids are not the system's).
`Profile`'s own reductions are not touched; the gaps here are cut from
the same events as `Profile.idle_gaps`, and sum to them (a test holds it).

The profiled pass stretches the host's time (the CUDA activity's
callbacks), so the metrics read counts and shares of the idle, not host
milliseconds: those wait for a pass recorded without the profiler.
"""

from __future__ import annotations

import sys
from collections import defaultdict

from portbench.harness.trace import SKIP

RECORDER = "sam6d_tpu_torch.utils.timer"
COPY = ("Memcpy", "Memset")


def program_spans():
    """The spans the program recorded while the profiler ran, with their
    self times, or None where it records none."""
    timer = sys.modules.get(RECORDER)
    rec = getattr(timer, "PROFILED", None)
    if rec is None or not rec.spans:
        return None
    return rec.spans, rec.self_ns()


def kineto(profile):
    """(device operations [(start_ns, end_ns, correlation, is_kernel)],
    launches {correlation: host start_ns}) from a Profile's raw events."""
    prof = getattr(profile, "_prof", None)
    if prof is None:
        return None
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in SKIP or e.is_hidden_event():
            continue
        s = e.start_ns()
        c = e.correlation_id()
        if str(e.device_type()).endswith("CUDA"):
            device.append((s, s + e.duration_ns(), c,
                           not name.startswith(COPY)))
        elif c:
            launches[c] = min(launches.get(c, s), s)
    return device, launches


def _innermost(spans, points):
    """For each point (sorted), the innermost of `spans` holding it, or
    None.  spans: (start, end, index) sorted by start and nested."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def attribute(device, launches, spans, self_ns=None) -> dict:
    """device: [(start_ns, end_ns, correlation, is_kernel)]; launches:
    {correlation: host start_ns}; spans: the recorder's [name, start_ns,
    end_ns, parent, request, thread].  Returns, by span name: "n"
    instances, "host_ms", "self_ms", the operations launched inside
    ("kernels", copies and sets left out; "device_ms", all), "idle_ms"
    of the gaps whose midpoint it holds, and the same of its subtree
    ("tree_kernels", "tree_idle_ms"); and the totals and the parts no
    span holds."""
    if self_ns is None:
        self_ns = [None] * len(spans)
    by_thread = defaultdict(list)
    for i, s in enumerate(spans):
        if s[2] is not None:
            by_thread[s[5]].append((s[1], s[2], i))
    main = max(by_thread.values(), key=len) if by_thread else []
    main.sort()
    stat = defaultdict(lambda: [0, 0.0, 0.0])  # index -> kernels, dev, idle

    ops = sorted((launches[c], s, e, k) for s, e, c, k in device
                 if c in launches)
    held = _innermost(main, [o[0] for o in ops])
    kernels = unheld_k = 0
    for (_, s, e, k), i in zip(ops, held):
        kernels += k
        if i is None:
            unheld_k += k
            continue
        stat[i][0] += k
        stat[i][1] += (e - s) / 1e6
    kernels += sum(k for _, _, c, k in device if c not in launches)
    unheld_k += sum(k for _, _, c, k in device if c not in launches)

    gaps, end = [], None
    for s, e, _, _ in sorted(device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    held = _innermost(main, [(a + b) / 2 for a, b in gaps])
    idle = unheld_idle = 0.0
    for (a, b), i in zip(gaps, held):
        ms = (b - a) / 1e6
        idle += ms
        if i is None:
            unheld_idle += ms
        else:
            stat[i][2] += ms

    names = defaultdict(lambda: dict(n=0, host_ms=0.0, self_ms=0.0,
                                     kernels=0, device_ms=0.0, idle_ms=0.0,
                                     tree_kernels=0, tree_idle_ms=0.0))
    for _, _, i in main:
        name, s, e = spans[i][:3]
        row = names[name]
        row["n"] += 1
        row["host_ms"] += (e - s) / 1e6
        own = self_ns[i] if self_ns[i] is not None else e - s
        row["self_ms"] += own / 1e6
    for i, (k, dev, gap) in stat.items():
        row = names[spans[i][0]]
        row["kernels"] += k
        row["device_ms"] += dev
        row["idle_ms"] += gap
        j, seen = i, set()
        while j is not None:  # the span and its ancestors, each name once
            if spans[j][0] not in seen:
                seen.add(spans[j][0])
                names[spans[j][0]]["tree_kernels"] += k
                names[spans[j][0]]["tree_idle_ms"] += gap
            j = spans[j][3]
    return {"names": {k: dict(v) for k, v in names.items()},
            "kernels": kernels, "kernels_unheld": unheld_k,
            "idle_ms": idle, "idle_unheld_ms": unheld_idle}


def of(rec):
    """The attribution of a traced run's profiled window, computed once
    (and its table printed to standard error), or None where the run was
    not traced or the program recorded no span."""
    if "spans" in rec.extra:
        return rec.extra["spans"]
    got = None
    units = len(rec.frames) or len(rec.steps)
    if rec.trace and rec.profile is not None and units:
        spans = program_spans()
        trace = kineto(rec.profile)
        if spans is not None and trace is not None:
            got = attribute(*trace, *spans)
            got["units"] = units
            print_table(got, sys.stderr)
    rec.extra["spans"] = got
    return got


def tree_per_unit(rec, names, key: str):
    """`key` ("tree_idle_ms" or "tree_kernels") of the spans `names`,
    summed, over the frames or steps of the window."""
    att = of(rec)
    if att is None or not any(n in att["names"] for n in names):
        return None
    return sum(att["names"][n][key] for n in names
               if n in att["names"]) / att["units"]


def idle_share(rec, names):
    """The share (%) of the profiled window's idle time, between the
    device's operations, whose gaps fall in the spans `names` or under
    them.  A share, not milliseconds: the profiler's callbacks stretch
    the host's time, and with it the idle, in every span."""
    att = of(rec)
    if att is None or not att["idle_ms"] \
            or not any(n in att["names"] for n in names):
        return None
    return 100.0 * sum(att["names"][n]["tree_idle_ms"] for n in names
                       if n in att["names"]) / att["idle_ms"]


def print_table(att: dict, out) -> None:
    u = att["units"]
    print(f"spans over {u} frames or steps (a frame or step each): count, "
          "host ms, self ms, kernels, device ms, idle ms held", file=out)
    for name, r in sorted(att["names"].items(), key=lambda kv: -kv[1]
                          ["host_ms"]):
        print(f"  {name:24s} {r['n'] / u:7.2f} {r['host_ms'] / u:9.3f} "
              f"{r['self_ms'] / u:9.3f} {r['kernels'] / u:8.1f} "
              f"{r['device_ms'] / u:9.3f} {r['idle_ms'] / u:9.3f}", file=out)
    print(f"  no span: {att['kernels_unheld']} of {att['kernels']} kernels, "
          f"{att['idle_unheld_ms']:.3f} of {att['idle_ms']:.3f} idle ms",
          file=out)
