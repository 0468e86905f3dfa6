"""Reading a torch.profiler trace of the measured window.

`Profile` runs torch.profiler around a block with the CUDA activity alone
(the device's kernels, copies and sets, and the host's CUDA runtime and
driver calls), not the CPU activity, whose record of every aten op more
than doubles a launch-bound frame.  It reduces the events once: the
device's busy time (the union of its kernel, copy and set intervals),
each device operation's total time by name, and the idle gaps between
device intervals, each charged to the innermost runtime call running at
its midpoint on the thread that made the most calls.  Even the CUDA
activity stretches a launch-bound frame by half, so a traced serving run
reads its idle share and MFU over `plain_seconds`.  The kernel-name
helpers are frozen copies of
`chip_smoke.entry_name` and the name tests of `chip_smoke.device_time` /
`flash_device_time`.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict


def entry_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last component of the
    nested name, with integer and bool template arguments spelled out;
    other names pass through."""
    if not mangled.startswith("_ZN"):
        return mangled
    rest, name = mangled[3:], mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group(0))
        name = rest[m.end():m.end() + n]
        rest = rest[m.end() + n:]
    t = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if t:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", t.group(1))) + ">"
    return name


def short_name(name: str, width: int = 80) -> str:
    """A device operation's name for a report: demangled where mangled,
    the argument list dropped, at most `width` characters."""
    name = entry_name(name)
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:  # drop "(...)" argument lists, keep template args
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:width]


def is_flash_bias(name: str) -> bool | None:
    """True for K4 (flash attention with SAM's rel-pos bias), False for K5
    (without), None for any other kernel: the kernels are
    `flash_fwd_mma_kernel<DK, MT, BIAS>` and `flash_fwd_kernel<DV, BIAS>`,
    demangled or not."""
    if "flash_fwd" not in name:
        return None
    if "flash_fwd_mma_kernelI" in name or "flash_fwd_kernelI" in name:
        return "Lb1E" in name
    return name.split(">")[0].rstrip().endswith(("true", "1"))


# Records that are no operation (torch.profiler leaves them out too).
SKIP = ("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
        "profiler::_record_function_enter_new",
        "profiler::_record_function_exit")


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def plain_seconds(serve, n: int, sync) -> float:
    """Wall seconds of serve(k) for k < n with no profiler running, from
    one synchronise to the next.  A traced serving run serves its traced
    frames so first: its idle share and MFU are read over this window,
    since the profiler's callbacks stretch a launch-bound frame by half
    (PERF.md); the device's busy time comes from the profile."""
    sync()
    start = time.perf_counter()
    for k in range(n):
        serve(k)
    sync()
    return time.perf_counter() - start


class Profile:
    """with Profile() as p: ...work ending in torch.cuda.synchronize()...
    A gap with no runtime call running on that thread is charged to
    "(python between ops)": the host's own work between launches.
    then p.busy_s, p.window_s, p.device_ops {name: [seconds, count]},
    p.idle_gaps {host op: seconds}, p.reduce_s."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            t0 = time.perf_counter()
            self._reduce(self._events())
            self.reduce_s = time.perf_counter() - t0
        return False

    def _events(self):
        """(on the device, start us, end us, name, thread) of every event,
        from the raw kineto results."""
        raw = self._prof.profiler.kineto_results.events()
        return [(str(e.device_type()).endswith("CUDA"),
                 e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3, e.name(),
                 e.start_thread_id()) for e in raw
                if e.name() not in SKIP and not e.is_hidden_event()]

    def _reduce(self, events):
        """events: (on the device, start us, end us, name, thread)."""
        device, host = [], defaultdict(list)
        for on_device, start, end, name, thread in events:
            if on_device:
                device.append((start, end, name))
            else:
                host[thread].append((start, end, name))
        device.sort()
        self.n_device = len(device)
        self.busy_s = _union_s((s, e) for s, e, _ in device) / 1e6
        ops = defaultdict(lambda: [0.0, 0])
        for s, e, name in device:
            ops[name][0] += (e - s) / 1e6
            ops[name][1] += 1
        self.device_ops = dict(ops)
        # Gaps between merged device intervals, charged to the innermost
        # host op covering each gap's midpoint (main launching thread).
        gaps, end = [], None
        for s, e, _ in device:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        main = max(host.values(), key=len) if host else []
        main.sort()
        stack, i, by_op = [], 0, defaultdict(float)
        for g0, g1 in gaps:
            mid = (g0 + g1) / 2.0
            while i < len(main) and main[i][0] <= mid:
                while stack and stack[-1][1] <= main[i][0]:
                    stack.pop()
                stack.append(main[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2] if stack else "(python between ops)"
            by_op[name] += (g1 - g0) / 1e6
        self.idle_gaps = dict(by_op)

    def kernel_s(self, test) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name
        passes test(name)."""
        sec, n = 0.0, 0
        for name, (s, c) in self.device_ops.items():
            if test(name):
                sec += s
                n += c
        return sec, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((short_name(k), v[0]) for k, v in
                      self.device_ops.items()), key=lambda r: -r[1])
        merged = defaultdict(float)
        for k, v in ops:
            merged[k] += v
        ops = sorted(merged.items(), key=lambda r: -r[1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda r: -r[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k[:80], v] for k, v in gaps]}
