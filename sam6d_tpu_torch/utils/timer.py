"""Named stage timings, and the program's spans and counters.

`StageTimer.stage(name)` brackets a block with CUDA events on the card
(no synchronisation inside the run) or with the host clock on the CPU;
`report()` synchronises once and returns milliseconds per stage, summed
over repeats.  The events time the device's queue: a stage's host work
that overlaps the device work queued before it counts for nothing.  With
`sync=True` each stage waits for its device work before its end event,
so the events bracket the stage's wall time (the file demo, whose stages
are host and device work in turn).  The pipelines take `timer=None` and
then time nothing.

`stage(timer, name)` is also the program's one span API.  While spans
are recorded, each `stage` appends a span to a `Recording`: its name,
its start and end on `time.time_ns()`'s clock (the clock torch.profiler
stamps its events with, so spans lay over a device trace), the enclosing
span, the request it serves (a frame or a step, numbered by its caller)
and its thread; `count(name, n)` adds to a counter at the same
boundaries.  Spans are recorded inside `recording()`, and, as
`torch.profiler.record_function` is, while a torch.profiler runs (into
`PROFILED`, for whoever reads that profile; a new `Recording` from the
first span or count that finds a profiler running after one that found
none, so a session's spans are never mixed with an earlier session's,
and what it holds grows no longer than the profiler's own events).
Otherwise `stage` without a timer returns one shared no-op context: no
allocation, no clock read.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


class StageTimer:
    def __init__(self, device, sync: bool = False):
        self.cuda = torch.device(device).type == "cuda"
        self.sync = sync
        self._marks = []  # (name, start, end)

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            if self.sync:
                torch.cuda.synchronize()
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._marks.append((name, start, end))

    def report(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, s, e in self._marks:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[name] = out.get(name, 0.0) + ms
        return out


class Recording:
    """Spans and counters in memory.

    spans: [name, start_ns, end_ns, parent, request, thread] a span, in
    the order they opened; parent is the enclosing span's index in
    `spans` (None at the top), request the caller's number of the frame
    or step (inherited from the enclosing span), thread the recording
    thread's native id.  end_ns is None while the span is open.
    counts: (name, n, at_ns, request) a `count` call."""

    def __init__(self):
        self.spans = []
        self.counts = []

    def clear(self) -> None:
        self.spans.clear()
        self.counts.clear()

    def self_ns(self) -> list:
        """Each span's self time: its duration less the time its
        children cover (None while it is open)."""
        out = [None if s[2] is None else s[2] - s[1] for s in self.spans]
        for s in self.spans:
            if s[3] is not None and s[2] is not None \
                    and out[s[3]] is not None:
                out[s[3]] -= s[2] - s[1]
        return out

    def chrome_events(self, pid: int, base_ns: int = 0) -> list:
        """The closed spans as Chrome trace complete events and the
        counters as running totals, at microseconds from base_ns."""
        out = []
        for name, s, e, _, request, thread in self.spans:
            if e is not None:
                out.append({"ph": "X", "cat": "program_span", "name": name,
                            "pid": pid, "tid": thread,
                            "ts": (s - base_ns) / 1e3, "dur": (e - s) / 1e3,
                            "args": {"request": request}})
        run = {}
        for name, n, at, _ in self.counts:
            run[name] = run.get(name, 0) + n
            out.append({"ph": "C", "cat": "program_counter", "name": name,
                        "pid": pid, "ts": (at - base_ns) / 1e3,
                        "args": {name: run[name]}})
        return out


_recording: Recording | None = None  # the one recording() opened
PROFILED = Recording()  # spans made while torch.profiler runs, no recording()
_profiling = False  # whether the last look found torch.profiler running
_local = threading.local()  # .open: (recording, span index, request)
_NOOP = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block into a new
    `Recording`, which it yields."""
    global _recording
    prev, rec = _recording, Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = prev


def _target() -> Recording | None:
    global PROFILED, _profiling
    if _recording is not None:
        return _recording
    on = _profiler_enabled()
    if on and not _profiling:  # a profiler session has started
        PROFILED = Recording()
    _profiling = on
    return PROFILED if on else None


class _Span:
    __slots__ = ("rec", "timed", "name", "request", "index", "prev")

    def __init__(self, rec, timed, name, request):
        self.rec, self.timed = rec, timed
        self.name, self.request = name, request

    def __enter__(self):
        prev = getattr(_local, "open", None)
        parent, request = None, self.request
        if prev is not None and prev[0] is self.rec:
            parent = prev[1]
            if request is None:
                request = prev[2]
        self.prev = prev
        spans = self.rec.spans
        self.index = len(spans)
        spans.append([self.name, time.time_ns(), None, parent, request,
                      threading.get_native_id()])
        _local.open = (self.rec, self.index, request)
        if self.timed is not None:
            self.timed.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.timed is not None:
                self.timed.__exit__(*exc)
        finally:
            self.rec.spans[self.index][2] = time.time_ns()
            _local.open = self.prev
        return False


def stage(timer: StageTimer | None, name: str, request=None):
    """`timer.stage(name)` (or nothing without a timer), recorded as a
    span while spans are recorded.  `request` numbers the frame or step
    a top-level span serves; spans inside it inherit it."""
    rec = _target()
    if rec is None:
        return timer.stage(name) if timer is not None else _NOOP
    return _Span(rec, timer.stage(name) if timer is not None else None,
                 name, request)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while spans are recorded."""
    rec = _target()
    if rec is None:
        return
    open_ = getattr(_local, "open", None)
    request = open_[2] if open_ is not None and open_[0] is rec else None
    rec.counts.append((name, int(n), time.time_ns(), request))
