"""Named stage timings for one run of a pipeline.

`StageTimer.stage(name)` brackets a block with CUDA events on the card
(no synchronisation inside the run) or with the host clock on the CPU;
`report()` synchronises once and returns milliseconds per stage, summed
over repeats.  The events time the device's queue: a stage's host work
that overlaps the device work queued before it counts for nothing.  With
`sync=True` each stage waits for its device work before its end event,
so the events bracket the stage's wall time (the file demo, whose stages
are host and device work in turn).  The pipelines take `timer=None` and
then time nothing.
"""

from __future__ import annotations

import contextlib
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


def stage(timer: StageTimer | None, name: str):
    """`timer.stage(name)`, or a no-op without a timer."""
    return timer.stage(name) if timer is not None else contextlib.nullcontext()
