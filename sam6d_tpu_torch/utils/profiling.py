"""Profiler hook: a `torch.profiler` trace with the program's spans.

Counterpart of `sam6d_tpu/utils/profiling.py` (jax.profiler traces over
the stage-print format of `utils/timer.StageTimer`).  The trace is
Chrome's JSON format (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity

from sam6d_tpu_torch.utils import timer


@contextlib.contextmanager
def trace(log_dir: str = "log/trace", enabled: bool = True,
          cpu: bool = False):
    """Profile the block and write the Chrome trace
    `trace_<pid>_<ns>.json` into `log_dir`, with the spans and counters
    the program records inside it (`utils/timer.stage`, `count`) as
    events on the profiler's clock.  The CUDA activity alone is recorded
    when a card is visible: the CPU activity, a record of every aten op,
    stretches a launch-bound frame 1.3-2x; `cpu=True` adds it, and it is
    the one recorded without a card.  Yields the `torch.profiler.profile`
    (None when not enabled), whose `key_averages()` a caller may read
    after the block.

        with profiling.trace("build/trace"):
            with timer.stage(None, "request"):
                runner.infer(batch)
    """
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = []
    if cpu or not torch.cuda.is_available():
        activities.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with timer.recording() as rec:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(rec.chrome_events(
        os.getpid(), int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
