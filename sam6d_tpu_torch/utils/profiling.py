"""Profiler hooks: a `torch.profiler` trace and named spans.

Counterpart of `sam6d_tpu/utils/profiling.py` (jax.profiler traces over
the stage-print format of `utils/timer.StageTimer`).  The trace is
Chrome's JSON format (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str = "log/trace", enabled: bool = True):
    """Profile the block over the CPU and, when a card is visible, CUDA,
    and write the Chrome trace `trace_<pid>_<ns>.json` into `log_dir`.
    Yields the `torch.profiler.profile` (None when not enabled), whose
    `key_averages()` a caller may read after the block.

        with profiling.trace("build/trace"):
            with profiling.annotate("request"):
                runner.infer(batch)
    """
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named span in the trace (host side, and the device work it
    launches), for labelling pipeline stages."""
    return torch.profiler.record_function(name)
