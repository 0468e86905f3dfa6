"""What one run of a cell measured, for the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    cell: str
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    # Serving: one entry per frame served in the window, in order:
    # {"frame", "n", "bucket", "ms", "ok"} (PEM) or {"ms", "ok", ...}.
    frames: list = field(default_factory=list)
    # Training: one entry per step, {"samples", "ok"}.
    steps: list = field(default_factory=list)
    failures: list = field(default_factory=list)  # failed frames / steps
    check_errors: list = field(default_factory=list)  # unjudgeable answers
    memory_peak_bytes: int = 0
    launches: dict = field(default_factory=dict)  # wrapper calls by kernel
    profile: object = None  # harness.trace.Profile of a --trace 1 run
    stage_ms: dict = field(default_factory=dict)  # stage -> [ms a frame]
    flops_per_instance: float | None = None
    flops_per_frame: list = field(default_factory=list)
    flops_per_step: float | None = None
    extra: dict = field(default_factory=dict)
    # The check: numbers compared with limits, and how long it took.
    numbers: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    judged: int = 0
    check_s: float = 0.0

    @property
    def attempted(self) -> int:
        return len(self.frames) + len(self.steps)

    @property
    def failed(self) -> int:
        return (sum(not f["ok"] for f in self.frames)
                + sum(not s["ok"] for s in self.steps))

    @property
    def correct(self) -> bool:
        return (not self.check_errors and bool(self.limits)
                and self.judged > 0
                and all(k in self.numbers and self.numbers[k] <= lim
                        for k, lim in self.limits.items()))
