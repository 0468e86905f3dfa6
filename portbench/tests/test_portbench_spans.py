"""The program's spans over a made-up kineto timeline (`harness/spans.py`):
kernels go to the innermost span open at their launch (by correlation
id), idle gaps to the span open at their midpoint; `Profile`'s own
reductions do not move; the span readers read nothing without a trace;
and the program's row counters agree with `pem_runner.pad_pct`."""

from __future__ import annotations

import random
import sys
from types import SimpleNamespace

import pytest

from portbench.harness import spans
from portbench.harness.cells import load_reader
from portbench.harness.record import Record
from portbench.harness.trace import Profile
from portbench.tests import tiny

READERS = ("pem.solve_kernels_per_frame", "pem.solve_idle_pct",
           "ism.select_idle_pct", "train.forward_idle_ms",
           "train.optimizer_idle_ms")


class Ev:
    """A kineto event as `Profile` and `harness/spans.py` read it."""

    def __init__(self, name, start, end, corr, device=False, tid=1):
        self._v = (name, start, end - start, corr, device, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[4] else "DeviceType.CPU"

    def start_thread_id(self):
        return self._v[5]

    def is_hidden_event(self):
        return False


EVENTS = [
    Ev("cudaLaunchKernel", 150, 160, 1),  # in pem.forward
    Ev("cudaLaunchKernel", 350, 360, 2),  # in pem.coarse_solve
    Ev("cudaMemcpyAsync", 850, 960, 3),  # in pem_runner.download
    Ev("cudaLaunchKernel", 1200, 1210, 4),  # in no span
    Ev("kernel_a", 200, 300, 1, device=True),
    Ev("kernel_b", 400, 500, 2, device=True),
    Ev("Memcpy DtoH (Device -> Pageable)", 900, 950, 3, device=True),
    Ev("kernel_a", 1250, 1300, 4, device=True),
    Ev("kernel_c", 1400, 1410, 99, device=True),  # its launch not traced
]
# name, start, end, parent, request, thread (the recorder's layout)
SPANS = [["pem_runner.infer", 0, 1000, None, 1, 7],
         ["pem.forward", 100, 800, 0, 1, 7],
         ["pem.coarse_solve", 300, 600, 1, 1, 7],
         ["pem_runner.download", 800, 1000, 0, 1, 7],
         ["elsewhere", 0, 2000, None, None, 9]]  # a thread with fewer spans


def profile():
    p = Profile.__new__(Profile)
    p._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: EVENTS)))
    p._reduce(p._events())
    return p


def recorder(monkeypatch):
    from sam6d_tpu_torch.utils.timer import Recording

    rec = Recording()
    rec.spans = [list(s) for s in SPANS]
    monkeypatch.setitem(sys.modules, spans.RECORDER,
                        SimpleNamespace(PROFILED=rec))
    return rec


def reductions(p):
    return (p.busy_s, p.n_device, dict(p.idle_gaps), dict(p.device_ops),
            p.breakdown())


def test_kernels_go_to_the_innermost_span_and_gaps_by_their_midpoint():
    from sam6d_tpu_torch.utils.timer import Recording

    device, launches = spans.kineto(profile())
    assert launches == {1: 150, 2: 350, 3: 850, 4: 1200}
    rec = Recording()
    rec.spans = [list(s) for s in SPANS]
    att = spans.attribute(device, launches, SPANS, rec.self_ns())
    n = att["names"]
    assert set(n) == {"pem_runner.infer", "pem.forward", "pem.coarse_solve",
                      "pem_runner.download"}
    assert (n["pem.forward"]["kernels"], n["pem.coarse_solve"]["kernels"],
            n["pem_runner.download"]["kernels"]) == (1, 1, 0)
    assert n["pem_runner.download"]["device_ms"] == pytest.approx(50e-6)
    # Gaps 300-400 (midpoint in the solve), 500-900 (at 700: the solve
    # has ended, pem.forward holds it), 950-1250 and 1300-1400 (none).
    assert n["pem.coarse_solve"]["idle_ms"] == pytest.approx(100e-6)
    assert n["pem.forward"]["idle_ms"] == pytest.approx(400e-6)
    assert n["pem.forward"]["tree_idle_ms"] == pytest.approx(500e-6)
    assert n["pem_runner.infer"]["tree_kernels"] == 2
    assert att["idle_ms"] == pytest.approx(900e-6)
    assert att["idle_unheld_ms"] == pytest.approx(400e-6)
    assert (att["kernels"], att["kernels_unheld"]) == (4, 2)
    assert n["pem.forward"]["host_ms"] == pytest.approx(700e-6)
    assert n["pem.forward"]["self_ms"] == pytest.approx(400e-6)


def random_events(seed):
    """A launching thread's runtime calls and their device operations,
    some overlapping, some apart, a few with no traced launch."""
    rng = random.Random(seed)
    events, t, d = [], 0, 0
    for c in range(1, 200):
        t += rng.randint(1, 40)
        events.append(Ev("cudaLaunchKernel", t, t + 5, c))
        d = max(d + rng.randint(-20, 30), t + 6)
        events.append(Ev(f"k{c % 7}", d, d + rng.randint(1, 50),
                         c if rng.random() > 0.05 else 10_000 + c,
                         device=True))
    return events


@pytest.mark.parametrize("seed", [None, 1, 2, 3])
def test_span_idle_is_the_profiles_idle_gaps_on_the_same_events(seed):
    """spans.py cuts the gaps between device intervals as Profile does:
    the idle it attributes sums to Profile.idle_gaps'."""
    events = EVENTS if seed is None else random_events(seed)
    p = Profile.__new__(Profile)
    p._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    p._reduce(p._events())
    att = spans.attribute(*spans.kineto(p), SPANS)
    assert att["idle_ms"] > 0
    assert att["idle_ms"] == pytest.approx(1e3 * sum(p.idle_gaps.values()))


def test_profile_reductions_are_the_same_with_and_without_spans(monkeypatch,
                                                                capsys):
    bare = reductions(profile())
    recorder(monkeypatch)
    rec = Record(cell="pem_base.bin", seed=1, trace=True)
    rec.frames = [{"n": 2, "bucket": 2, "ms": 1.0, "ok": True}]
    rec.profile = profile()
    assert spans.of(rec) is spans.of(rec) is not None
    assert reductions(rec.profile) == bare
    assert "pem.coarse_solve" in capsys.readouterr().err


def test_the_span_readers_read_the_attribution(monkeypatch):
    recorder(monkeypatch)
    rec = Record(cell="pem_base.bin", seed=1, trace=True)
    rec.frames = [{"n": 2, "bucket": 2, "ms": 1.0, "ok": True}]
    rec.profile = profile()
    got = {m: load_reader(m).read(rec) for m in READERS}
    assert got["pem.solve_kernels_per_frame"] == 1
    # 100 of the window's 900 idle ns lie in the coarse solve.
    assert got["pem.solve_idle_pct"] == pytest.approx(100 / 9)
    for m in ("ism.select_idle_pct", "train.forward_idle_ms",
              "train.optimizer_idle_ms"):
        assert got[m] is None  # no such span in this program's record


@pytest.mark.parametrize("traced", [False, True])
def test_each_span_reader_reads_nothing_without_a_trace(monkeypatch, traced):
    """Untraced, or traced where the program records no span (a checkout
    before the recorder): every reader returns None."""
    if traced:
        monkeypatch.setitem(sys.modules, spans.RECORDER, SimpleNamespace())
    rec = Record(cell="pem_base.bin", seed=1, trace=traced)
    rec.frames = [{"n": 2, "bucket": 2, "ms": 1.0, "ok": True}]
    rec.steps = [{"samples": 2, "ok": True}]
    rec.profile = profile() if traced else None
    for m in READERS:
        assert load_reader(m).read(rec) is None, m


def test_the_row_counters_give_pad_pct():
    """pem_runner.rows and pad_rows, counted by the program over a tiny
    bin run, give the share that `pem_runner.pad_pct` reads."""
    from sam6d_tpu_torch.utils import timer

    with timer.recording() as r:
        rec = tiny.run("pem_base.bin", seconds=0.5)
    rec.profile = object()
    k = len(rec.frames)  # the window's frames, after the warm-up's
    rows = [c[1] for c in r.counts if c[0] == "pem_runner.rows"][-k:]
    pad = [c[1] for c in r.counts if c[0] == "pem_runner.pad_rows"][-k:]
    assert rows == [f["n"] for f in rec.frames]
    assert pad == [f["bucket"] - f["n"] for f in rec.frames]
    assert 100.0 * sum(pad) / (sum(pad) + sum(rows)) == pytest.approx(
        load_reader("pem_runner.pad_pct").read(rec))
