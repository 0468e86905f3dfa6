"""two_way_roofline (K9) against a hand count on a made-up profile and
counter record, and nothing where the program counts no fused rows."""

from __future__ import annotations

import sys
import types

import pytest

from portbench.harness import spans
from portbench.harness.cells import load_reader
from portbench.harness.record import Record
from portbench.harness.trace import Profile


def _profile(ops: dict):
    p = Profile.__new__(Profile)
    p.device_ops = {k: [v, 1] for k, v in ops.items()}
    p.busy_s, p.window_s = sum(ops.values()), 1.0
    return p


def _program(monkeypatch, counts):
    prof = types.SimpleNamespace(counts=counts)
    monkeypatch.setitem(sys.modules, spans.RECORDER,
                        types.SimpleNamespace(PROFILED=prof))


def test_two_way_roofline_is_the_hand_count(monkeypatch):
    read = load_reader("two_way_roofline").read
    rec = Record(cell="x", seed=1, trace=True)
    rec.profile = _profile({
        "void (anonymous namespace)::two_way_mma_kernel<float, 1>("
        "(anonymous namespace)::Params)": 2e-4,
        "void (anonymous namespace)::two_way_mma_kernel<__nv_bfloat16, 1>("
        "(anonymous namespace)::Params)": 3e-4,
        "decode_tail_mma_kernel": 9.0})
    # Two calls of 64 prompts x 4096 rows, and rows the plain version
    # served (not the kernel's).
    _program(monkeypatch, [("sam.key_rows_fused", 64 * 4096, 0, 1),
                           ("sam.key_rows_plain", 7, 0, 1),
                           ("sam.key_rows_fused", 64 * 4096, 0, 1)])
    rows = 2 * 64 * 4096
    # 1 KB written a row at 3.35 TB/s outweighs 262,144 operations at
    # 989 TFLOP/s: bound by bytes.
    need = max(rows * 1024 / 3.35e12, rows * 262144 / 989e12)
    assert need == rows * 1024 / 3.35e12
    assert read(rec) == pytest.approx(100 * need / 5e-4)


def test_two_way_roofline_reads_nothing_without_fused_rows(monkeypatch):
    read = load_reader("two_way_roofline").read
    rec = Record(cell="x", seed=1, trace=True)
    rec.profile = _profile({"two_way_mma_kernel<float, 1>": 1e-4})
    monkeypatch.delitem(sys.modules, spans.RECORDER, raising=False)
    assert read(rec) is None  # no program record
    _program(monkeypatch, [("sam.key_rows_plain", 4096, 0, 1),
                           ("ism.descriptor_rows", 256, 0, 1)])
    assert read(rec) is None  # the parent's program: no such counter
    _program(monkeypatch, [("sam.key_rows_fused", 4096, 0, 1)])
    assert read(rec) is not None
    rec.profile = _profile({"decode_tail_mma_kernel": 1e-4})
    assert read(rec) is None  # counted, but no K9 time in the profile
    rec.trace, rec.profile = False, None
    assert read(rec) is None
