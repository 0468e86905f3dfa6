"""Roofline and FLOP counts against hand counts at small shapes, and the
trace reduction on a made-up timeline."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import peaks
from portbench.harness.cells import load_reader
from portbench.harness.record import Record
from portbench.harness.trace import Profile, entry_name, is_flash_bias


def _profile(ops: dict, window_s: float = 1.0):
    p = Profile.__new__(Profile)
    p.device_ops = {k: [v, 1] for k, v in ops.items()}
    p.busy_s, p.window_s = sum(ops.values()), window_s
    return p


def test_fps_roofline_is_the_hand_count():
    rec = Record(cell="x", seed=1, trace=True)
    rec.frames = [{"n": 1, "bucket": 2, "ms": 1.0, "ok": True}]
    rec.extra["calls"] = {"fps": [(2, 2048, 196)]}
    rec.profile = _profile({"void fps_kernel<8, 256>(float const*)": 1e-4})
    # 2 rows of 2048 points: 49152 bytes read, 3136 written; 195 steps
    # of 10 operations a point: 7,987,200 at 67 TFLOP/s.
    t = max((2 * 2048 * 12 + 2 * 196 * 8) / 3.35e12,
            2 * 195 * 2048 * 10 / 67e12)
    assert load_reader("fps_roofline").read(rec) == pytest.approx(
        100 * t / 1e-4)


def test_geo_embed_and_k3_k7_rooflines_are_the_hand_counts():
    rec = Record(cell="x", seed=1, trace=True)
    rec.extra["calls"] = {"geo_embed": [(1, 4, 32, 2)],
                          "geo_embed_bwd": [(2, 4, 32, 2)],
                          "scatter_rows": [(1, 8, 4, 32)]}
    rec.launches = {"geo_embed_bwd": 1, "scatter_rows": 1}
    rec.profile = _profile({"geo_embed_fwd_mma_kernel": 1e-5,
                            "geo_embed_bwd_kernel": 2e-5,
                            "geo_embed_bwd_fold": 1e-5,
                            "scatter_rows_sum_kernel": 4e-6})
    pairs = 16
    fwd = max((pairs * (16 + 64) + 68 * 64 + 128) / 3.35e12,
              pairs * (2 * 124 * 32 + 3 * 124) / 989e12)
    assert load_reader("geo_embed_roofline").read(rec) == pytest.approx(
        100 * fwd / 1e-5)
    bwd = max((32 * (64 + 32 + 16) + 69 * 128) / 3.35e12,
              32 * 32 * 2 * 124 / 989e12)
    assert load_reader("geo_embed_bwd_roofline").read(rec) == pytest.approx(
        100 * bwd / 3e-5)
    k7 = max((8 * 72 + 4 * 128) / 3.35e12, 8 * 32 / 67e12)
    assert load_reader("scatter_rows_roofline").read(rec) == pytest.approx(
        100 * k7 / 4e-6)


def test_flash_and_decode_tail_rooflines_are_the_hand_counts():
    rec = Record(cell="x", seed=1, trace=True)
    rec.extra["calls"] = {"flash_rpe": [(2, 2, 2, 16, 2)],
                          "decode_tail": [(2, 4, 2)]}
    rec.profile = _profile({
        "_Z20flash_fwd_mma_kernelILi5ELi1ELb1EEvPK13__nv_bfloat16": 1e-6,
        "flash_fwd_mma_kernel<5, 1, false>": 9.0,
        "decode_tail_mma_kernel": 2e-6, "reduce_tiles_kernel": 1e-6})
    N = 4
    k4 = max((4 * 2 * N * 16 * 2 + 6 * 16 * 2) / 3.35e12,
             (4 * 2 * 16 * 16 + 2 * 2 * 4 * 16 * 4 + 2 * 2 * 16) / 989e12)
    assert load_reader("flash_rpe_roofline").read(rec) == pytest.approx(
        100 * k4 / 1e-6)
    tokens = 8
    k6 = max((tokens * 512 + 2 * 192 * 4 + (65536 + 8192 + 896) * 4)
             / 3.35e12,
             tokens * 2 * (2 * 65536 + 3 * 4 * 64 * 128) / 989e12,
             tokens * (2 * 4 * 12 * 32 + 10 * 768) / 67e12)
    assert load_reader("decode_tail_roofline").read(rec) == pytest.approx(
        100 * k6 / 3e-6)
    assert is_flash_bias("flash_fwd_mma_kernel<5, 1, true>") is True
    assert is_flash_bias("flash_fwd_kernel<64, false>") is False
    assert is_flash_bias("fps_kernel") is None
    assert entry_name("_ZN3abc8fps_loopILi4ELb0EEEvv") == "fps_loop<4,0>"


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = Record(cell="x", seed=1, trace=True)
    for name in ("fps_roofline", "geo_embed_roofline", "flash_rpe_roofline",
                 "decode_tail_roofline", "geo_embed_bwd_roofline",
                 "scatter_rows_roofline", "pem.mfu_pct", "ism.mfu_pct",
                 "train.mfu_pct", "serve.device_idle_pct",
                 "ism.encoder_ms"):
        assert load_reader(name).read(rec) is None
    rec.profile = _profile({"other_kernel": 1e-3})
    rec.extra["calls"] = {"fps": [(1, 2048, 196)]}
    assert load_reader("fps_roofline").read(rec) is None


def test_mfu_counts_useful_rows_over_the_window_at_the_bf16_peak():
    rec = Record(cell="x", seed=1, trace=True)
    rec.frames = [{"n": 3, "bucket": 4, "ms": 1.0, "ok": True}] * 2
    rec.flops_per_instance = 5e10
    # The profiled window is stretched; the readers take the same frames
    # served without the profiler.
    rec.profile = _profile({"k": 0.1}, window_s=0.75)
    rec.extra["plain_s"] = 0.5
    assert load_reader("pem.mfu_pct").read(rec) == pytest.approx(
        100 * 3e11 / 0.5 / 989e12)
    assert load_reader("pem_runner.pad_pct").read(rec) == pytest.approx(25.0)
    assert load_reader("serve.device_idle_pct").read(rec) == pytest.approx(80)


def test_plain_seconds_serves_each_frame_once_between_two_syncs():
    from portbench.harness.trace import plain_seconds

    log = []
    s = plain_seconds(log.append, 3, lambda: log.append("sync"))
    assert log == ["sync", 0, 1, 2, "sync"] and s >= 0.0


def test_flop_counter_counts_a_dense_product_as_2mnk():
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.layers import Dense

    layer = Dense(16, 8)
    with FlopCounterMode(display=False) as fc:
        layer(torch.zeros(5, 16))
    assert fc.get_total_flops() == 2 * 5 * 16 * 8
    assert peaks.bound_s(0, 989e12, "bfloat16") == pytest.approx(1.0)


def test_trace_reduction_on_a_made_up_timeline():
    def ev(kind, s, e, name, thread=1):
        return (kind == "CUDA", s, e, name, thread)

    events = [ev("CUDA", 0, 10, "k1"), ev("CUDA", 5, 20, "k2"),
              ev("CUDA", 50, 60, "k1"), ev("CPU", 0, 100, "frame"),
              ev("CPU", 25, 45, "aten::nonzero"),
              ev("CPU", 30, 40, "cudaStreamSynchronize"),
              ev("CPU", 0, 200, "other thread", thread=2)]
    p = Profile.__new__(Profile)
    p._reduce(events)
    assert p.busy_s == pytest.approx(30e-6)
    assert p.device_ops["k1"] == [pytest.approx(20e-6), 2]
    assert p.idle_gaps == {"cudaStreamSynchronize": pytest.approx(30e-6)}
    bd = p.breakdown()
    assert bd["device_ops"][0][0] == "k1"

