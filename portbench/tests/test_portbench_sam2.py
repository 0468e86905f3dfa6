"""The SAM 2.1 ISM cell at a tiny size on the CPU: its own tiny variant
of `ism_sam2_l.frame` (a tiny Hiera at 128 px, a 4 x 4 grid, a two-block
DINOv2, two objects of four views, three frames), under the cell's own
limits; its control and faults in the program fail them; its roofline's
reader on a synthetic record."""

from __future__ import annotations

import dataclasses
import time

import pytest

from portbench.harness import cells

NAME = "ism_sam2_l.frame"
TINY = {"embed_dim": 16, "num_heads": 1, "stages": [1, 2, 2, 1],
        "global_att_blocks": [4], "window_spec": [4, 2, 4, 2]}


def cell() -> cells.Cell:
    c = cells.resolve(NAME)
    conf, tr = dict(c.config), dict(c.traffic)
    ism = dict(conf["ism"])
    # The fused route on the CPU too (K6's plain version), as on the card.
    ism["segmentor"] = dict(ism["segmentor"], points_per_side=4,
                            points_per_batch=8, fused_tail=True)
    ism["descriptor"] = dict(ism["descriptor"], embed_dim=64, depth=2,
                             num_heads=4, image_size=56)
    conf.update(ism=ism, compute_dtype="float32", img_size=128,
                trunk_kwargs=TINY)
    tr.update(objects=2, template_views=4, frames=3, warm_frames=1,
              check_frames=2, check_among=3, trace_frames=3)
    return dataclasses.replace(c, config=conf, traffic=tr)


def run(c=None, seed: int = 2 ** 33 + 17, seconds: float = 2.0):
    c = cell() if c is None else c
    driver = cells.load_driver(c.traffic["driver"])
    return driver.run(c, seed, seconds, False, time.perf_counter(),
                      device="cpu")


def test_a_sound_run_is_correct():
    rec = run()
    assert rec.attempted > 0 and rec.failed == 0
    assert rec.judged > 0 and not rec.check_errors
    assert rec.correct, (rec.numbers, rec.limits)


def test_the_control_is_not_correct():
    c = cell()
    numbers = cells.load_driver(c.traffic["driver"]).control(c, 5, "cpu")
    over = [k for k, lim in c.limits["numbers"].items() if numbers[k] > lim]
    assert set(over) & {"embed", "tokens", "mask_miss"}, (numbers, c.limits)


def _avg_pool(monkeypatch, hiera, model, decoder):
    def broken(x):
        B, H, W, C = x.shape
        return x.reshape(B, H // 2, 2, W // 2, 2, C).mean((2, 4))

    monkeypatch.setattr(hiera, "max_pool2", broken)


def _global_block_windowed(monkeypatch, hiera, model, decoder):
    init = hiera.Hiera.__init__

    def broken(self, *a, **k):
        init(self, *a, **k)
        for b in self.blocks:
            if b.window_size == 0:
                b.window_size, b.kind = 2, "window"

    monkeypatch.setattr(hiera.Hiera, "__init__", broken)


def _no_s1_residual(monkeypatch, hiera, model, decoder):
    layout = model.key_row_layout

    def broken(feat_s1, feat_s0):
        res1, res0 = layout(feat_s1, feat_s0)
        return res1 * 0, res0

    monkeypatch.setattr(model, "key_row_layout", broken)


def _no_s0_residual(monkeypatch, hiera, model, decoder):
    layout = model.key_row_layout

    def broken(feat_s1, feat_s0):
        res1, res0 = layout(feat_s1, feat_s0)
        return res1, res0 * 0

    monkeypatch.setattr(model, "key_row_layout", broken)


def _k6_residuals_left_out(monkeypatch, hiera, model, decoder):
    from sam6d_tpu_torch.models.ism.sam import amg

    tail = amg.decode_tail_stats

    def broken(*a, res1=None, res0=None, **k):
        return tail(*a, **k)

    monkeypatch.setattr(amg, "decode_tail_stats", broken)


def _sams_token_places(monkeypatch, hiera, model, decoder):
    fwd = decoder.MaskDecoder.transformer_forward

    def broken(self, *a, **k):
        self.pred_obj_scores, keep = False, self.pred_obj_scores
        try:  # the object-score token dropped: SAM's tokens and places
            return fwd(self, *a, **k)
        finally:
            self.pred_obj_scores = keep

    monkeypatch.setattr(decoder.MaskDecoder, "transformer_forward", broken)


FAULTS = {"queries_average_pooled": _avg_pool,
          "global_block_windowed": _global_block_windowed,
          "feat_s1_residual_left_out": _no_s1_residual,
          "feat_s0_residual_left_out": _no_s0_residual,
          "k6_residuals_left_out": _k6_residuals_left_out,
          "object_score_token_left_out": _sams_token_places}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_timed_path_broken_is_not_correct(monkeypatch, fault):
    """Each fault where the program computes it: Hiera's query pooling
    averaging, its global block attending in windows, the tail without
    feat_s1 or without feat_s0 (in K6's statistics and the kept
    candidates' logits alike), K6's statistics alone without both (the
    kept candidates' logits keep them: only `tail_stats` reads it), the
    decoder without its object-score token."""
    from sam6d_tpu_torch.models.ism.sam import decoder
    from sam6d_tpu_torch.models.ism.sam2 import hiera, model

    FAULTS[fault](monkeypatch, hiera, model, decoder)
    rec = run()
    assert rec.attempted > 0 and not rec.correct, rec.numbers


class _Event:
    """A profiler event as `hiera_attn_roofline` reads it."""

    def __init__(self, name, corr, start, dur, cuda):
        self._n, self._c, self._s, self._d, self._g = (name, corr, start,
                                                       dur, cuda)

    def name(self):
        return self._n

    def is_hidden_event(self):
        return False

    def correlation_id(self):
        return self._c

    def device_type(self):
        return "DeviceType.CUDA" if self._g else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def _profile(events):
    from types import SimpleNamespace as NS

    kineto = NS(events=lambda: events)
    return NS(_prof=NS(profiler=NS(kineto_results=kineto)))


def test_hiera_attn_roofline_reads_a_synthetic_record(monkeypatch):
    import sys
    import types

    from portbench.harness import spans
    from portbench.harness.record import Record
    from sam6d_tpu_torch.utils.timer import Recording

    reader = cells.load_reader("hiera_attn_roofline")
    calls = [(8, 4096, 4096, 72, 2), (4096, 16, 64, 72, 2)]
    rec = Record(cell=NAME, seed=1, trace=True)
    rec.frames = [{"ms": 100.0, "ok": True, "proposals": 10}]
    rec.extra["calls"] = {"hiera_attn": calls}
    k5 = "void (anonymous namespace)::flash_fwd_mma_kernel<72, 2, false>()"
    k4 = "void (anonymous namespace)::flash_fwd_mma_kernel<80, 2, true>()"
    # Two K5 launches inside `encoder` (1 ms each), one K4 launch there,
    # one K5 launch (DINOv2's) inside `descriptors`.
    rec.profile = _profile([
        _Event("cudaLaunchKernel", 1, 110, 5, False),
        _Event(k5, 1, 500, 10 ** 6, True),
        _Event("cudaLaunchKernel", 2, 120, 5, False),
        _Event(k4, 2, 2 * 10 ** 6, 10 ** 6, True),
        _Event("cudaLaunchKernel", 3, 130, 5, False),
        _Event(k5, 3, 3 * 10 ** 6, 10 ** 6, True),
        _Event("cudaLaunchKernel", 4, 310, 5, False),
        _Event(k5, 4, 5 * 10 ** 6, 7 * 10 ** 6, True)])
    prof = Recording()
    prof.spans = [["encoder", 100, 200, None, 1, 7],
                  ["descriptors", 300, 400, None, 1, 7]]
    prof.counts = [("hiera.attn_rows_global", 8 * 4096, 150, 1)]
    monkeypatch.setitem(sys.modules, spans.RECORDER,
                        types.SimpleNamespace(PROFILED=prof))
    assert reader.encoder_k5_s(rec.profile) == (2e-3, 2)
    need = (4 * 8 * 4096 * 4096 * 72 / 989e12
            + 2 * 4096 * 72 * (2 * 16 + 2 * 64) / 3.35e12)
    assert abs(reader.read(rec) - 100 * need / 2e-3) < 1e-9
    # Launches that are not the calls counted, no Hiera rows served by
    # K5, no trace: nothing read.
    rec.extra["calls"]["hiera_attn"] = calls[:1]
    assert reader.read(rec) is None
    rec.extra["calls"]["hiera_attn"] = calls
    prof.counts = [("hiera.attn_rows_plain", 100, 150, 1)]
    assert reader.read(rec) is None
    prof.counts = [("hiera.attn_rows_global", 8 * 4096, 150, 1)]
    rec.trace = False
    assert reader.read(rec) is None
