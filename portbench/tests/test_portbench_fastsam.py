"""The FastSAM ISM cell at a tiny size on the CPU: its own tiny variant
of `ism_fastsam.frame` (FastSAM "n" at 128 px keeping 24 proposals, a
two-block DINOv2, two objects of four views, three frames), under the
cell's own limits."""

from __future__ import annotations

import dataclasses
import time

import pytest

from portbench.harness import cells

NAME = "ism_fastsam.frame"


def cell() -> cells.Cell:
    c = cells.resolve(NAME)
    conf, tr = dict(c.config), dict(c.traffic)
    ism = dict(conf["ism"])
    ism["fastsam"] = dict(ism["fastsam"], scale="n", img_size=128,
                          max_det=24)
    ism["descriptor"] = dict(ism["descriptor"], embed_dim=64, depth=2,
                             num_heads=4, image_size=56)
    conf.update(ism=ism, compute_dtype="float32", fastsam_scale={
        "depth": 0.33, "width": 0.25, "max_channels": 1024})
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
    assert set(over) & {"head", "box_px", "mask_px"}, (numbers, c.limits)


def _coefficients(monkeypatch, fastsam):
    fwd = fastsam.YOLOv8Seg.forward

    def broken(self, x):
        outs, proto = fwd(self, x)
        return [(b, c, m * 1.05) for b, c, m in outs], proto

    monkeypatch.setattr(fastsam.YOLOv8Seg, "forward", broken)


def _batchnorm_eps(monkeypatch, fastsam):
    init = fastsam.YOLOv8Seg.__init__

    def broken(self, *a, **k):
        init(self, *a, **k)
        self.c2f_2.cv1.bn.eps = 1e-5

    monkeypatch.setattr(fastsam.YOLOv8Seg, "__init__", broken)


def _unflipped(monkeypatch, fastsam):
    def broken(self, x):
        B, H, W, C = x.shape
        O = self.kernel.shape[-1]
        k = self.kernel.permute(2, 0, 1, 3).reshape(C, 4 * O)
        y = (x @ k).reshape(B, H, W, 2, 2, O).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, 2 * H, 2 * W, O) + self.bias

    monkeypatch.setattr(fastsam.ConvTranspose2x2, "forward", broken)


def _sppf_zero_padded(monkeypatch, fastsam):
    import torch
    import torch.nn.functional as F

    def broken(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            p = F.pad(fastsam._nchw(pools[-1]), (2, 2, 2, 2), value=0.0)
            pools.append(fastsam._nhwc(F.max_pool2d(p, 5, 1)))
        return self.cv2(torch.cat(pools, dim=-1))

    monkeypatch.setattr(fastsam.SPPF, "forward", broken)


def _half_dropped(monkeypatch, fastsam):
    gen = fastsam.FastSAM.generate_masks

    def broken(self, image, timer=None):
        out = gen(self, image, timer=timer)
        n = len(out["masks"]) // 2
        return {"masks": out["masks"][:n], "boxes": out["boxes"][:n]}

    monkeypatch.setattr(fastsam.FastSAM, "generate_masks", broken)


FAULTS = {"coefficients_x1.05": _coefficients,
          "one_batchnorm_eps_1e-5": _batchnorm_eps,
          "conv_transpose_unflipped": _unflipped,
          "sppf_zero_padded": _sppf_zero_padded,
          "half_the_proposals_dropped": _half_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_timed_path_broken_is_not_correct(monkeypatch, fault):
    """Each fault where the program computes it: the mask coefficients
    scaled at the network's output, the eps of one BatchNorm, the
    prototypes' ConvTranspose kernel taken unflipped, SPPF padded with 0
    instead of -inf, the second half of the proposals lost before the
    descriptor."""
    from sam6d_tpu_torch.models.ism import fastsam

    FAULTS[fault](monkeypatch, fastsam)
    rec = run()
    assert rec.attempted > 0 and not rec.correct, rec.numbers


def _record():
    """A traced run's record, by hand: three frames of 200 proposals in
    the bucket of 256, their stages, a profile with two DINOv2 passes of
    K5 and a copy, and the program's spans and counters."""
    from portbench.harness.record import Record
    from portbench.harness.trace import Profile

    rec = Record(cell=NAME, seed=1, trace=True)
    rec.frames = [{"ms": 100.0, "ok": True, "proposals": 200, "bucket": 256}
                  for _ in range(3)]
    rec.stage_ms = {"fastsam_forward": [9.0, 11.0, 10.0]}
    rec.extra["plain_s"] = 0.3
    rec.extra["calls"] = {"flash": [(4096, 257, 64, 2)] * 2}
    rec.flops_per_frame = [[3.3e11, 200 * 1.62e11]] * 3
    p = Profile()
    k5 = "void flash_fwd_mma_kernel<64, 64, false>(Params)"
    p._reduce([(True, 0.0, 500.0, k5, 0), (True, 600.0, 1100.0, k5, 0),
               (True, 1200.0, 1300.0, "Memcpy DtoH", 0)])
    rec.profile = p
    return rec


def test_the_readers_read_a_synthetic_record(monkeypatch):
    import sys
    import types

    from portbench.harness import spans
    from sam6d_tpu_torch.utils.timer import Recording  # before it is hidden

    rec = _record()
    read = {m: cells.load_reader(m).read for m in (
        "fastsam.forward_ms", "fastsam.select_idle_pct",
        "ism.descriptor_pad_pct", "flash_roofline", "ism.fastsam_mfu_pct")}
    assert read["fastsam.forward_ms"](rec) == 10.0
    # K5 at (4096, 257, 64) is bound by its bytes: 0.161 ms a call.
    need = 2 * 4 * 4096 * 257 * 64 * 2 / 3.35e12
    assert abs(read["flash_roofline"](rec) - 100 * need / 1e-3) < 1e-9
    mfu = 100 * 3 * (3.3e11 / 67e12 + 200 * 1.62e11 / 989e12) / 0.3
    assert abs(read["ism.fastsam_mfu_pct"](rec) - mfu) < 1e-9

    # No program record: the counter and span readers read nothing.
    monkeypatch.delitem(sys.modules, spans.RECORDER, raising=False)
    assert read["ism.descriptor_pad_pct"](rec) is None
    assert read["fastsam.select_idle_pct"](rec) is None

    prof = Recording()
    prof.counts = [("ism.descriptor_rows", 256, 0, 1),
                   ("ism.descriptor_pad_rows", 56, 0, 1),
                   ("fastsam.kept", 200, 0, 1),
                   ("ism.descriptor_rows", 256, 0, 2),
                   ("ism.descriptor_pad_rows", 56, 0, 2)]
    monkeypatch.setitem(sys.modules, spans.RECORDER,
                        types.SimpleNamespace(PROFILED=prof))
    assert read["ism.descriptor_pad_pct"](rec) == 100.0 * 112 / 512
    rec.extra["spans"] = {"idle_ms": 4.0, "names": {
        "fastsam_nms": {"tree_idle_ms": 1.0},
        "fastsam_masks": {"tree_idle_ms": 0.5}}}
    assert read["fastsam.select_idle_pct"](rec) == 100.0 * 1.5 / 4.0
    rec.trace, rec.profile = False, None
    del rec.extra["spans"]
    assert all(r(rec) is None for r in read.values())
