"""The traffic generators are deterministic in --seed and draw what their
files say; the statistics take every frame of a window."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import (
    cells,
    ism_traffic,
    objects,
    pem_traffic,
    stats,
    train_traffic,
)
from portbench.harness.configs import build
from portbench.harness.record import Record
from portbench.reference import config as rconfig
from portbench.tests import tiny

SEED = 2 ** 31 + 4097  # wider than 32 signed bits: seeds may be


def _pem(name):
    c = tiny.cell(name)
    return c.traffic, build(rconfig.PEMConfig, c.config["pem"])


@pytest.mark.parametrize("name", ["pem_base.bin"])
def test_pem_traffic_is_deterministic_in_the_seed(name):
    tr, cfg = _pem(name)
    a, b = (pem_traffic.build(tr, cfg, SEED) for _ in range(2))
    c = pem_traffic.build(tr, cfg, SEED + 1)
    for x, y in zip(a["frames"], b["frames"]):
        for k in x["inputs"]:
            assert np.array_equal(x["inputs"][k], y["inputs"][k])
    assert not np.array_equal(a["frames"][0]["inputs"]["pts"],
                              c["frames"][0]["inputs"]["pts"])
    for k in a["templates"]:  # the onboarded object is the cell's own
        assert np.array_equal(a["templates"][k], c["templates"][k])
    u1 = pem_traffic.uniforms([1, 2], 8, SEED, "cpu")
    u2 = pem_traffic.uniforms([1, 2], 8, SEED, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(u1, u2) for x, y in zip(p, q))


def test_bin_draws_each_size_from_2_to_12_once_a_cycle():
    c = cells.resolve("pem_base.bin")
    tr, cfg = dict(c.traffic, pool_instances=12), build(
        rconfig.PEMConfig, tiny.PEM)
    for seed in (SEED, 7):
        frames = pem_traffic.build(tr, cfg, seed)["frames"]
        counts = [f["n"] for f in frames]
        assert len(counts) == tr["frames"] == 44
        for lo in range(0, 44, 11):
            assert sorted(counts[lo:lo + 11]) == list(range(2, 13))
        buckets = [1 << (n - 1).bit_length() for n in counts[:11]]
        assert sum(b - n for b, n in zip(buckets, counts[:11])) == 29
        assert sum(buckets) == 106
        checked = pem_traffic.check_frames(frames, tr["check_frames"],
                                           tr["check_among"], seed)
        assert 12 in [frames[i]["n"] for i in checked]


def test_instances_lie_on_the_box_at_the_stated_distance():
    rng = np.random.default_rng(3)
    obj = objects.make_object(rng)
    assert 0.05 <= 2 * np.linalg.norm(obj["half"]) <= 0.2
    for _ in range(5):
        inst = objects.instance(obj, 64, 256, rng, depth_noise=0.0)
        local = (inst["pts"] - inst["t"]) @ inst["R"]
        assert np.allclose(np.abs(local / obj["half"]).max(1), 1, atol=1e-3)
        assert 0.4 <= inst["t"][2] <= 0.9
    assert len(objects.icosphere_views()) == 42


def test_ism_and_training_traffic_are_deterministic():
    tr = tiny.cell("ism_sam_h.frame").traffic
    a, b = ism_traffic.frames(tr, SEED), ism_traffic.frames(tr, SEED)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    t1, t2 = (ism_traffic.templates(tr, 32, 16) for _ in range(2))
    assert all(np.array_equal(t1[k], t2[k]) for k in t1)
    c = tiny.cell("pem_base.train28")
    cfg = build(rconfig.PEMConfig, c.config["pem"])
    from sam6d_tpu_torch.config import TrainConfig
    tcfg = build(TrainConfig, c.config["train"])
    x, y = (train_traffic.batches(cfg, tcfg, c.traffic, SEED, "cpu")
            for _ in range(2))
    assert len(x) == c.traffic["ring"]
    assert all(torch.equal(p[k], q[k]) for p, q in zip(x, y) for k in p)
    assert not torch.equal(x[0]["pts"], x[1]["pts"])


def test_percentiles_and_rates_take_every_frame_of_a_window_with_a_stall():
    from portbench.harness.cells import load_reader

    rec = Record(cell="x", seed=1, trace=False)
    rec.frames = [{"ms": 10.0 + 0.01 * i, "ok": True} for i in range(199)]
    rec.frames.insert(57, {"ms": 1000.0, "ok": True})  # one stall
    rec.frames.append({"ms": 5.0, "ok": False})  # failed: misses both
    p50 = load_reader("frame_p50_ms").read(rec)
    p95 = load_reader("frame_p95_ms").read(rec)
    ms = sorted(f["ms"] for f in rec.frames if f["ok"])
    assert p50 == pytest.approx((ms[99] + ms[100]) / 2)
    assert p95 == pytest.approx(ms[189] + 0.05 * (ms[190] - ms[189]))
    assert p95 == pytest.approx(float(np.percentile(ms, 95)))
    assert rec.attempted == 201 and rec.failed == 1
    rec.steps = [{"samples": 28, "ok": True}] * 9 + [{"samples": 28,
                                                     "ok": False}]
    rec.frames, rec.window_s = [], 4.5
    assert load_reader("train_samples_per_s").read(rec) == pytest.approx(
        9 * 28 / 4.5)
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(
        (4.5 - 1.5) / 3)
