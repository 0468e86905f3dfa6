"""The port's span and counter recorder (`utils/timer.py`) on the CPU: off
it records nothing and costs one shared no-op; on it nests spans with
their parents, requests, self times and counters, on the clock that
torch.profiler stamps its events with; and the span trees of
`PEMRunner.infer` and `train_step` at the tiny config, whose results do
not move with recording on."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sam6d_tpu_torch.config as tc
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
from sam6d_tpu_torch.provider.training_dataset import (
    SyntheticPoseDataset,
    collate,
)
from sam6d_tpu_torch.train import state as tstate
from sam6d_tpu_torch.utils import timer

torch.set_num_threads(2)

TINY = tc.PEMConfig(
    coarse_npoint=16, fine_npoint=64,
    feature_extraction=tc.ViTConfig(embed_dim=48, out_dim=32, img_size=32,
                                    patch_size=8),
    geo_embedding=tc.GeoEmbeddingConfig(hidden_dim=32),
    coarse_point_matching=tc.CoarseMatchingConfig(
        input_dim=32, hidden_dim=32, out_dim=32, nproposal1=64, nproposal2=8),
    fine_point_matching=tc.FineMatchingConfig(
        input_dim=32, hidden_dim=32, out_dim=32, pe_nsample1=8,
        pe_nsample2=16))


def tree(rec, top):
    """The names under span `top`, depth first, and each one's parent."""
    kids = [i for i, s in enumerate(rec.spans) if s[3] == top]
    out = []
    for i in kids:
        out.append((rec.spans[i][0], rec.spans[top][0]))
        out += tree(rec, i)
    return out


def test_off_records_nothing_and_stage_without_a_timer_is_one_noop():
    timer.PROFILED.clear()
    a, b = timer.stage(None, "a"), timer.stage(None, "b")
    assert a is b is timer._NOOP
    with a:
        timer.count("n", 5)
    assert timer.PROFILED.spans == [] and timer.PROFILED.counts == []
    st = timer.StageTimer("cpu")
    with timer.stage(st, "s"):
        pass
    assert list(st.report()) == ["s"] and timer.PROFILED.spans == []


def test_recording_nests_spans_with_parents_requests_self_time_counts():
    st = timer.StageTimer("cpu")
    with timer.recording() as rec:
        with timer.stage(None, "frame", request=7):
            time.sleep(0.002)
            with timer.stage(st, "upload"):
                timer.count("rows", 3)
                time.sleep(0.002)
            with timer.stage(None, "forward"):
                with timer.stage(None, "solve"):
                    time.sleep(0.002)
                timer.count("rows")
        with timer.stage(None, "frame", request=8):
            timer.count("pad_rows", 2)
    assert timer.stage(None, "after") is timer._NOOP
    names = [s[0] for s in rec.spans]
    assert names == ["frame", "upload", "forward", "solve", "frame"]
    assert [s[3] for s in rec.spans] == [None, 0, 0, 2, None]
    assert [s[4] for s in rec.spans] == [7, 7, 7, 7, 8]
    assert all(s[1] <= s[2] for s in rec.spans)
    assert all(rec.spans[i][1] >= rec.spans[s[3]][1]
               and rec.spans[i][2] <= rec.spans[s[3]][2]
               for i, s in enumerate(rec.spans) if s[3] is not None)
    dur = [s[2] - s[1] for s in rec.spans]
    self_ns = rec.self_ns()
    assert self_ns[0] == dur[0] - dur[1] - dur[2]
    assert self_ns[2] == dur[2] - dur[3] and self_ns[3] == dur[3]
    assert self_ns[0] >= 2e6 and self_ns[1] >= 2e6
    assert [(c[0], c[1], c[3]) for c in rec.counts] == [
        ("rows", 3, 7), ("rows", 1, 7), ("pad_rows", 2, 8)]
    assert list(st.report()) == ["upload"]  # the timer times as before


def test_a_span_holds_its_ops_profiler_event_on_the_profilers_clock():
    """While torch.profiler runs, spans go to `PROFILED`, and a span's
    time_ns stamps bracket the CPU event of the op it ran."""
    timer.PROFILED.clear()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage(None, "matmul_span", request=1):
            time.sleep(0.001)
            x @ x
            time.sleep(0.001)
    assert timer.stage(None, "off") is timer._NOOP
    (name, start, end, parent, request, _), = timer.PROFILED.spans
    assert (name, parent, request) == ("matmul_span", None, 1)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    e = mm[0]
    assert start <= e.start_ns() and e.start_ns() + e.duration_ns() <= end
    timer.PROFILED.clear()


def test_each_profiler_session_starts_a_fresh_record():
    """`PROFILED` holds the spans of the profiler session now running,
    not an earlier one's: the first span that finds a profiler after
    one that found none starts a new record."""
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage(None, "first"):
            pass
    first = timer.PROFILED
    with timer.stage(None, "between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage(None, "second"):
            timer.count("rows", 2)
    assert [s[0] for s in first.spans] == ["first"]
    assert [s[0] for s in timer.PROFILED.spans] == ["second"]
    assert [c[:2] for c in timer.PROFILED.counts] == [("rows", 2)]
    timer.PROFILED.clear()


@pytest.fixture(scope="module")
def runner():
    rng = np.random.RandomState(0)
    N, S, C = TINY.fine_npoint, TINY.feature_extraction.img_size, 32
    run = PEMRunner(TINY, device="cpu", seed=0)
    run.make_template_bank(
        torch.from_numpy((rng.randn(1, N, 3) * 0.05).astype(np.float32)),
        torch.from_numpy(rng.randn(1, N, C).astype(np.float32)))
    frames = []
    for n in (3, 2):
        frames.append({
            "pts": (rng.randn(n, N, 3) * 0.05).astype(np.float32),
            "rgb": rng.rand(n, S, S, 3).astype(np.float32),
            "rgb_choose": rng.randint(0, S * S, (n, N)).astype(np.int32),
            "model_pts": (rng.randn(n, 32, 3) * 0.05).astype(np.float32),
            "score": rng.rand(n).astype(np.float32)})
    g = torch.Generator().manual_seed(1)
    uniforms = [tuple(torch.rand(run.bucket_for(len(f["pts"])),
                                 3 * TINY.coarse_point_matching.nproposal1, 1,
                                 generator=g) for _ in range(2))
                for f in frames]
    return run, frames, uniforms


def test_pem_runner_infer_records_the_span_tree_of_each_frame(runner):
    run, frames, uniforms = runner
    first = run.requests + 1
    with timer.recording() as rec:
        for f, u in zip(frames, uniforms):
            run.infer(f, uniforms=u)
    tops = [i for i, s in enumerate(rec.spans) if s[3] is None]
    assert [rec.spans[i][0] for i in tops] == ["pem_runner.infer"] * 2
    for top in tops:
        assert tree(rec, top) == [
            ("pem_runner.upload", "pem_runner.infer"),
            ("pem_runner.upload", "pem_runner.infer"),
            ("pem.forward", "pem_runner.infer"),
            ("pem.features", "pem.forward"),
            ("pem.sample", "pem.forward"),
            ("pem.geo_embed", "pem.forward"),
            ("pem.coarse", "pem.forward"),
            ("pem.coarse_solve", "pem.coarse"),
            ("pem.fine", "pem.forward"),
            ("pem.fine_solve", "pem.fine"),
            ("pem_runner.download", "pem_runner.infer")]
    assert {s[4] for s in rec.spans} == {first, first + 1}
    # pad_rows is the bucket less the instances, frame by frame.
    for k, f in enumerate(frames):
        n, req = len(f["pts"]), first + k
        got = {c[0]: c[1] for c in rec.counts if c[3] == req}
        assert got == {"pem_runner.rows": n,
                       "pem_runner.pad_rows": run.bucket_for(n) - n}
    assert sum(s for s in rec.self_ns() if s is not None) == sum(
        rec.spans[i][2] - rec.spans[i][1] for i in tops)


def test_pem_runner_poses_are_bitwise_equal_with_recording_on_and_off(runner):
    run, frames, uniforms = runner
    for f, u in zip(frames, uniforms):
        off = run.infer(f, uniforms=u)
        with timer.recording():
            on = run.infer(f, uniforms=u)
        with profile(activities=[ProfilerActivity.CPU]):
            profiled = run.infer(f, uniforms=u)
        for k in ("pred_R", "pred_t", "pose_score", "score"):
            assert np.array_equal(off[k], on[k]), k
            assert np.array_equal(off[k], profiled[k]), k
    timer.PROFILED.clear()


def test_train_step_records_its_span_tree_with_the_step_as_request():
    sizes = dict(batch_size=2, img_size=32, n_sample_observed_point=64,
                 n_sample_template_point=48)
    ds = SyntheticPoseDataset(tc.TrainConfig(**sizes), n_samples=2)
    state = tstate.create_train_state(TINY, tc.OptimConfig(), device="cpu",
                                      seed=3)
    state.step = 5
    with timer.recording() as rec:
        m = tstate.train_step(state, collate([ds[0], ds[1]]),
                              torch.Generator().manual_seed(0))
    assert np.isfinite(m["loss"]) and state.step == 6
    assert rec.spans[0][0] == "train.step" and rec.spans[0][3] is None
    assert tree(rec, 0) == [(name, "train.step") for name in (
        "train.to_device", "train.forward", "train.backward",
        "train.read_metrics", "train.optimizer")]
    assert {s[4] for s in rec.spans} == {5}
