"""PEM training from data on the CPU, at the tiny config: `train_cli
--data_dir` (MegaPose files -> Solver -> train_step), the trained weights
back into `PEMRunner`, and the two batch pipelines (`DevicePrefetcher`,
`ProcessSampleStream`).  The first step against the JAX package's is in
`test_torch_train_data_step.py` (its compile is most of its time, so it
runs beside this file).  Everything here is exact or a property (order,
errors, no process left).
"""

import os
import pathlib
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

import sam6d_tpu_torch.config as tc
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
from sam6d_tpu_torch.provider.training_dataset import (
    MegaPoseDataset,
    RenderedPoseDataset,
    SyntheticPoseDataset,
    collate,
)
from sam6d_tpu_torch.train import checkpoint, solver as tsolver, train_cli
from sam6d_tpu_torch.train import state as tstate
from tests.test_torch_pem import tiny_config
from tests.test_torch_train import B, N_OBS, N_TEM, S

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import megapose_tree  # noqa: E402

torch.set_num_threads(2)
SIZES = dict(batch_size=B, img_size=S, n_sample_observed_point=N_OBS,
             n_sample_template_point=N_TEM)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("megapose_tree")
    megapose_tree.write_megapose_tree(root, n_keys=5, seed=2)
    return str(root)


@pytest.fixture
def tiny_cli(monkeypatch):
    """train_cli.main at the tiny PEM and train configs.  The tiny random
    model's gradient norms on these batches (100-180) straddle the
    default spike guard (150), which would drop most updates: the guard
    is raised so that the steps apply (the guard has its own tests)."""
    optim = tc.OptimConfig(spike_skip_norm=1e4)
    monkeypatch.setattr(train_cli, "PEMConfig", lambda: tiny_config(tc))
    monkeypatch.setattr(train_cli, "TrainConfig", lambda: tc.TrainConfig(
        iters_to_print=1, optim=optim, **SIZES))


def test_train_cli_data_dir_trains_checkpoints_and_resumes(tree, tiny_cli,
                                                            tmp_path):
    argv = ["--data_dir", tree, "--device", "cpu", "--steps", "2",
            "--epochs", "1", "--log_dir", str(tmp_path)]
    solver = train_cli.main(argv)
    state = solver.state
    assert isinstance(solver.dataloader.dataset, MegaPoseDataset)
    assert state.step == 2 and state.optimizer.count >= 1
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"loss"' in lines[0]
    assert (tmp_path / "ckpt" / "2.pt").exists()

    again = train_cli.main(argv + ["--resume", "--epochs", "1"])
    # Resumed at step 2, then the epoch's two steps again.
    assert again.state.step == 4
    assert (tmp_path / "ckpt" / "4.pt").exists()
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 4


def test_train_cli_needs_data_or_synthetic():
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--device", "cpu"])


def test_solver_resets_the_megapose_epoch_each_epoch(tree, tiny_cli,
                                                     tmp_path, monkeypatch):
    """EpochBatches exposes its dataset, so the Solver reaches
    MegaPoseDataset.reset once an epoch, as the JAX Solver does."""
    calls = []
    real = MegaPoseDataset.reset
    monkeypatch.setattr(MegaPoseDataset, "reset",
                        lambda self: calls.append(1) or real(self))
    solver = train_cli.main(["--data_dir", tree, "--device", "cpu",
                             "--steps", "1", "--epochs", "2",
                             "--log_dir", str(tmp_path)])
    assert len(calls) == 2 and solver.state.step == 2
    assert len(solver.dataloader.dataset.img_idx) == 5


def test_trained_weights_reach_pem_runner(tree, tmp_path):
    """save_params -> PEMRunner.load_params with no missed entry -> a
    finite pose; restore_params strict; the tolerant loader's guard."""
    cfg = tiny_config(tc)
    state = tstate.create_train_state(cfg, tc.OptimConfig(lr=1e-2),
                                      device="cpu", seed=3)
    ds = MegaPoseDataset(tc.TrainConfig(**SIZES), tree, seed=1)
    sample = ds[0]
    tstate.train_step(state, collate([sample, ds[1]]),
                      torch.Generator().manual_seed(0))
    path = checkpoint.save_params(str(tmp_path / "pem"), state.model)
    assert path.endswith(".npz") and os.path.exists(path)

    runner = PEMRunner(cfg, device="cpu", seed=0)
    assert runner.load_params(path) == []
    for k, v in state.model.state_dict().items():
        assert torch.equal(runner.model.state_dict()[k].float(), v.float()), k
    runner.onboard_arrays(sample["tem_rgb"], sample["tem_pts"],
                          sample["tem_choose"])
    out = runner.infer({
        "pts": sample["pts"][None], "rgb": sample["rgb"][None],
        "rgb_choose": sample["rgb_choose"][None],
        "model_pts": sample["tem_pts"].reshape(-1, 3)[None, ::3],
        "score": np.ones(1, np.float32)})
    assert np.isfinite(out["pred_R"]).all() and np.isfinite(out["pred_t"]).all()
    assert abs(np.linalg.det(out["pred_R"][0]) - 1.0) < 1e-3

    fresh = tstate.create_train_state(cfg, tc.OptimConfig(), device="cpu",
                                      seed=9).model
    checkpoint.restore_params(path, fresh)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    keys = list(state.model.state_dict())
    partial = {k: v for k, v in state.model.state_dict().items()
               if k in keys[:len(keys) // 3]}
    small = checkpoint.save_params(str(tmp_path / "partial.npz"), partial)
    with pytest.raises(ValueError, match="matched only"):
        checkpoint.restore_params_tolerant(small, fresh, verbose=False)
    misses = checkpoint.restore_params_tolerant(small, fresh, verbose=False,
                                                max_miss_fraction=1.0)
    assert len(misses) == len(keys) - len(partial)
    with pytest.raises(RuntimeError):
        checkpoint.restore_params(small, fresh)


def test_device_prefetcher_on_the_cpu_keeps_order_and_raises():
    batches = [{"a": np.full((2, 3), i, np.int32),
                "b": np.arange(4, dtype=np.float32) + i} for i in range(5)]
    pf = tsolver.DevicePrefetcher(iter(batches), device="cpu", depth=2)
    got = list(pf)
    pf.close()
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["a"], torch.Tensor) and b["a"].device.type == "cpu"
        np.testing.assert_array_equal(b["a"].numpy(), batches[i]["a"])
        np.testing.assert_array_equal(b["b"].numpy(), batches[i]["b"])

    def failing():
        yield batches[0]
        raise KeyError("broken source")

    pf = tsolver.DevicePrefetcher(failing(), device="cpu")
    it = iter(pf)
    next(it)
    with pytest.raises(KeyError, match="broken source"):
        next(it)
    pf.close()
    assert not pf._t.is_alive()

    # close() releases a thread blocked on a full queue.
    endless = ({"a": np.zeros(1)} for _ in iter(int, 1))
    pf = tsolver.DevicePrefetcher(endless, device="cpu", depth=1)
    next(iter(pf))
    pf.close()
    assert not pf._t.is_alive()


def test_device_prefetcher_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsolver.DevicePrefetcher(iter([]), device="cuda")


class IndexDataset:
    """Sample i is its index (and a worker's pid), so a batch tells which
    indices it holds."""

    def __len__(self):
        return 10 ** 9

    def __getitem__(self, i):
        return {"i": np.int64(i), "pid": np.int64(os.getpid())}


def run_with_timeout(fn, seconds=60.0):
    """Run fn on a thread; fail (rather than hang the suite) if it has not
    finished within `seconds`."""
    box = {}

    def target():
        try:
            box["value"] = fn()
        except BaseException as e:  # handed to the test's thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"still running after {seconds} s"
    if "error" in box:
        raise box["error"]
    return box.get("value")


def test_process_stream_covers_the_index_progression():
    B_, n_workers, start = 3, 2, 100
    stream = tsolver.ProcessSampleStream(IndexDataset(), B_, n_workers,
                                         depth=2, start_index=start)
    try:
        it = iter(stream)
        got = run_with_timeout(lambda: [next(it) for _ in range(8)])
    finally:
        stream.close()
    assert not any(p.is_alive() for p in stream.workers)
    seen = {}
    for b in got:
        idx = b["i"].tolist()
        base = idx[0] - start
        assert idx == [idx[0] + j for j in range(B_)]
        assert base % B_ == 0
        k = base // B_  # = i * n_workers + w
        w, i = k % n_workers, k // n_workers
        seen.setdefault(w, []).append(i)
        assert len(set(b["pid"].tolist())) == 1
    # Each worker hands out its batches in order, from its first.
    for w, its in seen.items():
        assert its == list(range(len(its))), (w, its)
    assert sum(len(v) for v in seen.values()) == 8


def test_process_stream_collates_rendered_samples_like_the_dataset():
    cfg = tc.TrainConfig(**SIZES)
    ds = RenderedPoseDataset(cfg, n_objects=2, n_template_views=3,
                             frame_size=64, uint8_rgb=True)
    stream = tsolver.ProcessSampleStream(ds, 2, n_workers=1, depth=1,
                                         start_index=7)
    try:
        first = run_with_timeout(lambda: next(iter(stream)))
    finally:
        stream.close()
    want = collate([ds[7], ds[8]])
    assert first.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(first[k], want[k], err_msg=k)
    assert first["rgb"].dtype == np.uint8


def test_process_stream_raises_when_a_worker_dies():
    stream = tsolver.ProcessSampleStream(IndexDataset(), 2, n_workers=2,
                                         depth=1)
    try:
        it = iter(stream)
        run_with_timeout(lambda: next(it))
        os.kill(stream.workers[1].pid, signal.SIGKILL)
        stream.workers[1].join(10.0)

        def drain():
            with pytest.raises(RuntimeError, match="exited"):
                for _ in range(1000):
                    next(it)
        run_with_timeout(drain, 30.0)
    finally:
        stream.close()
    assert not any(p.is_alive() for p in stream.workers)


class LargeDataset:
    """Samples of 4 MiB: a batch is far larger than a pipe's buffer, so
    a worker's queue writes it in many pieces."""

    def __len__(self):
        return 10 ** 9

    def __getitem__(self, i):
        return {"x": np.full(2 ** 20, i, np.float32)}


def test_process_stream_closes_with_batches_half_written():
    """Workers stopped while their batches are still being written to the
    queue: `close` returns, and leaves no process."""
    stream = tsolver.ProcessSampleStream(LargeDataset(), 2, n_workers=3,
                                         depth=1)
    try:
        it = iter(stream)
        first = run_with_timeout(lambda: next(it))
        assert first["x"].shape == (2, 2 ** 20)
        time.sleep(1.0)  # every worker has a batch on its way
    finally:
        run_with_timeout(stream.close, 60.0)
    assert not any(p.is_alive() for p in stream.workers)


class SlowIndexDataset(IndexDataset):
    def __getitem__(self, i):
        time.sleep(0.5)
        return super().__getitem__(i)


def test_process_stream_raises_when_live_workers_stall():
    """Stopped workers stay alive and deliver nothing: the consumer raises
    after `stall_timeout` rather than waiting forever, and `close` still
    leaves no process."""
    stream = tsolver.ProcessSampleStream(SlowIndexDataset(), 4, n_workers=2,
                                         depth=1, stall_timeout=2.0)
    try:
        for p in stream.workers:  # inside their first batch's sleeps
            os.kill(p.pid, signal.SIGSTOP)

        def first():
            with pytest.raises(RuntimeError, match="no batch"):
                next(iter(stream))
        run_with_timeout(first, 30.0)
        assert all(p.is_alive() for p in stream.workers)
    finally:
        stream.close()
    assert not any(p.is_alive() for p in stream.workers)


class FailingDataset(SyntheticPoseDataset):
    def __getitem__(self, index):
        raise ValueError("bad sample")


def test_process_stream_raises_a_dataset_error():
    cfg = tc.TrainConfig(**SIZES)
    stream = tsolver.ProcessSampleStream(FailingDataset(cfg), 2,
                                         n_workers=1)
    try:
        def first():
            with pytest.raises(RuntimeError, match="exited"):
                next(iter(stream))
        run_with_timeout(first, 30.0)
    finally:
        stream.close()
    assert stream.workers[0].exitcode not in (None, 0)
