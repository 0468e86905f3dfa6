"""Training solver: the epoch loop with timing, logging, checkpoints and
resume, and the batch pipelines that feed it.

Counterpart of `sam6d_tpu/train/solver.py` (reference utils/solver.py):
a background thread collates the next batches while the card runs the
current step, every `iters_to_print` steps the metrics go to the log and
as one JSON line to `<log_dir>/metrics.jsonl`, each epoch ends with a
checkpoint, and 100 skipped updates in a row (a diverged run, whose
parameters the spike guard keeps frozen) abort the run.

`ProcessSampleStream` draws and collates batches in forked worker
processes (numpy only), `DevicePrefetcher` copies host batches to the
card on a side stream ahead of the step; `tools/train_flagship.py` of
the JAX package chains the same two over `RenderedPoseDataset`.
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Callable, Iterable

import torch

from sam6d_tpu_torch.config import TrainConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.parallel.distributed import process_index, sync_hosts
from sam6d_tpu_torch.provider.training_dataset import collate
from sam6d_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
)
from sam6d_tpu_torch.train.state import TrainState, train_step


def get_logger(log_dir: str | None = None, name: str = "sam6d_tpu_torch"):
    """Console logger, plus `<log_dir>/train.log` (reference
    solver.py:220-235)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "train.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class BatchPrefetcher:
    """Iterates `batches` on a background thread, `depth` batches ahead;
    the order is unchanged.  An error in the source is raised to the
    consumer; `close` releases the thread."""

    def __init__(self, batches: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: list = []
        self._stop = threading.Event()

        def put(item) -> bool:
            # Bounded waits, so a closed prefetcher never leaves the
            # thread blocked holding the source iterator.
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.25)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if not put(self._convert(b)):
                        return
            except BaseException as e:  # raised on the consumer side
                self._err.append(e)
            finally:
                put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def _convert(self, batch):
        """What the thread queues for each source batch."""
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err:
                    raise self._err[0]
                return
            yield item


class DevicePrefetcher(BatchPrefetcher):
    """Host batches -> batches of tensors on `device`, `depth` ahead, in
    order.

    On the card a background thread pins each host array and copies it
    with `non_blocking=True` on a side CUDA stream, then records an
    event; the consumer's current stream waits on that event before the
    batch is handed out, and each tensor is marked as used on the
    consumer's stream (`record_stream`), so the caching allocator does
    not hand its memory to the side stream's next copy while the step
    still reads it.  On the CPU it only makes tensors.  A CUDA device
    without a card raises (`device.resolve_device`)."""

    def __init__(self, batches: Iterable, device="cuda", depth: int = 2):
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        super().__init__(batches, depth)

    def _convert(self, batch: dict):
        if self._stream is None:
            return {k: torch.as_tensor(v) for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def __iter__(self):
        for out, ready in super().__iter__():
            if ready is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                for t in out.values():
                    t.record_stream(consumer)
            yield out


class ProcessSampleStream:
    """An unbounded stream of batches drawn by forked worker processes.

    Worker w collates the samples start_index + (i n_workers + w) B + j,
    j < B, of its i-th batch and puts the batch on a queue `depth` deep:
    with `RenderedPoseDataset`, whose sample depends only on its index,
    every batch is fresh.  The workers run numpy only and never touch
    CUDA (forked from a process that may hold a CUDA context).  Batches
    arrive in the order the workers finish them.  The consumer polls the
    queue every half second.  A worker that dies (killed, or an error in
    the dataset, whose traceback the worker prints) is raised as
    RuntimeError at the next batch the consumer asks for.  Workers that
    are alive but deliver no batch for `stall_timeout` seconds of the
    consumer's waiting (hung, e.g. on a lock held at the fork) are raised
    as RuntimeError too; keep it well above a batch's time.  Not caught:
    a worker that stops halfway through writing a batch to the queue,
    since the consumer's read of that batch then blocks.  `close` stops
    the workers (terminating, then killing, any left after 10 s) and
    leaves none alive.  It never reads the queue: a worker exits without
    flushing its queue, so a batch larger than the pipe's buffer can be
    left half written, and reading it would block forever.
    """

    def __init__(self, dataset, batch_size: int, n_workers: int = 2,
                 depth: int = 4, start_index: int = 0, collate_fn=collate,
                 stall_timeout: float = 300.0):
        self.stall_timeout = stall_timeout
        ctx = mp.get_context("fork")
        self._q = ctx.Queue(maxsize=depth)
        self._stop = ctx.Event()
        self.workers = []
        for w in range(n_workers):
            p = ctx.Process(
                target=self._worker,
                args=(dataset, batch_size, n_workers, w, start_index,
                      collate_fn, self._q, self._stop),
                daemon=True)
            p.start()
            self.workers.append(p)

    @staticmethod
    def _worker(dataset, B, n_workers, w, start, collate_fn, q, stop):
        i = 0
        while not stop.is_set():
            base = start + (i * n_workers + w) * B
            batch = collate_fn([dataset[base + j] for j in range(B)])
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue
            i += 1
        q.cancel_join_thread()  # exit without flushing to a closed stream

    def _check_workers(self):
        dead = [(w, p.exitcode) for w, p in enumerate(self.workers)
                if not p.is_alive()]
        if dead:
            raise RuntimeError(
                f"ProcessSampleStream: worker(s) exited (worker, exit "
                f"code): {dead}")

    def __iter__(self):
        waited_from = time.monotonic()
        while True:
            self._check_workers()
            try:
                batch = self._q.get(timeout=0.5)
            except queue.Empty:
                waited = time.monotonic() - waited_from
                if waited > self.stall_timeout:
                    raise RuntimeError(
                        f"ProcessSampleStream: no batch in {waited:.1f} s "
                        f"from {len(self.workers)} live worker(s) "
                        f"(stall_timeout {self.stall_timeout} s): hung?")
                continue
            yield batch
            waited_from = time.monotonic()

    def close(self):
        self._stop.set()
        deadline = time.monotonic() + 10.0
        for p in self.workers:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in self.workers:
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
            p.join(timeout=2.0)
        self._q.close()
        self._q.join_thread()


class Solver:
    """Drives `step_fn(state, batch, generator) -> metrics` over
    `dataloader` (an iterable of batches, re-iterated each epoch)."""

    def __init__(self, state: TrainState, cfg: TrainConfig,
                 dataloader: Iterable, log_dir: str = "log",
                 step_fn: Callable = None):
        self.state = state
        self.cfg = cfg
        self.dataloader = dataloader
        self.log_dir = log_dir
        self.logger = get_logger(log_dir)
        self.metrics_path = os.path.join(log_dir, "metrics.jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self.step_fn = step_fn or train_step
        self.epoch = 1
        self.consecutive_skips = 0
        self.max_consecutive_skips = 100
        dev = next(state.model.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(cfg.rd_seed)

    def _ckpt_dir(self, ckpt_dir: str | None = None) -> str:
        """`<log_dir>/ckpt`; under tensor parallelism each tp slice's
        state goes to its own `tp<index>` directory within it."""
        ckpt_dir = ckpt_dir or os.path.join(self.log_dir, "ckpt")
        par = self.state.parallel
        if par is not None and par.tp > 1:
            ckpt_dir = os.path.join(ckpt_dir, f"tp{par.tp_index}")
        return ckpt_dir

    def _writes(self) -> bool:
        """One rank writes each file: the first dp rank of each tp slice
        (its dp replicas hold the same state), else rank 0."""
        par = self.state.parallel
        return process_index() == 0 if par is None else par.dp_index == 0

    def resume(self, ckpt_dir: str | None = None):
        ckpt_dir = self._ckpt_dir(ckpt_dir)
        try:
            restore_train_state(ckpt_dir, self.state)
            self.logger.info(f"resumed from {ckpt_dir} at step "
                             f"{self.state.step}")
        except FileNotFoundError:
            self.logger.info("no checkpoint to resume; starting fresh")
        return self

    def solve(self, epochs: int | None = None):
        epochs = epochs or self.cfg.training_epoch
        for epoch in range(self.epoch, epochs + 1):
            # Per-epoch resampling (reference solver.py:79 dataset.reset()).
            for obj in (self.dataloader,
                        getattr(self.dataloader, "dataset", None)):
                if hasattr(obj, "reset"):
                    obj.reset()
                    break
            self.train_epoch(epoch)
            if self._writes():
                save_train_state(self._ckpt_dir(), self.state)
            sync_hosts("solver-checkpoint")
        return self.state

    def train_epoch(self, epoch: int):
        t_data = t_step = 0.0
        t0 = time.perf_counter()
        prefetcher = BatchPrefetcher(self.dataloader)
        try:
            for it, batch in enumerate(prefetcher):
                t1 = time.perf_counter()
                t_data += t1 - t0
                # The metrics come back as floats: the step has finished.
                metrics = self.step_fn(self.state, batch, self.generator)
                t0 = time.perf_counter()
                t_step += t0 - t1
                if metrics.get("update_skipped", 0.0) > 0.5:
                    self.consecutive_skips += 1
                    if self.consecutive_skips >= self.max_consecutive_skips:
                        raise RuntimeError(
                            f"{self.consecutive_skips} consecutive spike or "
                            "non-finite batches skipped: the run has "
                            "diverged (the spike guard keeps the "
                            "parameters frozen); aborting")
                else:
                    self.consecutive_skips = 0
                if (it + 1) % self.cfg.iters_to_print == 0:
                    self._log_metrics(epoch, it, metrics, t_data, t_step)
                    t_data = t_step = 0.0
        finally:
            prefetcher.close()
        return self.state

    def _log_metrics(self, epoch, it, metrics, t_data, t_step):
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars.update(epoch=epoch, iter=it + 1, step=self.state.step,
                       t_data=round(t_data, 3), t_step=round(t_step, 3))
        self.logger.info(
            f"epoch {epoch} iter {it + 1} loss {scalars['loss']:.4f} "
            f"T_data {t_data:.2f}s T_step {t_step:.2f}s")
        if process_index() != 0:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(scalars) + "\n")
