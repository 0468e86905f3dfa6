"""Training solver: the epoch loop with timing, logging, checkpoints and
resume.

Counterpart of `sam6d_tpu/train/solver.py` (reference utils/solver.py):
a background thread collates the next batches while the card runs the
current step, every `iters_to_print` steps the metrics go to the log and
as one JSON line to `<log_dir>/metrics.jsonl`, each epoch ends with a
checkpoint, and 100 skipped updates in a row (a diverged run, whose
parameters the spike guard keeps frozen) abort the run.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Callable, Iterable

import torch

from sam6d_tpu_torch.config import TrainConfig
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
                    if not put(b):
                        return
            except BaseException as e:  # raised on the consumer side
                self._err.append(e)
            finally:
                put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

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

    def resume(self, ckpt_dir: str | None = None):
        ckpt_dir = ckpt_dir or os.path.join(self.log_dir, "ckpt")
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
            save_train_state(os.path.join(self.log_dir, "ckpt"), self.state)
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
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(scalars) + "\n")
