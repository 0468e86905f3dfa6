"""PEM training CLI.

Counterpart of `sam6d_tpu/train/train_cli.py` (reference
Pose_Estimation_Model/train.py:27-138) on one card: config from the
dataclasses, MegaPose web shards or the synthetic dataset, the Solver
loop with checkpoints and resume.  Random weights from
`TrainConfig.rd_seed`; parameters and optimizer state in float32, the
network computing in bfloat16.

  python -m sam6d_tpu_torch.train.train_cli --data_dir /data/MegaPose \
      --log_dir log/pem --epochs 15
  python -m sam6d_tpu_torch.train.train_cli --synthetic --steps 100
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from sam6d_tpu_torch.config import PEMConfig, TrainConfig
from sam6d_tpu_torch.provider.training_dataset import (
    MegaPoseDataset,
    SyntheticPoseDataset,
    batch_iterator,
)
from sam6d_tpu_torch.train.solver import Solver
from sam6d_tpu_torch.train.state import create_train_state, train_step


class EpochBatches:
    """Re-iterable batches: each pass yields `steps` batches of the next
    samples, so every epoch sees fresh ones."""

    def __init__(self, dataset, batch_size: int, steps: int):
        self.dataset, self.batch_size, self.steps = dataset, batch_size, steps
        self.start = 0

    def __iter__(self):
        start = self.start
        self.start += self.steps * self.batch_size
        return batch_iterator(self.dataset, self.batch_size, self.steps, start)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train PEM on one card")
    p.add_argument("--data_dir", default=None,
                   help="MegaPose root (MegaPose-GSO / -ShapeNetCore)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_dir", default="log/pem")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="steps per epoch (default: dataset size / bs)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.synthetic and not args.data_dir:
        p.error("--data_dir is required without --synthetic")
    return args


def build_solver(args, pem_cfg: PEMConfig | None = None,
                 train_cfg: TrainConfig | None = None) -> Solver:
    """The Solver the CLI runs: state, MegaPose or synthetic batches, log
    dir (the default configs unless given)."""
    train_cfg = train_cfg or TrainConfig()
    if args.batch_size:
        train_cfg = dataclasses.replace(train_cfg, batch_size=args.batch_size)
    pem_cfg = pem_cfg or PEMConfig()
    if args.synthetic:
        dataset = SyntheticPoseDataset(train_cfg, n_samples=1024)
    else:
        dataset = MegaPoseDataset(train_cfg, args.data_dir)
    bs = train_cfg.batch_size
    steps = args.steps or max(1, len(dataset) // bs)
    state = create_train_state(pem_cfg, train_cfg.optim, device=args.device,
                               compute_dtype=torch.bfloat16,
                               seed=train_cfg.rd_seed)
    return Solver(state, train_cfg, EpochBatches(dataset, bs, steps),
                  log_dir=args.log_dir, step_fn=train_step)


def main(argv=None):
    args = parse_args(argv)
    solver = build_solver(args)
    if args.resume:
        solver.resume()
    solver.solve(args.epochs or solver.cfg.training_epoch)
    return solver


if __name__ == "__main__":
    main()
