"""PEM training CLI.

Counterpart of `sam6d_tpu/train/train_cli.py` (reference
Pose_Estimation_Model/train.py:27-138): config from the dataclasses,
MegaPose web shards or the synthetic dataset, the Solver loop with
checkpoints and resume.  Random weights from `TrainConfig.rd_seed`;
parameters and optimizer state in float32, the network computing in
bfloat16.  Under torchrun (or SLURM) the ranks form a (dp = world / tp,
tp) mesh: the batch (the global one, `--batch_size`) splits over dp and
the ViT and transformer layers over tp (`parallel/sharding.py`).

  python -m sam6d_tpu_torch.train.train_cli --data_dir /data/MegaPose \
      --log_dir log/pem --epochs 15
  python -m sam6d_tpu_torch.train.train_cli --synthetic --steps 100
  torchrun --nproc_per_node 4 -m sam6d_tpu_torch.train.train_cli \
      --synthetic --tp 2
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from sam6d_tpu_torch.config import PEMConfig, TrainConfig
from sam6d_tpu_torch.parallel.distributed import global_mesh, init_distributed
from sam6d_tpu_torch.parallel.sharding import shard_train_state
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
    p = argparse.ArgumentParser(description="Train the PEM")
    p.add_argument("--data_dir", default=None,
                   help="MegaPose root (MegaPose-GSO / -ShapeNetCore)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--log_dir", default="log/pem")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps", type=int, default=None,
                   help="steps per epoch (default: dataset size / bs)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="the global batch, split over the dp ranks")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.synthetic and not args.data_dir:
        p.error("--data_dir is required without --synthetic")
    return args


def build_solver(args, pem_cfg: PEMConfig | None = None,
                 train_cfg: TrainConfig | None = None) -> Solver:
    """The Solver the CLI runs: state, MegaPose or synthetic batches, log
    dir (the default configs unless given).  With `torch.distributed`
    initialised the state is laid out on the (world / tp, tp) mesh."""
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
    if dist.is_initialized():
        mesh = global_mesh(args.tp, torch.device(args.device).type)
        shard_train_state(state, mesh)
    elif args.tp != 1:
        raise ValueError(f"--tp {args.tp} needs {args.tp} or more ranks "
                         "(torchrun --nproc_per_node N)")
    return Solver(state, train_cfg, EpochBatches(dataset, bs, steps),
                  log_dir=args.log_dir, step_fn=train_step)


def main(argv=None):
    args = parse_args(argv)
    init_distributed(device=args.device)
    solver = build_solver(args)
    if args.resume:
        solver.resume()
    solver.solve(args.epochs or solver.cfg.training_epoch)
    return solver


if __name__ == "__main__":
    main()
