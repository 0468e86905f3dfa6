"""Multi-process initialisation, the host barrier and the global mesh.

Counterpart of `sam6d_tpu/parallel/distributed.py` (which wires
`jax.distributed` from JAX's or SLURM's variables; the reference's
SLURM-aware Lightning bootstrap, Instance_Segmentation_Model/
run_inference.py:19-24).  A multi-rank run calls `init_distributed()`
once; it reads explicit arguments first, then torchrun's MASTER_ADDR /
MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, then SLURM's SLURM_NTASKS /
SLURM_PROCID / SLURM_LOCALID, and starts the process group: NCCL with
one card a rank (the card from the local rank), or gloo when asked for
the CPU.  Launch with

    torchrun --nproc_per_node N -m sam6d_tpu_torch.train.train_cli ...
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist


class DistributedEnv(NamedTuple):
    address: str | None  # "host:port" of rank 0's store
    world_size: int | None
    rank: int | None
    local_rank: int | None


def _int(*names) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def distributed_env(coordinator_address: str | None = None,
                    num_processes: int | None = None,
                    process_id: int | None = None,
                    local_rank: int | None = None) -> DistributedEnv:
    """The run's layout: each value from its argument, else torchrun's
    variable, else SLURM's."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = _int("WORLD_SIZE", "SLURM_NTASKS")
    if process_id is None:
        process_id = _int("RANK", "SLURM_PROCID")
    if local_rank is None:
        local_rank = _int("LOCAL_RANK", "SLURM_LOCALID")
    return DistributedEnv(coordinator_address, num_processes, process_id,
                          local_rank)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_rank: int | None = None,
                     device: str = "cuda") -> bool:
    """Start the process group when the run has more than one process;
    True when a group is up (also when it already was), False for one
    process.  device "cuda": NCCL, this process's card set from its local
    rank (else its rank); "cpu": gloo."""
    if dist.is_initialized():
        return True
    env = distributed_env(coordinator_address, num_processes, process_id,
                          local_rank)
    if not (env.address and env.world_size and env.world_size > 1):
        return False
    if env.rank is None:
        raise ValueError("init_distributed: no rank (pass process_id, or "
                         "set RANK or SLURM_PROCID)")
    device = torch.device(device).type
    if device == "cuda":
        local = env.rank if env.local_rank is None else env.local_rank
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: unsupported device {device}")
    dist.init_process_group(backend, init_method=f"tcp://{env.address}",
                            world_size=env.world_size, rank=env.rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def sync_hosts(name: str = "barrier"):
    """A barrier across every rank; nothing without a process group.

    The file-based result merge needs it, or rank 0 can glob before the
    others have written their shards (the reference's merge runs under
    Lightning's implicit end-of-test barrier, detector.py:425-461).
    `name` labels the call site, as the JAX package's does."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def global_mesh(tp: int = 1, device_type: str = "cuda"):
    """A (world / tp, tp) ("dp", "tp") mesh over every rank."""
    from sam6d_tpu_torch.parallel.mesh import DP, TP, make_mesh

    n = process_count()
    if n % tp:
        raise ValueError(f"tp {tp} does not divide {n} ranks")
    return make_mesh((n // tp, tp), (DP, TP), device_type)
