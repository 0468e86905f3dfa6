"""Train-state checkpoints with `torch.save` / `torch.load`, and the
params-only export that inference reads.

The port's own formats (the JAX package writes orbax checkpoints):

* train state: one file `<ckpt_dir>/<step>.pt` per save holding the
  model's state dict (float32 parameters and the BatchNorm statistics),
  the optimizer state (Adam moments, the update count the schedule
  reads, the accumulation state) and the step.  The newest `max_to_keep`
  files are kept.
* params: the `.npz` state dict of `params.save_npz`, which
  `PEMRunner.load_params` and the demo's `--*_params` read.
"""

from __future__ import annotations

import os

import torch

from sam6d_tpu_torch.params import load_npz, save_npz


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


def latest_step(ckpt_dir: str) -> int | None:
    """The newest step saved in ckpt_dir; None when there is none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_train_state(ckpt_dir: str, state, step: int | None = None,
                     max_to_keep: int = 5) -> str:
    step = state.step if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = path + ".tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, f"{old}.pt"))
    return path


def restore_train_state(ckpt_dir: str, state, step: int | None = None):
    """Load the newest checkpoint (or `step`) into `state`, in place;
    FileNotFoundError when there is none."""
    steps = _steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        step = steps[-1]
    dev = next(state.model.parameters()).device
    data = torch.load(os.path.join(ckpt_dir, f"{step}.pt"), map_location=dev,
                      weights_only=True)
    state.model.load_state_dict(data["model"])
    state.optimizer.load_state_dict(data["optimizer"])
    state.step = int(data["step"])
    return state


def params_file(ckpt: str, name: str) -> str:
    """The weights file `name` of a checkpoint directory, or `ckpt` itself
    when it names an .npz file."""
    return ckpt if ckpt.endswith(".npz") else os.path.join(ckpt, name)


def save_params(path: str, model) -> str:
    """Write a module's (or a state dict's) weights as the port's `.npz`
    state dict; returns the file's path (`.npz` appended if missing, as
    numpy does).  A module laid out over ranks
    (`parallel.sharding.shard_train_state`) is gathered to its full
    weights, and rank 0 writes them, so that `PEMRunner.load_params`
    reads them as any other: every rank calls it, and it returns once
    the file is written."""
    from sam6d_tpu_torch.parallel.distributed import process_index, sync_hosts
    from sam6d_tpu_torch.parallel.sharding import unsharded_state_dict

    if isinstance(model, torch.nn.Module):
        state = unsharded_state_dict(model)
    else:
        state = model
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    if process_index() == 0:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        save_npz(state, path)
    sync_hosts("save-params")
    return path


def restore_params(path: str, module: torch.nn.Module) -> torch.nn.Module:
    """Load a `.npz` state dict into `module`, strictly: every entry must
    be present with its shape, and no other."""
    module.load_state_dict(load_npz(path), strict=True)
    return module


def restore_params_tolerant(path: str, module: torch.nn.Module,
                            verbose: bool = True,
                            max_miss_fraction: float = 0.5) -> list[str]:
    """Load a `.npz` state dict without being strict: every entry whose
    name and shape match one of the module's is taken, the module keeps
    its own tensors elsewhere (after the reference's fallback loader,
    run_inference_custom_pytorch.py:393-420).  Raises ValueError if more
    than `max_miss_fraction` of the module's entries found no match: the
    file then almost certainly belongs to another architecture (1.0
    allows any partial load).  Returns the names of the entries that kept
    the module's values, and prints the first of them when `verbose`."""
    ckpt = load_npz(path)
    current = module.state_dict()
    misses = [k for k, v in current.items()
              if k not in ckpt or tuple(ckpt[k].shape) != tuple(v.shape)]
    if current and len(misses) / len(current) > max_miss_fraction:
        raise ValueError(
            f"tolerant load of {path} matched only "
            f"{len(current) - len(misses)}/{len(current)} entries "
            f"(> {max_miss_fraction:.0%} missed); first misses: "
            f"{misses[:8]}")
    miss = set(misses)
    module.load_state_dict({k: ckpt[k] if k not in miss else v
                            for k, v in current.items()})
    if verbose and misses:
        print(f"[checkpoint] kept the module's values for {len(misses)} "
              f"entries missing or mismatched in {path}: {misses[:8]}"
              + ("..." if len(misses) > 8 else ""))
    return misses
