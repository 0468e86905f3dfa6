"""Train-state checkpoints with `torch.save` / `torch.load`.

The port's own format (the JAX package writes orbax checkpoints): one
file `<ckpt_dir>/<step>.pt` per save holding the model's state dict
(float32 parameters and the BatchNorm statistics), the optimizer state
(Adam moments, the update count the schedule reads, the accumulation
state) and the step.  The newest `max_to_keep` files are kept.
"""

from __future__ import annotations

import os

import torch


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


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
