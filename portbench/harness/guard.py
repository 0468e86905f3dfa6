"""Guards of a run: no JAX in the process, a card to run on."""

from __future__ import annotations

import sys

# Top-level module names that may not be loaded in a run: JAX, its
# libraries, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "sam6d_tpu")


def forbidden_loaded(names=None) -> list[str]:
    """Loaded module names whose top-level name (the part before the
    first dot) is one of FORBIDDEN, compared whole: `sam6d_tpu_torch`
    passes, `sam6d_tpu.config` does not."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_no_jax(when: str) -> None:
    """Exit with code 3, naming what was found, if a forbidden module is
    loaded."""
    found = forbidden_loaded()
    if found:
        print(f"portbench: forbidden modules loaded {when}: {found}",
              file=sys.stderr, flush=True)
        sys.exit(3)


def require_cards(n: int) -> None:
    """Exit with code 2 unless torch sees at least n CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr, flush=True)
        sys.exit(2)
    if torch.cuda.device_count() < n:
        print(f"portbench: the cell needs {n} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr, flush=True)
        sys.exit(2)
