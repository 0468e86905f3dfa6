"""TF32 for float32 products, on or off inside a block."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 products inside the block where `on`; off after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
