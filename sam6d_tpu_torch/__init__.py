"""PyTorch + CUDA port of SAM-6D: the ISM (SAM or FastSAM), the PEM, PEM
training, the file demo (`pipeline/demo.py`) and the converter of
released checkpoints (`convert_weights.py`).

The package mirrors the layout of the JAX package `sam6d_tpu` (`ops/`,
`models/`, `pipeline/`, `train/`, `utils/`) but imports nothing from it,
nor JAX or PIL: it is a standalone PyTorch program whose hot-path
kernels are hand-written CUDA C++ for Hopper (`csrc/`).

Matmul precision is pinned explicitly: float32 matmuls and convolutions
run in full float32, never TF32.  The JAX reference computes its
geometric and rescoring contractions at `Precision.HIGHEST`
(`models/pem/matching.py`), and TF32 keeps only ~3 decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sam6d_tpu_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
