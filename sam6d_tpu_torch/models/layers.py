"""Small layers shared by the port's modules.

Parameters are stored in float32, as the JAX package keeps them; each
layer casts to its compute dtype at use (a no-op once the weights have
been cast, see `cast_dense_weights`).  The norms compute their
statistics in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """nn.Linear that computes in `dtype` (flax nn.Dense(dtype=...))."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_dim, out_dim, bias=bias)
        self.dtype = dtype

    def reset_parameters(self):
        # Deterministic placeholder: weights come from a state dict or
        # from params.init_random_ with an explicit generator.
        nn.init.zeros_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.LayerNorm):
    """Float32 LayerNorm with flax's default eps 1e-6, output in `dtype`."""

    def __init__(self, dim: int, dtype=torch.float32, eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, flax's `nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`.

    Eval (`train=False`) normalises with the running statistics.  Train
    normalises with the batch statistics over every other axis, in
    float32, with the biased variance `mean(x^2) - mean(x)^2` (clamped at
    0), and updates the running statistics in place:
    `running = momentum * running + (1 - momentum) * batch`.  (PyTorch's
    `F.batch_norm` keeps the unbiased variance and the opposite momentum
    convention, so it is not used.)  Each train call makes one update, in
    call order."""

    momentum = 0.9

    def __init__(self, dim: int, dtype=torch.float32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp_min((xf * xf).mean(axes) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


def cast_dense_weights(module: nn.Module) -> nn.Module:
    """Store every Dense layer's weights, and the parameters of every
    module that sets `cast_with_dense` (SAM's rel-pos tables), in its
    compute dtype, so the forward does not cast them at each call (same
    rounding either way)."""
    for m in module.modules():
        if isinstance(m, Dense) or getattr(m, "cast_with_dense", False):
            m.to(m.dtype)
    return module


def f32_matmul(a, b):
    """a @ b with float32 inputs and output: the products of compute-dtype
    values accumulated in float32 (preferred_element_type=float32)."""
    return torch.matmul(a.float(), b.float())
