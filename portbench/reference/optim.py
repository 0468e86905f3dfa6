"""The PEM's optimizer, plain: global-norm clipping, the spike guard and
Adam with a warmup-cosine learning rate, element by element in float32.

The function of `sam6d_tpu_torch/train/state.py:Optimizer` (the JAX
package's optax chain; SAM-6D config/base.yaml:3-14): clip g to norm
`grad_clip` when its global norm is not below it; drop the update when
the norm is not finite or not below `spike_skip_norm`; else
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
p -= lr(count) (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p),
with t = count + 1 and lr linear from lr * warmup_factor to lr over
warmup_iters.  The port's Adam is torch's fused AdamW; this one is
written out.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def learning_rate(cfg, count: int) -> float:
    """The warmup-cosine schedule at `count` updates, in float32."""
    f = np.float32
    init, end, W = cfg.lr * cfg.warmup_factor, cfg.lr, cfg.warmup_iters
    decay = float(max(cfg.max_iters - cfg.warmup_iters, 1))
    if W > 0 and count < W:
        frac = f(1) - f(min(max(count, 0), W)) / f(W)
        return float(f(init - end) * frac + f(end))
    c = f(min(count - W, decay))
    return float(f(end) * f(0.5) * (f(1) + np.cos(f(math.pi) * c / f(decay))))


class Adam:
    def __init__(self, params, cfg):
        self.params = list(params)
        self.cfg = cfg
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> tuple[list, float]:
        """Apply one step; returns (the gradients as Adam took them, after
        clipping, and the global norm before it)."""
        cfg = self.cfg
        gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))
        guard = float(cfg.spike_skip_norm) if cfg.spike_skip_norm else math.inf
        if not (math.isfinite(gnorm) and gnorm < guard):
            return [torch.zeros_like(g) for g in grads], gnorm
        if cfg.grad_clip and not gnorm < cfg.grad_clip:
            grads = [g * (cfg.grad_clip / gnorm) for g in grads]
        b1, b2 = cfg.betas
        t = self.count + 1
        lr = learning_rate(cfg, self.count)
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + cfg.eps)
                         + cfg.weight_decay * p))
        self.count += 1
        return grads, gnorm
