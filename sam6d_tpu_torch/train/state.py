"""Train state, optimizer and schedule, and the PEM train step.

Counterpart of `sam6d_tpu/train/state.py` (reference train.py:27-138 and
utils/solver.py).  `Optimizer` reproduces the JAX package's optax chain
(`make_optimizer`) update for update:

* Adam (betas (0.5, 0.999), eps 1e-6, optax's bias correction) with a
  warmup-cosine learning rate evaluated at the count of updates applied
  so far, so the first update uses lr * warmup_factor;
* global-norm clipping at `grad_clip` (g * clip / norm when the norm is
  not below clip, optax's formula);
* spike skipping: when the gradient norm is non-finite or not below
  `spike_skip_norm`, the update is dropped and the optimizer state, the
  schedule's count included, stays as it was;
* `accum_steps` microbatches averaged (optax.MultiSteps) before the
  guarded update.

Parameters and optimizer state are float32; the model computes in its
compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sam6d_tpu_torch.config import OptimConfig, PEMConfig
from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.pem.model import PEM
from sam6d_tpu_torch.params import init_random_
from sam6d_tpu_torch.train.loss import pem_loss
from sam6d_tpu_torch.utils.timer import stage

_F32 = np.float32
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


def warmup_cosine_schedule(cfg: OptimConfig):
    """count -> learning rate: linear from lr * warmup_factor to lr over
    warmup_iters, then cosine decay to 0 at max_iters, in float32 as optax
    evaluates it (`join_schedules` of a linear and a cosine schedule)."""
    init, end, W = cfg.lr * cfg.warmup_factor, cfg.lr, cfg.warmup_iters
    decay = float(max(cfg.max_iters - cfg.warmup_iters, 1))

    def schedule(count: int) -> float:
        if W > 0 and count < W:
            frac = _F32(1) - _F32(min(max(count, 0), W)) / _F32(W)
            return float(_F32(init - end) * frac + _F32(end))
        c = _F32(min(count - W, decay))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                                / _F32(decay)))
        return float(_F32(end) * cosine)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (float32)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """The optax chain of `make_optimizer` over a list of float32
    parameters, updated in place.  `count` is the number of updates
    applied: Adam's bias-correction count and the schedule's count (optax
    keeps one of each; in this chain they always agree).

    The Adam step is `torch.optim.AdamW` (fused; optax's adamw computes
    the same m_hat / (sqrt(v_hat) + eps) + wd * p), its learning rate set
    from the schedule before each applied update.  A skipped update never
    calls it, so its moments and bias-correction count stay."""

    def __init__(self, params, cfg: OptimConfig):
        self.params = list(params)
        self.cfg = cfg
        self.schedule = warmup_cosine_schedule(cfg)
        self.count = 0
        self.adam = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=tuple(cfg.betas),
            eps=cfg.eps, weight_decay=cfg.weight_decay, fused=True)
        if cfg.spike_skip_norm:
            self.guard = float(cfg.spike_skip_norm)
        elif cfg.skip_nonfinite:
            self.guard = math.inf
        else:
            self.guard = None
        # Microbatch accumulation (optax.MultiSteps, averaged).
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.accum_steps > 1 else None)

    @torch.no_grad()
    def step(self, grads, grad_norm=None) -> bool:
        """Apply one microbatch's gradients; True when the parameters
        moved.  grad_norm: the global norm of grads, if already known.
        Clipping scales the gradients in place."""
        if self.acc is None:
            gn = global_norm(grads) if grad_norm is None else grad_norm
            return self._update(grads, float(gn))
        n = self.mini_step
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (n + 1))
        applied = False
        if n == self.cfg.accum_steps - 1:
            applied = self._update(self.acc, float(global_norm(self.acc)))
            for a in self.acc:
                a.mul_(0.0)  # optax's (1 - emit) * acc: a NaN would stay
        self.mini_step = (n + 1) % self.cfg.accum_steps
        return applied

    def _update(self, grads, gnorm: float) -> bool:
        """Clip (in place) and apply `grads` unless the guard drops them."""
        cfg = self.cfg
        if self.guard is not None and not (math.isfinite(gnorm)
                                           and gnorm < self.guard):
            return False
        grads = list(grads)
        if cfg.grad_clip and not gnorm < cfg.grad_clip:
            torch._foreach_div_(grads, float(_F32(gnorm)))
            torch._foreach_mul_(grads, cfg.grad_clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.param_groups[0]["lr"] = float(self.schedule(self.count))
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def _moment(self, key: str) -> list:
        return [self.adam.state.get(p, {}).get(key, torch.zeros_like(p))
                for p in self.params]

    @property
    def mu(self) -> list:
        """Adam's first moments (zeros before the first update)."""
        return self._moment("exp_avg")

    @property
    def nu(self) -> list:
        """Adam's second moments (zeros before the first update)."""
        return self._moment("exp_avg_sq")

    def state_dict(self) -> dict:
        return {"count": self.count, "adam": self.adam.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.mini_step = int(sd["mini_step"])
        self.adam.load_state_dict(sd["adam"])
        for d, s in zip(self.acc or [], sd["acc"] or []):
            d.copy_(s)


class TrainState:
    """The model (float32 parameters, BatchNorm statistics as buffers),
    its optimizer, the step counter and the loss settings.  `parallel`:
    this rank's place on a ("dp", "tp") mesh
    (`parallel.sharding.shard_train_state`), None on one process."""

    parallel = None

    def __init__(self, model: PEM, optim_cfg: OptimConfig):
        self.model = model
        self.optimizer = Optimizer(model.parameters(), optim_cfg)
        self.step = 0
        cfg = model.cfg
        self.coarse_dis_thres = cfg.coarse_point_matching.loss_dis_thres
        self.fine_dis_thres = cfg.fine_point_matching.loss_dis_thres
        self.spike_skip_norm = float(optim_cfg.spike_skip_norm or math.inf)


def create_train_state(pem_cfg: PEMConfig, optim_cfg: OptimConfig,
                       device="cuda", compute_dtype=torch.float32,
                       seed: int = 0, state_dict=None) -> TrainState:
    """A PEM on `device` computing in `compute_dtype` (parameters float32)
    with random weights from `seed` (`params.init_random_`) or
    `state_dict`, and a fresh optimizer."""
    model = PEM(pem_cfg, dtype=compute_dtype, device=resolve_device(device))
    if state_dict is None:
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return TrainState(model, optim_cfg)


def _to_device(batch: dict, device) -> dict:
    """Numpy or torch batch -> tensors on `device`; uint8 images are
    normalised there (ImageNet mean and std), so they cross to the card
    at a quarter of the bytes."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        if k in ("rgb", "tem_rgb") and t.dtype == torch.uint8:
            mean = torch.tensor(RGB_MEAN, device=device)
            std = torch.tensor(RGB_STD, device=device)
            t = (t.float() / 255.0 - mean) / std
        elif t.dtype in (torch.int32, torch.int64):
            t = t.long()
        elif t.is_floating_point():
            t = t.float()
        out[k] = t
    return out


def train_step(state: TrainState, batch: dict, generator=None,
               noise=None) -> dict:
    """One step on `batch`, in place; returns the metrics as floats.

    The batch (numpy or torch): pts, rgb, rgb_choose, tem_rgb, tem_pts,
    tem_choose (raw templates, through `PEM.train_forward`), gt_r, gt_t.
    The pose-noise draws come from `noise` or `generator`.  On
    non-finite gradients the BatchNorm statistics keep their values from
    before the step.  With `state.parallel` the batch (and `noise`) are
    the global ones: this rank takes its dp rows of them, or of the
    generator's one draw for the whole batch, and the gradients, the
    metrics and the norm are those of the whole batch
    (`parallel/sharding.py`).  Spans (`utils/timer.stage`): train.step
    (its request `state.step`) over train.to_device, train.forward (through
    the loss), train.backward, train.read_metrics (the host's read of the
    metrics and the gradient norm, a sync) and train.optimizer.
    """
    with stage(None, "train.step", request=state.step):
        return _train_step(state, batch, generator, noise)


def _train_step(state: TrainState, batch: dict, generator, noise) -> dict:
    model = state.model
    par = state.parallel
    dev = next(model.parameters()).device
    with stage(None, "train.to_device"):
        if par is not None:
            noise = par.pose_noise(len(batch["gt_r"]), generator, dev, noise)
            batch = par.shard_batch(batch)
        b = _to_device(batch, dev)
    saved = {k: v.clone() for k, v in model.named_buffers()}
    model.zero_grad(set_to_none=True)
    with torch.enable_grad():
        with stage(None, "train.forward"):
            out = model.train_forward(
                b["pts"], b["rgb"], b["rgb_choose"], b["tem_rgb"],
                b["tem_pts"], b["tem_choose"], b["gt_r"], b["gt_t"],
                generator=generator, noise=noise)
            loss, metrics = pem_loss(out, b["gt_r"], b["gt_t"],
                                     state.coarse_dis_thres,
                                     state.fine_dis_thres)
        with stage(None, "train.backward"):
            loss.backward()
    with stage(None, "train.read_metrics"):
        params = list(model.parameters())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        names = list(metrics)
        values = torch.stack([metrics[k].detach().float() for k in names])
        if par is None:
            grad_norm = global_norm(grads)
        else:
            par.reduce_grads(grads)
            grad_norm = par.grad_norm(params, grads)
            values = par.mean_over_dp(values)
        values = torch.cat([values, grad_norm.reshape(1)]).tolist()
    out_metrics = dict(zip(names, values[:-1]))
    gn = values[-1]
    finite = math.isfinite(gn)
    with stage(None, "train.optimizer"):
        if not finite:
            with torch.no_grad():
                for k, v in model.named_buffers():
                    v.copy_(saved[k])
        state.optimizer.step(grads, gn)
    model.zero_grad(set_to_none=True)
    state.step += 1
    out_metrics.update(
        grads_finite=float(finite), grad_norm=gn,
        update_skipped=float(not (finite and gn < state.spike_skip_norm)))
    return out_metrics
