"""Learnability on synthetic data: train a small PEM, then check that the
inference pose accuracy on held-out objects improves.

Counterpart of `tools/smoke_train_eval.py`.  With no released weights,
this is the whole-system check that the port learns: train with the
reference's correspondence loss (`train/state.py:train_step`), then run
the full inference path (template features through `get_obj_feats`, the
bank, the coarse hypothesis solve and the fine solve of
`forward_with_bank`) on held-out samples and report the rotation and
translation errors against the ground truth before and after training.

Datasets: `rendered` (default; `RenderedPoseDataset`, procedural
NOCS-coloured meshes, held-out samples of NEW objects) and `random`
(`SyntheticPoseDataset`, noise images and blob geometry: the negative
control on which held-out accuracy does not improve).

The JAX tool's record (2000 steps, batch 8, 128 train objects): held-out
rotation error median 141.7 -> 12.0 deg, translation 23.5 -> 2.2 mm.

Usage: python -m sam6d_tpu_torch.tools.smoke_train_eval [--steps 2000]
    [--eval 16] [--ckpt_dir .ckpt_smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sam6d_tpu_torch.config import OptimConfig, TrainConfig
from sam6d_tpu_torch.tools.e2e_synthetic_ar import smoke_pem_config


def rot_err_deg(Ra, Rb):
    cos = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def train_config(batch_size: int = 8) -> TrainConfig:
    return TrainConfig(batch_size=batch_size, img_size=32,
                       n_sample_observed_point=128,
                       n_sample_template_point=128)


def optim_config(lr: float = 3e-4, steps: int = 2000) -> OptimConfig:
    return OptimConfig(lr=lr, warmup_iters=20, max_iters=steps * 2)


def make_datasets(kind: str, train_cfg: TrainConfig, objects: int = 32,
                  eval_objects: int = 8, template_views: int = 8,
                  n_eval: int = 16):
    """(training dataset, held-out dataset), as the JAX tool seeds them."""
    from sam6d_tpu_torch.provider.training_dataset import (
        RenderedPoseDataset,
        SyntheticPoseDataset,
    )

    if kind == "rendered":
        return (RenderedPoseDataset(train_cfg, n_objects=objects,
                                    n_template_views=template_views,
                                    n_samples=10**9, seed=0),
                RenderedPoseDataset(train_cfg, n_objects=eval_objects,
                                    n_template_views=template_views,
                                    n_samples=n_eval, seed=987654321))
    if kind == "random":
        return (SyntheticPoseDataset(train_cfg, n_samples=10**9, seed=0),
                SyntheticPoseDataset(train_cfg, n_samples=n_eval,
                                     seed=777777))
    raise ValueError(kind)


def eval_sample(source, kind: str, i: int, index_base: int = 0):
    """Held-out sample i and its template bank (T views)."""
    if kind == "rendered":
        s = source.sample(index_base + i, aug=False)
        return s, source.template_arrays(s["obj_idx"], seed=i)
    s = source[i]
    return s, (s["tem_rgb"], s["tem_choose"], s["tem_pts"])


@torch.no_grad()
def attention_metrics(model, batch, coarse_thres, fine_thres, noise=None):
    """The loss metrics of `batch` through `train_forward` (train-mode
    BatchNorm, as the JAX tool's mutable apply), the running statistics
    restored afterwards; the fine stage's pose noise from `noise` or a
    generator seeded 0."""
    from sam6d_tpu_torch.train.loss import pem_loss
    from sam6d_tpu_torch.train.state import _to_device

    dev = next(model.parameters()).device
    saved = {k: v.clone() for k, v in model.named_buffers()}
    b = _to_device(batch, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = model.train_forward(b["pts"], b["rgb"], b["rgb_choose"],
                              b["tem_rgb"], b["tem_pts"], b["tem_choose"],
                              b["gt_r"], b["gt_t"], generator=gen,
                              noise=noise)
    _, metrics = pem_loss(out, b["gt_r"], b["gt_t"], coarse_thres, fine_thres)
    for k, v in model.named_buffers():
        v.copy_(saved[k])
    return {k: float(v) for k, v in metrics.items()}


def evaluate(model, source, kind: str = "rendered", n_eval: int = 16,
             batch_size: int = 8, index_base: int = 0, tag: str = "eval",
             uniforms=None, seed: int = 0, metrics_noise=None):
    """Rotation / translation errors of the full inference path on
    `n_eval` held-out samples, and the attention diagnostics on a batch
    of them.  uniforms: optional i -> (u1, u2), sample i's coarse draws
    (the JAX tool draws them from PRNGKey(i)); else from a generator
    seeded `seed`; metrics_noise: the diagnostics' pose noise
    (`attention_metrics`).  Returns the medians and the per-sample
    errors."""
    from sam6d_tpu_torch.provider.training_dataset import collate

    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rerrs, terrs, crerrs = [], [], []

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    for i in range(n_eval):
        s, (tem_rgb, tem_choose, tem_pts) = eval_sample(source, kind, i,
                                                        index_base)
        po, fo = model.get_obj_feats(t(tem_rgb), t(tem_pts),
                                     t(tem_choose, torch.long))
        # The JAX tool poses through `PEM.__call__`, which rescores every
        # kept hypothesis exactly: no distance field.
        bank = dict(model.make_template_bank(po, fo), dist_field=None)
        u = None if uniforms is None else tuple(
            t(x) for x in uniforms(i))
        out = model.forward_with_bank(
            t(s["pts"])[None], t(s["rgb"])[None],
            t(s["rgb_choose"], torch.long)[None], po, bank, generator=gen,
            uniforms=u)
        R = out["pred_R"][0].float().cpu().numpy()
        tr = out["pred_t"][0].float().cpu().numpy()
        rerrs.append(rot_err_deg(R, s["gt_r"]))
        terrs.append(float(np.linalg.norm(tr - s["gt_t"])))
        crerrs.append(rot_err_deg(out["init_R"][0].float().cpu().numpy(),
                                  s["gt_r"]))

    nb = min(n_eval, batch_size)
    ebatch = collate([eval_sample(source, kind, i, index_base)[0]
                      for i in range(nb)])
    cfg = model.cfg
    em = attention_metrics(model, ebatch,
                           cfg.coarse_point_matching.loss_dis_thres,
                           cfg.fine_point_matching.loss_dis_thres,
                           metrics_noise)
    print(f"[{tag}] rot err: mean {np.mean(rerrs):.1f} deg "
          f"median {np.median(rerrs):.1f} | trans err: "
          f"mean {np.mean(terrs) * 1000:.1f} mm "
          f"median {np.median(terrs) * 1000:.1f} mm | "
          f"coarse rot median {np.median(crerrs):.1f} deg | "
          f"eval c_acc {em['coarse_acc']:.3f} f_acc {em['fine_acc']:.3f} "
          f"c_fg {em['coarse_fg_num']:.0f} f_fg {em['fine_fg_num']:.0f}",
          flush=True)
    return {"rot_median": float(np.median(rerrs)),
            "trans_median": float(np.median(terrs)),
            "coarse_rot_median": float(np.median(crerrs)),
            "rot_errs": [float(x) for x in rerrs],
            "trans_errs": terrs, "coarse_rot_errs": [float(x) for x in crerrs],
            "metrics": em}


def train(state, ds, steps: int, batch_size: int, start_index: int = 0,
          generator=None, noise=None, log_every: int = 25, on_step=None):
    """`steps` train steps on consecutive samples of `ds` from
    `start_index`; the pose noise from `noise(it)` if given, else from
    `generator`.  Returns the metrics of every step, each with its
    device time (`step_ms`, CUDA events on the card, host clock on the
    CPU)."""
    from sam6d_tpu_torch.provider.training_dataset import collate
    from sam6d_tpu_torch.train.state import train_step

    dev = next(state.model.parameters()).device
    cuda = dev.type == "cuda"
    log, idx, t_start = [], start_index, time.time()
    for it in range(steps):
        batch = collate([ds[idx + j] for j in range(batch_size)])
        idx += batch_size
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        m = train_step(state, batch, generator=generator,
                       noise=None if noise is None else noise(it))
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            m["step_ms"] = ev[0].elapsed_time(ev[1])
        else:
            m["step_ms"] = (time.perf_counter() - t0) * 1e3
        log.append(m)
        if (it + 1) % log_every == 0:
            print(f"step {state.step}: loss {m['loss']:.3f} "
                  f"coarse_acc {m['coarse_acc']:.3f} "
                  f"fine_acc {m['fine_acc']:.3f} "
                  f"({(time.time() - t_start) / (it + 1):.2f} s/step)",
                  flush=True)
        if on_step is not None:
            on_step(it)
    return log


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--eval", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dataset", choices=("rendered", "random"),
                   default="rendered")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--eval_objects", type=int, default=8)
    p.add_argument("--template_views", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--eval_every", type=int, default=0,
                   help="also evaluate every N steps")
    p.add_argument("--ckpt_dir", default="",
                   help="save (and resume) the train state here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sam6d_tpu_torch.train.checkpoint import (
        restore_train_state,
        save_train_state,
    )
    from sam6d_tpu_torch.train.state import create_train_state

    pem_cfg = smoke_pem_config()
    tcfg = train_config(args.batch_size)
    ds, ev = make_datasets(args.dataset, tcfg, args.objects,
                           args.eval_objects, args.template_views, args.eval)
    state = create_train_state(pem_cfg, optim_config(args.lr, args.steps),
                               device=args.device, seed=0)
    if args.ckpt_dir:
        try:
            restore_train_state(args.ckpt_dir, state)
            print(f"resumed from step {state.step}", flush=True)
        except FileNotFoundError:
            pass

    def ev_fn(tag, dataset=None, index_base=0):
        return evaluate(state.model, dataset or ev, args.dataset, args.eval,
                        args.batch_size, index_base, tag)

    before = ev_fn("untrained")

    def on_step(it):
        if args.eval_every and (it + 1) % args.eval_every == 0:
            ev_fn(f"step {it + 1}")
            if args.dataset == "rendered":
                # Held-out views of training objects: generalisation to new
                # objects apart from the inference path itself.
                ev_fn(f"step {it + 1} train-obj", ds, 500_000_000)

    gen = torch.Generator(device=args.device).manual_seed(1)
    log = train(state, ds, args.steps - state.step, args.batch_size,
                start_index=state.step * args.batch_size, generator=gen,
                on_step=on_step)
    if args.ckpt_dir:
        save_train_state(args.ckpt_dir, state)
        print(f"saved state at step {state.step}", flush=True)
    after = ev_fn(f"trained {args.steps} steps")
    print(f"improvement: rot {before['rot_median']:.1f} -> "
          f"{after['rot_median']:.1f} deg, trans "
          f"{before['trans_median'] * 1000:.1f} -> "
          f"{after['trans_median'] * 1000:.1f} mm", flush=True)
    return {"before": before, "after": after, "log": log}


if __name__ == "__main__":
    main()
