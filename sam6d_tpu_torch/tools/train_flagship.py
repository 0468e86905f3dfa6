"""Training of the full-width PEM on rendered data, and its synthetic
BOP AR.

Counterpart of `tools/train_flagship.py`: the shipped config
(`default_pem_config`: 196 / 2048 points, 256-d transformer, ViT-B/16
feature extraction) with bf16 compute and float32 parameters and Adam
state, trained on `RenderedPoseDataset` samples at full shapes (2048
observed points, 224 px crops, 5000-point template views), then scored on
held-out frames of a never-trained object at the BOP AR through the file
pipeline (`e2e_synthetic_ar.run_eval`), random weights against trained.

Data: by default an unbounded stream of fresh samples from forked numpy
workers (`ProcessSampleStream`) handed to the card by `DevicePrefetcher`;
`--pool N` pre-renders N samples and reshuffles them each epoch.  The
JAX tool's orbax checkpoints are the port's `save_train_state` /
`restore_train_state` files; block remat is not needed on the card (the
batch-28 step fits in 59 GiB).

The JAX record: AR 0.868-0.902 at 2k steps, 0.969-0.978 at 6-8k.

Usage:
  python -m sam6d_tpu_torch.tools.train_flagship --steps 2000 \\
      --batch_size 8 --ckpt_dir .ckpt_flagship [--eval_curve 500,1000]
  python -m sam6d_tpu_torch.tools.train_flagship --eval_only \\
      --ckpt_dir .ckpt_flagship
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sam6d_tpu_torch.config import OptimConfig, TrainConfig, default_pem_config

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def optim_config(lr: float = 1e-4, steps: int = 6000,
                 max_iters: int | None = None) -> OptimConfig:
    """Warmup 200, cosine decay to 0 at max_iters (default: the run's
    steps, at least 1000)."""
    return OptimConfig(lr=lr, warmup_iters=200,
                       max_iters=max_iters or max(steps, 1000))


def make_state(cfg, optim: OptimConfig, device="cuda", dtype="bf16",
               seed: int = 0):
    from sam6d_tpu_torch.train.state import create_train_state

    return create_train_state(cfg, optim, device=device,
                              compute_dtype=DTYPES[dtype], seed=seed)


def make_dataset(batch_size: int, objects: int = 64,
                 template_views: int = 8):
    """The rendered pool at full shapes, uint8 image planes (normalised
    on the card)."""
    from sam6d_tpu_torch.provider.training_dataset import RenderedPoseDataset

    return RenderedPoseDataset(TrainConfig(batch_size=batch_size),
                               n_objects=objects,
                               n_template_views=template_views,
                               n_samples=10**9, seed=0, uint8_rgb=True)


def make_stream(ds, batch_size: int, steps: int, done_before: int = 0,
                pool: int = 0, workers: int = 2):
    """The host batch stream: fresh samples from `workers` forked
    processes, or with pool > 0 a fixed pool of that many samples,
    reshuffled each epoch (`RandomState(7)`)."""
    from sam6d_tpu_torch.provider.training_dataset import collate
    from sam6d_tpu_torch.train.solver import BatchPrefetcher, ProcessSampleStream

    if pool <= 0:
        return ProcessSampleStream(ds, batch_size, n_workers=workers,
                                   start_index=done_before * batch_size)
    samples = [ds[i] for i in range(pool)]

    def batches():
        rng = np.random.RandomState(7)
        order, pos = rng.permutation(pool), 0
        for _ in range(done_before, steps):
            if pos + batch_size > pool:
                order, pos = rng.permutation(pool), 0
            yield collate([samples[j] for j in order[pos:pos + batch_size]])
            pos += batch_size

    return BatchPrefetcher(batches(), depth=3)


def train(state, stream, steps: int, ckpt_dir: str | None = None,
          ckpt_every: int = 500, generator=None, log_every: int = 25):
    """Train from `state.step` to `steps` on the stream's batches (moved
    to the card ahead of the step by `DevicePrefetcher`); metrics every 5
    steps to `<ckpt_dir>/metrics.jsonl`, the train state every
    `ckpt_every` steps and at the end.  Returns each step's metrics with
    its device time (`step_ms`, CUDA events) and the host's wait for its
    batch (`wait_ms`)."""
    from sam6d_tpu_torch.train.checkpoint import save_train_state
    from sam6d_tpu_torch.train.solver import DevicePrefetcher
    from sam6d_tpu_torch.train.state import train_step

    dev = next(state.model.parameters()).device
    cuda = dev.type == "cuda"
    done_before = state.step
    mlog = None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        mlog = open(os.path.join(ckpt_dir, "metrics.jsonl"), "a")
    feed = DevicePrefetcher(iter(stream), device=dev) if cuda else None
    batches = iter(feed if cuda else stream)
    log, t_start = [], time.time()
    try:
        for it in range(done_before, steps):
            t0 = time.perf_counter()
            batch = next(batches)
            wait_ms = (time.perf_counter() - t0) * 1e3
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            t1 = time.perf_counter()
            m = train_step(state, batch, generator=generator)
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                m["step_ms"] = ev[0].elapsed_time(ev[1])
            else:
                m["step_ms"] = (time.perf_counter() - t1) * 1e3
            m["wait_ms"] = wait_ms
            log.append(m)
            if mlog and (it + 1) % 5 == 0:
                mlog.write(json.dumps({"step": it + 1, **m}) + "\n")
                mlog.flush()
            if (it + 1) % log_every == 0:
                sps = (it + 1 - done_before) / (time.time() - t_start)
                print(f"step {it + 1}/{steps} loss {m['loss']:.3f} "
                      f"c_acc {m.get('coarse_acc', 0):.3f} "
                      f"f_acc {m.get('fine_acc', 0):.3f} "
                      f"c_fg {m.get('coarse_fg_num', 0):.0f} "
                      f"gnorm {m.get('grad_norm', 0):.2f} "
                      f"| {sps:.2f} steps/s (wall, incl. host)", flush=True)
            if ckpt_dir and ((it + 1) % ckpt_every == 0 or it + 1 == steps):
                save_train_state(ckpt_dir, state, max_to_keep=20)
                print(f"checkpointed @ {it + 1}", flush=True)
    finally:
        if feed is not None:
            feed.close()
        if hasattr(stream, "close"):
            stream.close()
        if mlog:
            mlog.close()
    return log


def eval_curve(cfg, ckpt_dir: str, eval_out: str, steps, frames: int = 12,
               device="cuda", ar_random=None):
    """AR of the random weights (unless given) and of each checkpoint
    step in `steps` (None: the newest) on `build_dataset`'s held-out
    object.  Returns (ar_random, {step: result})."""
    from sam6d_tpu_torch.tools.e2e_synthetic_ar import build_dataset, run_eval
    from sam6d_tpu_torch.train.checkpoint import restore_train_state

    cad, tdir, scene, dets = build_dataset(eval_out, frames=frames)
    state = make_state(cfg, OptimConfig(), device)
    if ar_random is None:
        ar_random = run_eval(state.model.state_dict(), cfg, cad, tdir, scene,
                             dets, eval_out, "random-flagship",
                             device=device)["ar"]
    curve = {}
    for s in steps:
        restore_train_state(ckpt_dir, state, step=s)
        out = run_eval(state.model.state_dict(), cfg, cad, tdir, scene,
                       dets, eval_out, f"trained-flagship(step {state.step})",
                       device=device)
        curve[state.step] = out
        print(f"AR @ step {state.step}: {out['ar']:.3f}", flush=True)
    return ar_random, curve


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--pool", type=int, default=0,
                   help="0: unbounded fresh samples from worker processes; "
                        "N > 0: a fixed pool of N samples")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--objects", type=int, default=64)
    p.add_argument("--template_views", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_iters", type=int, default=None,
                   help="cosine-decay horizon; default --steps")
    p.add_argument("--ckpt_dir", default=".ckpt_flagship")
    p.add_argument("--ckpt_every", type=int, default=500)
    p.add_argument("--eval_frames", type=int, default=12)
    p.add_argument("--eval_out", default="build/e2e_ar_flagship")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--eval_step", type=int, default=None,
                   help="evaluate this checkpoint step (default latest)")
    p.add_argument("--eval_curve", default=None,
                   help="comma-separated checkpoint steps to evaluate")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    p.add_argument("--bench_out", default=None,
                   help="the AR record (default <ckpt_dir>/flagship_ar.json)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sam6d_tpu_torch.train.checkpoint import (
        latest_step,
        restore_train_state,
    )

    cfg = default_pem_config()
    B = args.batch_size
    if not args.eval_only:
        # The resume step before anything touches the card, so the
        # workers fork from a parent with no CUDA work in flight.
        done = latest_step(args.ckpt_dir) or 0
        t0 = time.time()
        ds = make_dataset(B, args.objects, args.template_views)
        print(f"dataset ready in {time.time() - t0:.0f} s", flush=True)
        stream = make_stream(ds, B, args.steps, done, args.pool, args.workers)
        state = make_state(cfg, optim_config(args.lr, args.steps,
                                             args.max_iters),
                           args.device, args.dtype)
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"{n_params / 1e6:.1f} M params", flush=True)
        if done:
            restore_train_state(args.ckpt_dir, state)
            print(f"resumed from step {state.step}", flush=True)
        gen = torch.Generator(device=args.device).manual_seed(1)
        t0 = time.time()
        train(state, stream, args.steps, args.ckpt_dir, args.ckpt_every, gen)
        print(f"training done: "
              f"{(args.steps - done) / max(time.time() - t0, 1e-9):.2f} "
              f"steps/s wall-clock", flush=True)
    if args.skip_eval:
        return None

    bench = args.bench_out or os.path.join(args.ckpt_dir, "flagship_ar.json")
    prev = {}
    if os.path.exists(bench):
        with open(bench) as f:
            prev = json.load(f)
    steps = ([int(s) for s in args.eval_curve.split(",")]
             if args.eval_curve else [args.eval_step])
    ar_random, outs = eval_curve(cfg, args.ckpt_dir, args.eval_out, steps,
                                 args.eval_frames, args.device,
                                 prev.get("ar_random"))
    curve = dict(prev.get("ar_curve", {}))
    curve.update({str(s): o["ar"] for s, o in outs.items()})
    last = max(outs)
    rec = {"config": "flagship ViT-B 196/2048 " + args.dtype,
           "steps": last, "ar_random": ar_random,
           "ar_trained": outs[last]["ar"],
           "ar_curve": {k: curve[k] for k in sorted(curve, key=int)},
           "detail_trained": outs[last]}
    os.makedirs(os.path.dirname(os.path.abspath(bench)), exist_ok=True)
    with open(bench, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
