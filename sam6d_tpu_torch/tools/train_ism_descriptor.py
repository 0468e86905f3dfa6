"""Train a small DINOv2-style descriptor on procedural NOCS-coloured
objects, so that the ISM's three-score path runs on learned weights.

Counterpart of `tools/train_ism_descriptor.py`.  No DINOv2 checkpoint can
be fetched, so this trains a tiny `DinoViT` with an NT-Xent objective over
the CLS descriptors of masked template-style crops: two random views of
one object are positives, the other objects of the batch negatives, the
invariance the reference's semantic score uses.  Held-out objects are
never seen: the descriptor must generalise zero-shot.

K5 is forward-only, so the model trains with `use_flash=False` (the
materialized attention); `ism_accuracy_eval` serves the trained weights
with K5 on the card.  optax's Adam is `torch.optim.Adam` (same betas,
eps and bias correction) under a `LambdaLR` of the same schedule
(constant here).  The view pools and batches come from the JAX tool's
`RandomState(0)` draws; PIL's resizes are `utils/resize.pil_resize`,
equal to PIL's arrays.

Usage:
  python -m sam6d_tpu_torch.tools.train_ism_descriptor --steps 1500 \\
      --ckpt_dir .ckpt_ism_desc [--device cpu]
Then: python -m sam6d_tpu_torch.tools.ism_accuracy_eval --desc_ckpt ...
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from sam6d_tpu_torch.config import DescriptorConfig

CKPT_FILE = "descriptor.npz"


def tiny_descriptor_config() -> DescriptorConfig:
    """128-d, 6 blocks, 64 px crops of 8 px patches (65 tokens, head dim
    32): about 100x under the reference's ViT-L/14."""
    return DescriptorConfig(
        model_type="tiny", image_size=64, patch_size=8, embed_dim=128,
        depth=6, num_heads=4, chunk_size=16,
    )


def render_object_views(mesh, n_views: int, crop_size: int, rng,
                        jitter: bool = True):
    """(V, S, S, 3) [0, 1] masked crops and (V, S, S) masks of one object,
    rendered from random directions with a random in-plane roll (views
    whose mask is under 16 pixels are dropped)."""
    from sam6d_tpu_torch.provider.training_dataset import (
        _render_view,
        random_rotation,
    )
    from sam6d_tpu_torch.utils.bbox import square_bbox
    from sam6d_tpu_torch.utils.resize import pil_resize

    S = 96
    f = float(S)
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    radius = float(np.linalg.norm(mesh.vertices, axis=1).max())
    imgs, masks = [], []
    for _ in range(n_views):
        R = random_rotation(rng)
        t = np.array([0.0, 0.0, 2.8 * radius], np.float32)
        if jitter:
            t[2] *= rng.uniform(0.9, 1.2)
        rgb, mask, _, _ = _render_view(mesh, R, t, K, (S, S))
        if mask.sum() < 16:
            continue
        y1, y2, x1, x2 = square_bbox(mask)
        crop = rgb[y1:y2, x1:x2] * (mask[y1:y2, x1:x2, None] > 0)
        m = mask[y1:y2, x1:x2]
        crop = pil_resize(crop.astype(np.uint8), crop_size, crop_size,
                          "bilinear").astype(np.float32) / 255.0
        m = pil_resize((m * 255).astype(np.uint8), crop_size, crop_size,
                       "nearest") > 127
        imgs.append(crop)
        masks.append(m)
    return np.stack(imgs), np.stack(masks)


def render_pools(n_objects: int, views_per_object: int, crop_size: int,
                 rng):
    """Each training object's view pool, meshes and views drawn from
    `rng` in the JAX tool's order."""
    from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh

    pools = []
    for _ in range(n_objects):
        mesh = make_procedural_mesh(rng)
        imgs, _ = render_object_views(mesh, views_per_object, crop_size, rng)
        pools.append(imgs)
    return pools


def photometric(rng, img):
    """Brightness / contrast jitter: the query crops come from shaded scene
    renders, darker than the templates; the descriptor must not mind."""
    g = rng.uniform(0.75, 1.25)
    c = rng.uniform(0.8, 1.2)
    mean = img.mean(axis=(0, 1), keepdims=True)
    out = (img - mean) * c + mean * g
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def make_batch(pools, rng, batch_objects: int):
    """(2B, S, S, 3) [0, 1] crops: rows b and B + b are two views of one
    object, B objects drawn without replacement."""
    objs = rng.choice(len(pools), batch_objects, replace=False)
    a, b = [], []
    for o in objs:
        v1, v2 = rng.choice(len(pools[o]), 2, replace=False)
        a.append(photometric(rng, pools[o][v1]))
        b.append(photometric(rng, pools[o][v2]))
    return np.concatenate([np.stack(a), np.stack(b)])


def make_descriptor(cfg: DescriptorConfig, device="cuda",
                    use_flash: bool = False, seed: int = 0):
    """The descriptor with seeded random weights; use_flash=False for
    training (K5 is forward-only)."""
    from sam6d_tpu_torch.device import resolve_device
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.params import init_random_

    model = DescriptorModel(cfg, use_flash=use_flash)
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device))


def nt_xent(cls: torch.Tensor, temperature: float):
    """NT-Xent over (2B, D) CLS descriptors paired b <-> B + b: (loss,
    pair accuracy)."""
    from sam6d_tpu_torch.ops.geometry import l2_normalize

    B = cls.shape[0] // 2
    z = l2_normalize(cls.float())
    sim = z @ z.T / temperature
    sim = sim - 1e9 * torch.eye(2 * B, device=sim.device)
    ar = torch.arange(B, device=sim.device)
    targets = torch.cat([ar + B, ar])
    loss = F.cross_entropy(sim, targets)
    acc = (sim.argmax(dim=1) == targets).float().mean()
    return loss, acc


def make_optimizer(params, lr: float, schedule=None):
    """optax.adam(schedule) as torch: Adam (0.9, 0.999, eps 1e-8) with a
    LambdaLR of schedule(count) / lr (count = updates applied so far)."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    factor = ((lambda c: 1.0) if schedule is None
              else (lambda c: schedule(c) / lr))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def train_step(model, opt, sched, batch: np.ndarray, temperature: float):
    """One NT-Xent step on a [0, 1] batch (normalised here)."""
    from sam6d_tpu_torch.models.ism.detector import normalize_rgb

    dev = next(model.parameters()).device
    x = normalize_rgb(torch.as_tensor(batch, device=dev))
    opt.zero_grad(set_to_none=True)
    cls, _ = model.vit(x)
    loss, acc = nt_xent(cls, temperature)
    loss.backward()
    opt.step()
    sched.step()
    return float(loss.detach()), float(acc)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--objects", type=int, default=160)
    p.add_argument("--views_per_object", type=int, default=16)
    p.add_argument("--batch_objects", type=int, default=24)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--ckpt_dir", default=".ckpt_ism_desc")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sam6d_tpu_torch.train.checkpoint import params_file, save_params

    cfg = tiny_descriptor_config()
    rng = np.random.RandomState(0)
    print(f"rendering view pools: {args.objects} objects x "
          f"{args.views_per_object} views", flush=True)
    t0 = time.time()
    pools = render_pools(args.objects, args.views_per_object,
                         cfg.image_size, rng)
    print(f"pools ready in {time.time() - t0:.0f} s", flush=True)

    model = make_descriptor(cfg, args.device)
    opt, sched = make_optimizer(model.parameters(), args.lr)
    t0 = time.time()
    log = []
    for it in range(args.steps):
        batch = make_batch(pools, rng, args.batch_objects)
        loss, acc = train_step(model, opt, sched, batch, args.temperature)
        log.append((loss, acc))
        if (it + 1) % 50 == 0:
            print(f"step {it + 1}/{args.steps} nt-xent {loss:.3f} "
                  f"pair-acc {acc:.3f} | "
                  f"{(it + 1) / (time.time() - t0):.2f} steps/s", flush=True)
    path = save_params(params_file(args.ckpt_dir, CKPT_FILE), model.vit)
    rec = {"steps": args.steps, "final_pair_acc": log[-1][1] if log else None,
           "objects": args.objects, "wall_s": time.time() - t0, "ckpt": path}
    with open(os.path.join(args.ckpt_dir, "train_meta.json"), "w") as f:
        json.dump(rec, f)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
