"""Train a tiny SAM on rendered scenes, so that the AMG path proposes
masks from learned weights.

Counterpart of `tools/train_tiny_sam.py`.  Model: the same image encoder,
prompt encoder and mask decoder as the full SAM, shrunk (256 px input,
a 128-d 6-block encoder with global attention over its 16 x 16 grid, the
decoder at its native 256-d).  Data: scenes of 1-3 procedural
NOCS-coloured meshes merged by z-buffer, from the PEM's training
rasterizer.  Loss: SAM's recipe, per prompt the minimum over the 4
multimask outputs of 20 focal + dice on the low-resolution logits, plus
the MSE of the IoU head against each mask's actual IoU.

K4 is forward-only, so training builds the encoder with `flash=False`
(the materialized attention); `load_tiny_sam_amg` serves the trained
weights with `flash=None`, so K4 and the fused decode tail K6 run on the
card.  optax's Adam under `cosine_decay_schedule` is `torch.optim.Adam`
under a `LambdaLR` of the same schedule.  Scenes and prompts come from
the JAX tool's `RandomState(11)` draws; PIL's resizes are
`utils/resize.pil_resize`, equal to PIL's arrays.

The JAX record: AMG recall@0.5 0.848 over >= 100 instances.

Usage:
  python -m sam6d_tpu_torch.tools.train_tiny_sam --steps 1500 \\
      --ckpt .ckpt_tiny_sam [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from sam6d_tpu_torch.device import resolve_device

# 128-d, 6 blocks, all global over the 16 x 16 grid (head dim 32).
TINY_ENCODER = dict(
    embed_dim=128,
    depth=6,
    num_heads=4,
    global_attn_indexes=(0, 1, 2, 3, 4, 5),
    window_size=16,
)
# 256 px input -> 64 x 64 low-resolution logits.
TINY_IMG = 256
CKPT_FILE = "tiny_sam.npz"
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def make_tiny_sam(dtype=torch.float32, device="cuda", flash: bool = False,
                  seed: int = 0):
    """The tiny SAM with seeded random weights.  flash=False (training):
    the differentiable materialized attention; None (serving): K4 on the
    card."""
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.params import init_random_

    sam = SAM(model_type="vit_b", img_size=TINY_IMG, dtype=dtype,
              encoder_kwargs=dict(TINY_ENCODER, flash=flash), device="cpu")
    init_random_(sam, torch.Generator().manual_seed(seed))
    return sam.to(resolve_device(device))


def load_tiny_sam_amg(ckpt: str, points_per_side: int = 24,
                      pred_iou_thresh: float = 0.5,
                      stability_score_thresh: float = 0.7, device="cuda"):
    """The trained tiny SAM (flash=None: K4 on the card) behind the AMG
    (its fused tail K6 on the card)."""
    from sam6d_tpu_torch.config import SegmentorConfig
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.train.checkpoint import params_file, restore_params

    sam = make_tiny_sam(device="cpu", flash=None)
    restore_params(params_file(ckpt, CKPT_FILE), sam)
    sam = sam.to(resolve_device(device))
    cfg = SegmentorConfig(
        points_per_side=points_per_side,
        points_per_batch=64,
        pred_iou_thresh=pred_iou_thresh,
        stability_score_thresh=stability_score_thresh,
        segmentor_width_size=0,  # the frames are small already
        min_mask_region_area=0,
    )
    return SamAutomaticMaskGenerator(sam, cfg)


def render_scene(meshes, rng, S=160, n_min=1, n_max=3,
                 background_mm=900.0):
    """1-3 objects merged into one frame by z-buffer: (rgb uint8 (S, S,
    3), depth in mm (S, S), instance masks (K, S, S))."""
    from sam6d_tpu_torch.provider.training_dataset import (
        _render_view,
        random_rotation,
    )

    f = 4.0 * S
    K = np.array([[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32)
    n = rng.randint(n_min, n_max + 1)
    rgb = np.full((S, S, 3), 90, np.uint8)
    depth = np.full((S, S), background_mm, np.float32)
    inst = []
    for _ in range(n):
        mesh = meshes[rng.randint(len(meshes))]
        R = random_rotation(rng)
        z = rng.uniform(400.0, 600.0)
        lat = z / f
        t = np.array([rng.uniform(-35, 35) * lat,
                      rng.uniform(-35, 35) * lat, z], np.float32)
        orgb, omask, _, odepth = _render_view(mesh, R, t, K, (S, S))
        closer = omask & (odepth < depth)
        if closer.sum() < 48:
            continue
        rgb[closer] = orgb[closer]
        depth[closer] = odepth[closer]
        inst = [m & ~closer for m in inst]  # earlier ones lose occluded px
        inst.append(closer)
    inst = [m for m in inst if m.sum() >= 48]
    if not inst:
        return render_scene(meshes, rng, S, n_min, n_max, background_mm)
    return rgb, depth, np.stack(inst)


def preprocess_numpy(image: np.ndarray, input_size: int = TINY_IMG):
    """SAM's preprocessing on the host, PIL's BILINEAR resize of the
    longest side to input_size (`pil_resize`), pixel normalisation, zero
    pad: (padded (S, S, 3) float32, scale, (h, w))."""
    from sam6d_tpu_torch.utils.resize import pil_resize

    H, W = image.shape[:2]
    scale = input_size / max(H, W)
    eff_h, eff_w = int(round(H * scale)), int(round(W * scale))
    resized = pil_resize(image, eff_h, eff_w, "bilinear").astype(np.float32)
    padded = np.zeros((input_size, input_size, 3), np.float32)
    padded[:eff_h, :eff_w] = (resized - PIXEL_MEAN) / PIXEL_STD
    return padded, scale, (eff_h, eff_w)


def make_training_batch(meshes, rng, B=4, P=8, S=160):
    """Images preprocessed as the AMG will at test time, prompts in input
    coordinates (3 in 4 a pixel of a random instance, else a background
    pixel with an empty target), targets at the logits' resolution
    (TINY_IMG / 4, bilinear and thresholded at 0.5)."""
    from sam6d_tpu_torch.utils.resize import pil_resize

    lowres = TINY_IMG // 4
    imgs = np.zeros((B, TINY_IMG, TINY_IMG, 3), np.float32)
    pts = np.zeros((B, P, 2), np.float32)
    gts = np.zeros((B, P, lowres, lowres), np.float32)
    for b in range(B):
        rgb, _, inst = render_scene(meshes, rng, S=S)
        padded, scale, _ = preprocess_numpy(rgb)
        imgs[b] = padded
        inst_low = np.stack([
            pil_resize(m.astype(np.uint8) * 255, lowres, lowres,
                       "bilinear") > 127
            for m in inst
        ])
        for p in range(P):
            if rng.rand() < 0.75 and len(inst):
                mi = rng.randint(len(inst))
                ys, xs = np.nonzero(inst[mi])
                j = rng.randint(len(ys))
                y, x = ys[j], xs[j]
                gts[b, p] = inst_low[mi]
            else:
                while True:
                    y = rng.randint(S)
                    x = rng.randint(S)
                    if not inst.any(axis=0)[y, x]:
                        break
            pts[b, p] = (x * scale, y * scale)
    return imgs, pts, gts


def sam_loss(sam, imgs, pts, gts):
    """SAM's loss: imgs (B, S, S, 3), pts (B, P, 2), gts (B, P, h, w) ->
    (loss, (mask loss, IoU loss, mean true IoU))."""
    emb = sam.encoder(imgs)  # (B, h, w, 256)
    logits, iou = [], []
    for b in range(emb.shape[0]):
        lg, io = sam.decode_points(emb[b:b + 1], pts[b][:, None, :])
        logits.append(lg)  # (P, 4, 4h, 4w)
        iou.append(io)  # (P, 4)
    logits = torch.stack(logits).float()
    iou = torch.stack(iou).float()
    gt = gts[:, :, None]  # (B, P, 1, H, W)

    p = torch.sigmoid(logits)
    eps = 1e-6
    # Focal (gamma 2, alpha 0.25 on the foreground), mean over the mask.
    pt = p * gt + (1 - p) * (1 - gt)
    alpha = 0.25 * gt + 0.75 * (1 - gt)
    focal = -(alpha * (1 - pt) ** 2 * torch.log(pt + eps)).mean(dim=(-2, -1))
    inter = (p * gt).sum(dim=(-2, -1))
    dice = 1 - (2 * inter + 1) / (p.sum(dim=(-2, -1))
                                  + gt.sum(dim=(-2, -1)) + 1)
    per_mask = 20.0 * focal + dice  # (B, P, 4)
    best = per_mask.argmin(dim=-1)
    mask_loss = per_mask.gather(-1, best[..., None])[..., 0].mean()

    # The IoU head against the actual IoU of each predicted mask.
    hard = logits > 0
    g = gt > 0.5
    ti = (hard & g).sum(dim=(-2, -1))
    tu = (hard | g).sum(dim=(-2, -1))
    true_iou = ti / torch.clamp_min(tu, 1)
    iou_loss = ((iou - true_iou) ** 2).mean()
    return mask_loss + iou_loss, (mask_loss, iou_loss, true_iou.mean())


def cosine_decay(lr: float, steps: int):
    """optax.cosine_decay_schedule(lr, steps) in float32, as optax
    evaluates it."""
    f32 = np.float32

    def schedule(count: int) -> float:
        c = f32(min(count, steps))
        return float(f32(lr) * (f32(0.5) * (f32(1) + np.cos(
            f32(math.pi) * c / f32(steps)))))

    return schedule


def train_step(sam, opt, sched, imgs, pts, gts):
    dev = sam.device
    t = [torch.as_tensor(x, device=dev) for x in (imgs, pts, gts)]
    opt.zero_grad(set_to_none=True)
    loss, aux = sam_loss(sam, *t)
    loss.backward()
    opt.step()
    sched.step()
    return float(loss.detach()), tuple(float(a.detach()) for a in aux)


def amg_recall(amg, meshes, rng, scenes: int = 56):
    """Each GT instance's best IoU among the AMG's masks on fresh scenes."""
    recalls = []
    for _ in range(scenes):
        rgb, _, inst = render_scene(meshes, rng)
        out = amg.generate_masks(rgb)
        for m in inst:
            if len(out["masks"]) == 0:
                recalls.append(0.0)
                continue
            recalls.append(float(max(
                (m & pm).sum() / max((m | pm).sum(), 1)
                for pm in out["masks"])))
    return {"amg_mean_best_iou": float(np.mean(recalls)),
            "amg_recall_at_0.5": float(np.mean(np.array(recalls) > 0.5)),
            "n_instances": len(recalls)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=4500)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompts", type=int, default=8)
    p.add_argument("--objects", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt", default=".ckpt_tiny_sam")
    p.add_argument("--recall_scenes", type=int, default=56)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh
    from sam6d_tpu_torch.tools.train_ism_descriptor import make_optimizer
    from sam6d_tpu_torch.train.checkpoint import params_file, save_params

    rng = np.random.RandomState(11)
    meshes = [make_procedural_mesh(rng) for _ in range(args.objects)]
    sam = make_tiny_sam(device=args.device)
    n_params = sum(p.numel() for p in sam.parameters())
    print(f"tiny SAM: {n_params / 1e6:.2f} M params", flush=True)
    opt, sched = make_optimizer(sam.parameters(), args.lr,
                                cosine_decay(args.lr, args.steps))
    t0 = time.time()
    for it in range(args.steps):
        imgs, pts, gts = make_training_batch(meshes, rng, B=args.batch,
                                             P=args.prompts)
        loss, (ml, il, tiou) = train_step(sam, opt, sched, imgs, pts, gts)
        if (it + 1) % 50 == 0:
            print(f"step {it + 1}/{args.steps} loss {loss:.3f} mask {ml:.3f} "
                  f"iou {il:.3f} true_iou {tiou:.3f} | "
                  f"{(it + 1) / (time.time() - t0):.2f} steps/s", flush=True)
    path = save_params(params_file(args.ckpt, CKPT_FILE), sam)
    print(f"saved {path}", flush=True)
    rec = amg_recall(load_tiny_sam_amg(path, device=args.device), meshes, rng,
                     args.recall_scenes)
    rec.update(steps=args.steps, wall_s=time.time() - t0)
    with open(os.path.join(os.path.dirname(path), "tiny_sam_recall.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
