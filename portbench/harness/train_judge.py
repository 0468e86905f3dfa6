"""Judging the PEM's training step against the plain reference.

The reference follows the program's first three steps: the same initial
weights (drawn again from the seed), the same three batches and pose
noise, its own float32 forward, loss, backward and Adam
(`reference/optim.py`).  Compared, each as a gap of norms measured
against the reference's norm of that leaf or of the median leaf,
whichever is larger (some gradients are all but zero):

* loss: each step's loss, the largest relative gap of the three;
* grad: the first gradient as the optimizer took it (after clipping),
  the program's worked out from its Adam state after one step
  (exp_avg / (1 - b1)); the worst leaf.  Printed and not held: the
  control reads it only 2.5 times the sound runs (PERF.md);
* update: each leaf's change over the three steps; the worst leaf,
  leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone under
  Adam, as a key's bias under softmax does).

The reference recomputes its heavy blocks in the backward
(`PEM.set_remat`) so that a float32 step of the whole batch fits beside
nothing else on the card; the values are the same.  The control puts it
in the program's place in bfloat16 with float8 Dense products
(`control=True`); the fault `half` computes the loss over the first half
of each batch's rows only.
"""

from __future__ import annotations

import statistics

import torch

from portbench.harness.weights import draw_state_dict
from portbench.reference.layers import use_fp8
from portbench.reference.loss import pem_loss
from portbench.reference.optim import Adam
from portbench.reference.pem.model import PEM

NUMBERS = ("loss", "grad", "update")


def leaf_norms(tensors) -> list[float]:
    return [float(t.double().norm()) for t in tensors]


def as_inputs(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        out[k] = v.long() if v.dtype in (torch.int32, torch.int64) \
            else v.float()
    return out


def reference_steps(rcfg, ocfg, weights_seed: int, device, batches, noises,
                    control: bool = False, half: bool = False) -> dict:
    """Three steps of the reference from the seed's weights: per-step
    losses, the per-leaf norms of the first gradient before and after
    clipping, and of each leaf's change over the three steps."""
    dtype = torch.bfloat16 if control else torch.float32
    with torch.device(device):
        model = PEM(rcfg, dtype=dtype, device=device)
    model.load_state_dict(draw_state_dict(model, weights_seed, device))
    model.set_remat(True)
    if control:
        use_fp8(model)
    params = list(model.parameters())
    p0 = [p.detach().clone() for p in params]
    opt = Adam(params, ocfg)
    thr_c = rcfg.coarse_point_matching.loss_dis_thres
    thr_f = rcfg.fine_point_matching.loss_dis_thres
    losses, first, first_raw = [], None, None
    for batch, noise in zip(batches, noises):
        b = as_inputs(batch)
        if half:
            n = len(b["pts"]) // 2
            b = {k: v[:n] for k, v in b.items()}
            noise = (noise[0], noise[1][:n], noise[2][:n])
        model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model.train_forward(
                b["pts"], b["rgb"], b["rgb_choose"], b["tem_rgb"],
                b["tem_pts"], b["tem_choose"], b["gt_r"], b["gt_t"],
                noise=noise)
            loss, _ = pem_loss(out, b["gt_r"], b["gt_t"], thr_c, thr_f)
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        taken, _ = opt.step(grads)
        if first is None:
            first, first_raw = leaf_norms(taken), leaf_norms(grads)
        losses.append(float(loss.detach()))
        del out, loss, grads, taken
    delta = leaf_norms(p.detach() - q for p, q in zip(params, p0))
    return {"names": [n for n, _ in model.named_parameters()],
            "loss": losses, "grad": first, "grad_raw": first_raw,
            "delta": delta}


def _worst_leaf(mine, ref, keep=None) -> float:
    pairs = [(m, r) for i, (m, r) in enumerate(zip(mine, ref))
             if keep is None or keep[i]]
    med = statistics.median(r for _, r in pairs)
    return max(abs(m - r) / max(r, med) for m, r in pairs)


def judge(prog: dict, ref: dict) -> dict:
    """prog and ref: {"loss": [3], "grad": per leaf, "delta": per leaf},
    leaves in the reference's parameter order."""
    med = statistics.median(ref["grad_raw"])
    keep = [g >= 1e-3 * med for g in ref["grad_raw"]]
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                        ref["loss"])),
        "grad": _worst_leaf(prog["grad"], ref["grad"]),
        "update": _worst_leaf(prog["delta"], ref["delta"], keep),
        "left_out": keep.count(False),
    }
