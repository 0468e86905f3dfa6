"""PEM training: `train_step` at the configuration's batch, bfloat16
compute with float32 parameters and Adam state, on a ring of rendered
batches held on the card.

Set-up builds the train state (`create_train_state` with weights drawn
on the card from the config's seed) and drives it through its first
three steps, each on another batch with the pose noise drawn from the
seed; the reference later follows those three (`train_judge`).  The same
state then trains for --seconds (with --trace 1: the traffic's
`trace_steps` under torch.profiler), the noise now from the program's
generator; each step reads its metrics back, as `train_step` does.
"""

from __future__ import annotations

import time

from portbench.harness import configs, guard, train_judge, train_traffic
from portbench.harness.precision import tf32
from portbench.harness.record import Record


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Record:
    import torch

    import portbench.reference.config as rconfig
    from sam6d_tpu_torch import config as pconfig
    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.train.state import create_train_state, train_step

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cc, tr = cell.config, cell.traffic
    cfg = configs.build(pconfig.PEMConfig, cc["pem"])
    rcfg = configs.build(rconfig.PEMConfig, cc["pem"])
    tcfg = configs.build(pconfig.TrainConfig, cc["train"])
    B = tcfg.batch_size
    batches = train_traffic.batches(cfg, tcfg, tr, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    noises = [train_traffic.pose_noise(B, g, dev) for _ in range(3)]

    with torch.device("meta"):
        shapes = train_judge.PEM(rcfg, device="meta")
    sd = train_judge.draw_state_dict(shapes, cc["weights_seed"], dev)
    state = create_train_state(cfg, tcfg.optim, device=dev,
                               compute_dtype=configs.dtype(cc["compute_dtype"]),
                               state_dict=sd)
    names = [n for n, _ in state.model.named_parameters()]
    prog = {"loss": []}
    b1 = tcfg.optim.betas[0]
    for k in range(3):
        m = train_step(state, batches[k], noise=noises[k])
        prog["loss"].append(m["loss"])
        if k == 0:
            prog["grad"] = [float(mu.double().norm()) / (1 - b1)
                            for mu in state.optimizer.mu]
            prog["first_step"] = m
    prog["delta"] = [float((p.detach() - sd[n]).double().norm())
                     for n, p in state.model.named_parameters()]
    del sd, shapes
    sync()
    guard.check_no_jax("after set-up")

    kernels = (fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
               scatter_rows.KERNEL)
    launches0 = {k.name: k.launches for k in kernels}
    rec = Record(cell=cell.name, seed=seed, trace=trace)
    limit = tr["trace_steps"] if trace else None
    prof = None
    if trace:
        from portbench.harness.trace import Profile
        prof = Profile().__enter__()
    rec.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    k = 0
    while True:
        try:
            m = train_step(state, batches[k % len(batches)], generator=g)
            ok = bool(m["grads_finite"])
        except Exception as exc:  # a failed step counts
            rec.failures.append(repr(exc))
            ok = False
        rec.steps.append({"samples": B, "ok": ok})
        k += 1
        now = time.perf_counter()
        if (limit is not None and k >= limit) or \
                (limit is None and now - start >= seconds):
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    sync()
    rec.window_s = time.perf_counter() - start
    rec.launches = {k.name: k.launches - launches0[k.name] for k in kernels}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    rec.profile = prof
    if trace:
        rec.extra["calls"] = kernel_calls(cfg, B, len(rec.steps))
    guard.check_no_jax("after the window")
    rec.extra["first_step"] = prog.pop("first_step")
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    a = time.perf_counter()
    with tf32(False):
        ref = train_judge.reference_steps(rcfg, tcfg.optim,
                                          cc["weights_seed"], dev,
                                          batches[:3], noises)
        if ref["names"] != names:
            rec.check_errors.append("the program's parameters are not the "
                                    "reference's, leaf for leaf")
        else:
            rec.numbers = train_judge.judge(prog, ref)
            rec.judged = 3
        if trace:
            rec.flops_per_step = flops_per_step(rcfg, cc, dev, batches[0],
                                                noises[0], B)
    rec.check_s = time.perf_counter() - a
    rec.extra["losses"] = {"program": prog["loss"], "reference": ref["loss"]}
    rec.limits = cell.limits["numbers"]
    return rec


def kernel_calls(cfg, B: int, steps: int) -> dict:
    """The K3 and K7 calls of the traced steps: one K3 (the geometric
    embedding's backward over both sides, 2B clouds) a step, and four K7
    calls (the fine positional encoding's two ball-query scales, on the
    observed and on the template side)."""
    n = cfg.coarse_npoint + 1
    d = cfg.geo_embedding.hidden_dim
    fpm = cfg.fine_point_matching
    N = cfg.fine_npoint
    k7 = [(B, N * s, N, 32) for s in (fpm.pe_nsample1, fpm.pe_nsample2)] * 2
    return {"geo_embed_bwd": [(2 * B, n, d, 2)] * steps,
            "scatter_rows": k7 * steps}


def flops_per_step(rcfg, cc, dev, batch, noise, B: int) -> float:
    """The reference's operations for one training step (forward and
    backward of the loss; FlopCounterMode) at the configuration's batch:
    counted on two rows without recomputation and scaled to B (every
    part of the step is per sample)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device(dev):
        model = train_judge.PEM(rcfg, device=dev)
    model.load_state_dict(train_judge.draw_state_dict(model,
                                                      cc["weights_seed"], dev))
    b = {k: v[:2] for k, v in train_judge.as_inputs(batch).items()}
    nz = (noise[0], noise[1][:2], noise[2][:2])
    thr = rcfg.coarse_point_matching.loss_dis_thres
    with FlopCounterMode(display=False) as fc, torch.enable_grad():
        out = model.train_forward(b["pts"], b["rgb"], b["rgb_choose"],
                                  b["tem_rgb"], b["tem_pts"], b["tem_choose"],
                                  b["gt_r"], b["gt_t"], noise=nz)
        loss, _ = train_judge.pem_loss(out, b["gt_r"], b["gt_t"], thr, thr)
        loss.backward()
    return float(fc.get_total_flops()) * B / 2


def control(cell, seed: int, device: str = "cuda",
            fault: str | None = None) -> dict:
    """The control (or, with fault="half", the half-batch fault) in the
    program's place on the batches a run of this seed checks, judged as
    a run judges the program."""
    import torch

    import portbench.reference.config as rconfig
    from sam6d_tpu_torch import config as pconfig

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    rcfg = configs.build(rconfig.PEMConfig, cc["pem"])
    tcfg = configs.build(pconfig.TrainConfig, cc["train"])
    batches = train_traffic.batches(rcfg, tcfg, dict(tr, ring=3), seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    noises = [train_traffic.pose_noise(tcfg.batch_size, g, dev)
              for _ in range(3)]
    with tf32(fault is None):
        bad = train_judge.reference_steps(
            rcfg, tcfg.optim, cc["weights_seed"], dev, batches, noises,
            control=fault is None, half=fault == "half")
    with tf32(False):
        ref = train_judge.reference_steps(rcfg, tcfg.optim,
                                          cc["weights_seed"], dev, batches,
                                          noises)
    return train_judge.judge(bad, ref)
