"""PEM serving in a closed loop: `PEMRunner.infer` on frames of one
onboarded object, one frame at a time, each sent when the previous
frame's poses are back on the host.

Set-up: the runner with seeded weights drawn on the card, onboarding of
the object's templates, the frames built from the seed, and two calls of
every bucket the frames use.  The window serves the frames in order,
cycling, for --seconds (with --trace 1: the traffic's `trace_frames`,
once without and once under torch.profiler).  Then the program is freed
and the reference judges the frames `pem_traffic.check_frames` picks
(`pem_judge`).
"""

from __future__ import annotations

import time

from portbench.harness import configs, guard, pem_judge, pem_traffic
from portbench.harness.precision import tf32
from portbench.harness.record import Record


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Record:
    """One run of the cell; `device` is the card, or the CPU in the
    benchmark's own tests (no trace there)."""
    import torch

    import portbench.reference.config as rconfig
    from sam6d_tpu_torch import config as pconfig
    from sam6d_tpu_torch.ops import fps, geo_embed
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    cc, tr = cell.config, cell.traffic
    cfg = configs.build(pconfig.PEMConfig, cc["pem"])
    rcfg = configs.build(rconfig.PEMConfig, cc["pem"])
    traffic = pem_traffic.build(tr, cfg, seed)
    frames = traffic["frames"]

    # The weights, drawn on the card; the reference draws the same later.
    with torch.device("meta"):
        shapes = pem_judge.PEM(rcfg, device="meta")
    sd = pem_judge.draw_state_dict(shapes, cc["weights_seed"], dev)
    runner = PEMRunner(cfg, state_dict=sd, device=dev,
                       dtype=configs.dtype(cc["compute_dtype"]),
                       seed=cc["weights_seed"])
    del sd, shapes
    runner.onboard_arrays(**traffic["templates"])
    buckets = [runner.bucket_for(f["n"]) for f in frames]
    u = pem_traffic.uniforms(buckets, cfg.coarse_point_matching.nproposal1,
                             seed, dev)
    checked = pem_traffic.check_frames(frames, tr["check_frames"],
                                       pem_traffic.among(tr, trace), seed)

    # Warm-up: twice each bucket the frames use (the first call builds
    # the kernels where the checkout has none yet).
    for b in sorted(set(buckets)):
        i = buckets.index(b)
        for _ in range(2):
            runner.infer(frames[i]["inputs"], uniforms=u[i])
    sync()
    guard.check_no_jax("after set-up")

    # The program's stage outputs for the judged frames, taken by hooks
    # at their first serving in the window.
    capture, taken = {"on": None}, {}

    def hook(part):
        def fn(_mod, _inp, out):
            if capture["on"] is not None:
                taken.setdefault(capture["on"], {})[part] = out
        return fn

    hooks = [runner.model.coarse_point_matching.register_forward_hook(
                 hook("coarse")),
             runner.model.fine_point_matching.register_forward_hook(
                 hook("fine"))]
    served, outs = [], {}
    kernels = (fps.KERNEL, geo_embed.KERNEL)
    launches0 = {k.name: k.launches for k in kernels}
    rec = Record(cell=cell.name, seed=seed, trace=trace)
    limit = tr["trace_frames"] if trace else None
    prof = None
    if trace:
        from portbench.harness.trace import Profile, plain_seconds

        def serve(k):
            runner.infer(frames[k % len(frames)]["inputs"],
                         uniforms=u[k % len(frames)])
        rec.extra["plain_s"] = plain_seconds(serve, limit, sync)
        prof = Profile().__enter__()
    rec.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    k = 0
    while True:
        i = k % len(frames)
        capture["on"] = i if (k < len(frames) and i in checked) else None
        a = time.perf_counter()
        try:
            out = runner.infer(frames[i]["inputs"], uniforms=u[i])
        except Exception as exc:  # a failed frame counts, and misses
            rec.failures.append(repr(exc))
            out = None
        b = time.perf_counter()
        served.append({"frame": i, "n": frames[i]["n"], "bucket": buckets[i],
                       "ms": (b - a) * 1e3, "ok": out is not None})
        if capture["on"] is not None and out is not None:
            outs[i] = out
        k += 1
        if (limit is not None and k >= limit) or \
                (limit is None and b - start >= seconds):
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    sync()
    rec.window_s = time.perf_counter() - start
    capture["on"] = None
    for h in hooks:
        h.remove()
    rec.frames = served
    if trace:
        es = 2 if cc["compute_dtype"] == "bfloat16" else 4
        rec.extra["calls"] = {
            "fps": [(f["bucket"], cfg.n_sample_observed_point,
                     cfg.coarse_npoint) for f in served],
            "geo_embed": [(f["bucket"], cfg.coarse_npoint + 1,
                           cfg.geo_embedding.hidden_dim, es)
                          for f in served]}
    rec.launches = {k.name: k.launches - launches0[k.name] for k in kernels}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    rec.profile = prof
    guard.check_no_jax("after the window")

    # The program's answers for the judged frames, then the program goes.
    progs = {}
    for i in checked:
        if i not in outs or "coarse" not in taken.get(i, {}):
            continue
        R0, t0_, catts = taken[i]["coarse"]
        fatts = taken[i]["fine"][3]
        o = outs[i]
        progs[i] = [{"coarse_atten": catts[-1][j].float(),
                     "init_R": R0[j].float(), "init_t": t0_[j].float(),
                     "fine_atten": fatts[-1][j].float(),
                     "pred_R": torch.as_tensor(o["pred_R"][j], device=dev),
                     "pred_t": torch.as_tensor(o["pred_t"][j], device=dev),
                     "score": torch.as_tensor(o["pose_score"][j], device=dev)}
                    for j in range(frames[i]["n"])]
    del runner, taken, outs, hooks
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    a = time.perf_counter()
    with tf32(False):
        model = pem_judge.reference_model(rcfg, cc["weights_seed"], dev)
        bk = pem_judge.bank(model, traffic["templates"], dev)
        per = []
        for i in checked:
            if i not in progs:
                rec.check_errors.append(f"judged frame {i} was not served")
                continue
            for j, prog in enumerate(progs[i]):
                r = pem_judge.row(frames[i]["inputs"], j, dev)
                uj = tuple(x[j:j + 1] for x in u[i])
                per.append(pem_judge.judge_instance(model, bk, r, uj, prog))
        if trace:
            rec.flops_per_instance = flops_per_instance(
                model, bk, frames[checked[0]]["inputs"], u[checked[0]], dev)
    rec.check_s = time.perf_counter() - a
    rec.judged = len(per)
    rec.numbers = pem_judge.worst(per) if per else {}
    rec.limits = cell.limits["numbers"]
    return rec


def flops_per_instance(model, bk, inputs, u, dev) -> float:
    """The reference's floating-point operations for one instance's
    serving forward (observed features, embedding, coarse attention and
    solve, fine attention and solve), by torch's FlopCounterMode: the
    products of every matmul, bmm and linear.  The template side is in
    the bank and not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    r = pem_judge.row(inputs, 0, dev)
    uj = tuple(x[:1] for x in u)
    with FlopCounterMode(display=False) as fc:
        st = pem_judge.coarse_stage(model, bk, r)
        R, t, _ = pem_judge.coarse_solve(model, st, bk, st["atten"], uj)
        pem_judge.fine_stage(model, st, bk, R, t)
    return float(fc.get_total_flops())


def bucket(n: int) -> int:
    """PEMRunner.bucket_for without a mesh or max_bucket: the next power
    of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control in the program's place on the frames a run of this
    seed judges: the reference in bfloat16 with float8 Dense products,
    TF32 geometry and bfloat16 pose solves (`pem_judge.control_instance`),
    judged as a run judges the program.  Returns the worst of each
    number."""
    import torch

    import portbench.reference.config as rconfig

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    rcfg = configs.build(rconfig.PEMConfig, cc["pem"])
    traffic = pem_traffic.build(tr, rcfg, seed)
    frames = traffic["frames"]
    u = pem_traffic.uniforms([bucket(f["n"]) for f in frames],
                             rcfg.coarse_point_matching.nproposal1, seed, dev)
    checked = pem_traffic.check_frames(frames, tr["check_frames"],
                                       pem_traffic.among(tr, False), seed)
    per = []
    with tf32(False):
        cmodel = pem_judge.reference_model(rcfg, cc["weights_seed"], dev,
                                           control=True)
        with tf32(True):
            cbk = pem_judge.bank(cmodel, traffic["templates"], dev)
        model = pem_judge.reference_model(rcfg, cc["weights_seed"], dev)
        bk = pem_judge.bank(model, traffic["templates"], dev)
        for i in checked:
            for j in range(frames[i]["n"]):
                r = pem_judge.row(frames[i]["inputs"], j, dev)
                uj = tuple(x[j:j + 1] for x in u[i])
                prog = pem_judge.control_instance(cmodel, cbk, r, uj)
                per.append(pem_judge.judge_instance(model, bk, r, uj, prog))
    return pem_judge.worst(per)
