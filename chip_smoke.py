#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sam6d_tpu_torch/csrc/` (nvcc, one
process per source, all at once), then:

1. environment: the card's name and power limit, torch and CUDA
   versions, compute capability 9.0, the kernel build;
2. every kernel against its plain PyTorch version on the card at the
   shapes the serving paths give it, with CUDA-event timings (kernel and
   plain version in turns, medians) and, where one PyTorch call computes
   the same function, that call's time as a yardstick (K4/K5 also at
   ragged shapes, through the wrapper and as one bare launch, that
   launch also timed alone in bursts; K1, K2, K3, K6 and K7 also timed
   alone; K1 through the route its plan picks at each shape; K2 at the
   training shape also with the winners that K3 reads, both kernels fed
   the same winners; K7 on uniform, ball-query (also on a dense patch)
   and one-target indices, its bits held to the CPU's); plus the
   tiny-config PEM template bank, a tiny-config ISM frame (float32) and
   bfloat16 SAM-encoder and DINOv2 blocks at the full model's head dims
   on the card against the same computed on the CPU;
3. the PEM serving slice at full width (default_pem_config, bfloat16,
   random weights from a seed): onboarding of 42 views x 5000 points
   (FPS 210k -> 2048), the template bank, three 1-instance requests and
   one 5-instance request (bucket 8), then the same onboarding three
   more times, warm.  The launch counters are zeroed
   just before and read just after; every kernel of the path must have
   run.  One more 1-instance request then runs under torch.profiler;
4. the ISM serving slice at full width (default_ism_config: SAM ViT-H at
   1024^2, the 32 x 32 AMG grid, DINOv2-L at 224^2, bfloat16, random
   weights from a seed): onboarding of one object's 42 template views,
   then three 480 x 640 frames of a synthetic scene, one at the default
   thresholds and two with the IoU, stability and confidence thresholds
   opened.  Counters zeroed before and read after, as in phase 3 (32 K4
   launches a frame, 24 K5 launches a DINOv2 pass); one more frame runs
   under torch.profiler, which also reports K4's and K5's device time;
5. the PEM training slice at full width: the Solver that
   `train_cli --synthetic` builds (default_pem_config, bfloat16 compute,
   float32 parameters and Adam state, batch 28 of synthetic samples),
   2 warm-up and 3 timed steps (CUDA events), the peak memory, the
   metrics of each step; counters zeroed before and read after, K1, K2,
   K3 (the embedding backward) and K7 (the row scatter-add) required.
   One more step runs under torch.profiler, which also reports K7's
   device time;
6. the file demo at full width (`pipeline/demo.py`, as a user runs it:
   SAM ViT-H + DINOv2-L in bfloat16, the PEM's ViT-B in float32, random
   weights from the demo's seeds), in a temporary directory under the
   ignored `build/`: `make_example`, then `demo.main` with the stages
   render, ism and pem on the card, then the pem stage again on the
   scene's own detection (random weights find no object, so the first
   PEM stage onboards only).  Required: 42 templates with non-empty masks
   whose xyz lie on the cube's surface, BOP23 rows in
   detection_ism.json, one pose with |det R - 1| < 1e-2 and a finite t,
   a 480 x 640 vis_pem.png; K4, K5 and K6 launched in the ISM stage, K1
   and K2 in each PEM stage.  The stage times (`StageTimer`) are printed.

Any failure exits non-zero.  The last lines are the nvidia-smi name and
power limit, {"kernels": [...]}, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def log(*args):
    print(*args, flush=True)


def require(ok, what: str):
    """A check that holds under `python -O` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_tc(nbytes: float, tc_flops: float, f32_flops: float = 0.0):
    """bound() for a kernel whose products run on the tensor cores (bf16
    operands, float32 sums: the bf16 peak) beside float32 work on the
    CUDA cores: the largest of the three times."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(tc_flops / PEAK_FLOPS["bfloat16"],
                f32_flops / PEAK_FLOPS["float32"])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fill_rel_pos_(module, generator):
    """init_random_ zeroes SAM's rel-pos tables (the flax default); draw
    them from N(0, 0.1) instead, so that every run of K4 on the card adds
    a bias that moves the logits by a fraction of their spread."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] in ("rel_pos_h", "rel_pos_w"):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.1)
    return module


def rel_err(got, want) -> float:
    """|got - want| / |want| over all elements (Frobenius norms)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).norm() / want.norm())


def time_in_turns(fns: dict, reps: int, warmup: int = 1, burst: int = 1):
    """Median ms of one call of each callable, run in turns a, b, b, a,
    ...; CUDA events around every call, or around `burst` calls in a row
    (then divided): a burst keeps the card fed while the host enqueues
    the next call, so it times the device's work alone."""
    import torch

    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    times = {n: [] for n in names}
    for r in range(reps):
        for n in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(burst):
                fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end) / burst)
    return {n: statistics.median(v) for n, v in times.items()}


def all_kernels():
    from sam6d_tpu_torch.ops import (
        decode_tail,
        flash_rpe,
        fps,
        geo_embed,
        scatter_rows,
    )

    return [fps.KERNEL, geo_embed.KERNEL, flash_rpe.KERNEL_RPE,
            flash_rpe.KERNEL_PLAIN, decode_tail.KERNEL, geo_embed.KERNEL_BWD,
            scatter_rows.KERNEL]


def phase_environment():
    import torch

    from sam6d_tpu_torch.ops import _kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    cc = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    log(f"device 0: {name}, compute capability {cc}, "
        f"{torch.cuda.device_count()} visible")
    require(cc == (9, 0), f"needs compute capability 9.0 (Hopper), got {cc}")
    kernels = all_kernels()
    t0 = time.perf_counter()
    _kernels.build_all(kernels)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for k in kernels:
        k.lib()
        ptxas.update(ptxas_summary(k.build_log))
    for fn, info in ptxas.items():
        log(f"  {fn}: {info}")
    log(f"built {len(kernels)} kernels from "
        f"{len({k.source for k in kernels})} sources in {build_s:.1f} s")
    return smi, name, build_s, ptxas


def entry_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last component of the
    nested name, with integer and bool template arguments spelled out
    (_ZN..20flash_fwd_mma_kernelILi5ELi1ELb1EEEv.. ->
    flash_fwd_mma_kernel<5,1,1>); other template arguments are dropped."""
    import re

    if not mangled.startswith("_ZN"):
        return mangled
    rest, name = mangled[3:], mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group(0))
        name = rest[m.end():m.end() + n]
        rest = rest[m.end() + n:]
    t = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if t:
        name += "<" + ",".join(re.findall(r"L[ib](\d+)E", t.group(1))) + ">"
    return name


def ptxas_summary(build_log: str) -> dict:
    """Registers and spill bytes of each entry function in nvcc's
    `-Xptxas -v` log, by `entry_name`."""
    import re

    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = entry_name(m.group(1))
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def check_fps(dev):
    """K1 at the paths' five shapes, each through the route that `fps_plan`
    picks: indices equal to the plain version's; times through the wrapper
    (`ms`), alone (`kernel_ms`: 20 bare launches on a prepared output
    between two events) and of the plain version."""
    import torch

    from sam6d_tpu_torch.ops import fps

    # Serving: one instance and a bucket of 8, the onboarding cloud.
    # Training: the 28 template clouds of 2 x 5000 points -> 2048 and the
    # 2 x 28 clouds -> 196.
    rows = []
    for B, N, npoint, reps in ((1, 2048, 196, 20), (8, 2048, 196, 20),
                               (1, 210000, 2048, 4), (28, 10000, 2048, 3),
                               (56, 2048, 196, 10)):
        g = torch.Generator(device=dev).manual_seed(N + B)
        pts = torch.rand(B, N, 3, generator=g, device=dev) * 0.2 - 0.1
        plan = fps.fps_plan(B, N)
        got = fps.fps_cuda(pts, npoint)
        bufs = fps.prepare(pts, npoint, plan)
        fps.launch(pts, npoint, plan, *bufs)
        want = fps.fps_plain(pts, npoint)
        torch.cuda.synchronize()
        err = max(int((got - want).abs().max()),
                  int((bufs[0] - want).abs().max()))
        require(err == 0, f"fps {B}x{N}->{npoint} ({plan}): indices differ")
        t = time_in_turns({"kernel": lambda: fps.fps_cuda(pts, npoint),
                           "plain": lambda: fps.fps_plain(pts, npoint)}, reps)
        tb = time_in_turns(
            {"kernel": lambda: fps.launch(pts, npoint, plan, *bufs)},
            max(3, reps // 2), burst=20)
        # Input read once, indices written once; ~10 float32 operations
        # per point and step (3 sub, 3 mul, 2 add, min, compare).
        b_ms, b_by = bound(B * N * 12 + B * npoint * 8,
                           B * (npoint - 1) * N * 10, "float32")
        row = dict(shape=f"({B},{N},3)->{npoint}", route=plan.route,
                   cluster=plan.cluster, threads=plan.threads, per=plan.per,
                   max_abs_err=err, ms=t["kernel"], kernel_ms=tb["kernel"],
                   plain_ms=t["plain"], bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"fps {row}")
    return rows


def check_geo_embed(dev):
    import torch

    from sam6d_tpu_torch.config import GeoEmbeddingConfig
    from sam6d_tpu_torch.models.pem.geo_embedding import (
        GeometricStructureEmbedding,
        geometric_embedding_indices,
    )
    from sam6d_tpu_torch.ops import geo_embed
    from sam6d_tpu_torch.params import init_random_

    # (atol, rtol): float32 differs by summation order only; a bfloat16
    # output may land one bf16 step (2^-8 relative) apart.
    tol = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 8e-3)}
    rows = []
    N, d = 197, 256
    for dtype in (torch.bfloat16, torch.float32):
        mod = GeometricStructureEmbedding(GeoEmbeddingConfig(), dtype)
        init_random_(mod, torch.Generator().manual_seed(0))
        mod.to(dev)
        with torch.no_grad():
            Md = mod._fold(40, 20.0, mod.proj_d).contiguous()
            Ma = mod._fold(28, 12.0, mod.proj_a).contiguous()
        # B = 56: the training step's 2 x 28 clouds (bf16 only).
        for B in (1, 8, 56) if dtype == torch.bfloat16 else (1, 8):
            g = torch.Generator(device=dev).manual_seed(B)
            pts = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
            pts[:, 0] = 100.0  # the bg sentinel
            d_idx, a_idx = geometric_embedding_indices(pts, 0.2, 15.0, 3)
            d_idx = torch.clamp_max(d_idx, 20.0).contiguous()
            a_idx = a_idx.contiguous()
            bias = torch.randn(d, generator=g, device=dev) * 0.1
            args = (d_idx, a_idx, Md, Ma, bias, 20.0, 12.0, dtype)
            got = geo_embed.geo_embed_maxk_cuda(*args).float()
            want = geo_embed.geo_embed_maxk_plain(*args).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            atol, rtol = tol[dtype]
            require(bool(((got - want).abs()
                          <= atol + rtol * want.abs()).all()),
                    f"geo_embed B={B} {dtype}: max abs err {err}")
            fns = {"kernel": lambda: geo_embed.geo_embed_maxk_cuda(*args),
                   "plain": lambda: geo_embed.geo_embed_maxk_plain(*args)}
            extra = {"instance": "tensor cores (mma.sync)"
                     if dtype == torch.bfloat16 else "CUDA cores"}
            if B == 56:
                # The training call: K2 also writes the winners of the
                # max over k for K3 (one byte a pair and channel); the
                # embedding stays the serving call's, bit for bit.
                out_w, win = geo_embed.geo_embed_maxk_cuda(*args,
                                                           winners=True)
                _, win_plain = geo_embed.geo_embed_maxk_plain(*args,
                                                              winners=True)
                serving = geo_embed.geo_embed_maxk_cuda(*args)
                torch.cuda.synchronize()
                require(torch.equal(out_w, serving),
                        "geo_embed: the winners call moved the embedding")
                differ = float((win != win_plain).float().mean())
                require(differ <= 1e-4,
                        f"geo_embed winners: {differ} of the entries differ")
                fns["kernel_winners"] = lambda: geo_embed.geo_embed_maxk_cuda(
                    *args, winners=True)
                extra.update(winners_differ=differ,
                             winners_bytes=win.numel())
                del out_w, win, win_plain, serving
            t = time_in_turns(fns, reps=10)
            # Alone: bare launches into prepared outputs, 20 a burst.
            bufs = geo_embed.prepare_fwd(d_idx, d, dtype, False)
            bare = {"kernel": lambda: geo_embed.launch_fwd(*args[:7], *bufs)}
            bufs_w = None
            if B == 56:
                bufs_w = geo_embed.prepare_fwd(d_idx, d, dtype, True)
                bare["kernel_winners"] = lambda: geo_embed.launch_fwd(
                    *args[:7], *bufs_w)
            tb = time_in_turns(bare, reps=5, burst=20)
            bare["kernel"]()
            torch.cuda.synchronize()
            require(torch.equal(bufs[0].float(), got),
                    f"geo_embed B={B} {dtype}: the bare launch differs")
            extra["kernel_ms"] = tb["kernel"]
            if "kernel_winners" in tb:
                extra["kernel_ms_winners"] = tb["kernel_winners"]
            del bufs, bufs_w, bare
            es = torch.finfo(dtype).bits // 8
            pairs = B * N * N
            nbytes = pairs * (4 + 12 + d * es) + 68 * d * es + d * 4
            flops = pairs * (2 * (40 + 3 * 28) * d + 3 * (40 + 3 * 28))
            b_ms, b_by = bound(nbytes, flops, str(dtype).split(".")[-1])
            if "kernel_winners" in t:
                extra.update(ms_winners=t["kernel_winners"],
                             bound_ms_winners=bound(nbytes + pairs * d, flops,
                                                    "bfloat16")[0])
            rows.append(dict(shape=f"B={B},N={N},d={d},{dtype}",
                             max_abs_err=err, ms=t["kernel"],
                             plain_ms=t["plain"], bound_ms=b_ms,
                             bound_by=b_by, dtype=str(dtype), **extra))
            log(f"geo_embed {rows[-1]}")
    return rows


def tiny_pem_config():
    """The tiny PEMConfig of the JAX tests (tests/test_pem_model.py)."""
    from sam6d_tpu_torch import config as c

    return c.PEMConfig(
        coarse_npoint=16, fine_npoint=64,
        feature_extraction=c.ViTConfig(embed_dim=48, out_dim=32, img_size=32,
                                       patch_size=8),
        geo_embedding=c.GeoEmbeddingConfig(hidden_dim=32),
        coarse_point_matching=c.CoarseMatchingConfig(
            input_dim=32, hidden_dim=32, out_dim=32, nproposal1=64,
            nproposal2=8),
        fine_point_matching=c.FineMatchingConfig(
            input_dim=32, hidden_dim=32, out_dim=32, pe_nsample1=8,
            pe_nsample2=16),
        n_sample_model_point=32,
    )


def check_tiny_bank(dev):
    """Tiny-config template bank (float32) on the card (kernels) against
    the same bank on the CPU (plain versions and the unfused path)."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.params import init_random_

    model = init_random_(PEM(tiny_pem_config(), device="cpu").eval(),
                         torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    po = torch.from_numpy((rng.randn(1, 64, 3) * 0.05).astype(np.float32))
    fo = torch.from_numpy(rng.randn(1, 64, 32).astype(np.float32))
    cpu = model.make_template_bank(po, fo)
    gpu = model.to(dev).make_template_bank(po.to(dev), fo.to(dev))
    require(torch.equal(gpu["fps_idx_o"].cpu(), cpu["fps_idx_o"]),
            "tiny bank: FPS indices differ")
    # Fused kernel + sentinel delta vs the unfused path: 2e-4 off the
    # diagonal, as the two formulations are held to each other on the
    # CPU.  3e-3 elsewhere: row/col 0 (the bg sentinel, distances up to
    # ~500) carry the float32 sin/cos difference of the card's and the
    # CPU's libraries, and the diagonal's distance is the square root of
    # a cancellation residual (|x|^2 - 2 x.x + |x|^2 ~ 1e-8 rather than
    # 0), which differs between the two devices' matmuls.
    geo = (gpu["geo_o"].cpu() - cpu["geo_o"]).abs()
    off_diag = ~torch.eye(geo.shape[1] - 1, dtype=torch.bool)
    checks = (("geo_o off-diagonal", geo[:, 1:, 1:][:, off_diag], 2e-4),
              ("geo_o", geo, 3e-3))
    checks += tuple((k, (gpu[k].cpu() - cpu[k]).abs(), 1e-4)
                    for k in ("pe_o", "fine_f2", "dist_field"))
    for k, err, atol in checks:
        log(f"  tiny bank {k}: max abs err {float(err.max()):.3g} "
            f"(tolerance {atol})")
        require(float(err.max()) <= atol,
                f"tiny bank {k}: {err.max()} > {atol}")
    log("tiny-config bank on the card matches the CPU bank")


def phase_slice(dev):
    import numpy as np
    import torch

    from sam6d_tpu_torch.config import default_pem_config
    from sam6d_tpu_torch.ops import fps, geo_embed
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner

    cfg = default_pem_config()
    S, Np = cfg.feature_extraction.img_size, cfg.n_sample_template_point
    T, N = cfg.n_template_view, cfg.n_sample_observed_point
    M = cfg.n_sample_model_point
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    runner = PEMRunner(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    log(f"full-width PEM (bf16) with random weights: "
        f"{time.perf_counter() - t0:.1f} s")

    def obj(n, *lead):  # points of a ~10 cm object
        return (rng.randn(*lead, n, 3) * 0.04).astype(np.float32)

    tem = dict(tem_rgb=rng.rand(T, S, S, 3).astype(np.float32),
               tem_pts=obj(Np, T),
               tem_choose=rng.randint(0, S * S, (T, Np)).astype(np.int64))

    def request(n):
        return {"pts": obj(N, n) + np.float32(0.5),
                "rgb": rng.rand(n, S, S, 3).astype(np.float32),
                "rgb_choose": rng.randint(0, S * S, (n, N)).astype(np.int64),
                "model_pts": obj(M, n),
                "score": np.ones(n, np.float32)}

    requests = [request(1), request(1), request(1), request(5)]
    kernels = [fps.KERNEL, geo_embed.KERNEL]
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    runner.onboard_arrays(**tem)
    ev[1].record()
    ev[1].synchronize()
    onboard_ms = ev[0].elapsed_time(ev[1])
    onboard_launches = {k.name: k.launches for k in kernels}
    outs, req_ms, req_launches = [], [], []
    for inp in requests:
        before = {k.name: k.launches for k in kernels}
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        outs.append(runner.infer(inp))
        e.record()
        e.synchronize()
        req_ms.append(s.elapsed_time(e))
        req_launches.append({k.name: k.launches - before[k.name]
                             for k in kernels})
    launches = {k.name: k.launches for k in kernels}
    # Onboarding again, warm (the first call above also pays for first
    # uses of the libraries): the same arrays, the same bank.
    warm_ms = []
    for _ in range(3):
        ev[0].record()
        runner.onboard_arrays(**tem)
        ev[1].record()
        ev[1].synchronize()
        warm_ms.append(ev[0].elapsed_time(ev[1]))

    for k in kernels:
        require(launches[k.name] > 0, f"{k.name} never ran on the main path")
    for inp, out in zip(requests, outs):
        n = len(inp["pts"])
        require(out["pred_R"].shape == (n, 3, 3)
                and out["pred_t"].shape == (n, 3), "output shapes")
        for v in out.values():
            require(np.isfinite(v).all(), "non-finite output")
        det = np.linalg.det(out["pred_R"].astype(np.float64))
        require(np.all(np.abs(det - 1.0) < 1e-2), f"det(R) = {det}")
        require(np.all((out["pose_score"] >= 0) & (out["pose_score"] <= 1)),
                "pose score outside [0, 1]")
    log(f"onboarding (42 views x {Np} points, FPS {T * Np} -> "
        f"{cfg.fine_npoint}, bank): {onboard_ms:.1f} ms, launches "
        f"{onboard_launches}; warm: "
        f"{', '.join(f'{t:.1f}' for t in warm_ms)} ms")
    for inp, ms, lc in zip(requests, req_ms, req_launches):
        n = len(inp["pts"])
        log(f"request of {n} instance(s) (bucket {runner.bucket_for(n)}): "
            f"{ms:.2f} ms, launches {lc}")
    log(f"main-path launches {launches}; outputs finite, |det R - 1| < 1e-2")
    return runner, request, dict(
        onboard_ms=onboard_ms, onboard_warm_ms=warm_ms,
        onboard_launches=onboard_launches,
        request_ms=req_ms, request_launches=req_launches, launches=launches)


def check_attention(dev):
    """K4 at the SAM encoder's windowed (400, 196, 80) and global
    (16, 4096, 80) shapes and K5 at the DINOv2-L shapes (128 and 4096
    batch-heads of 257 x 64), bfloat16, plus ragged shapes checked
    without timing: K4 on a 7 x 9 grid at d = 80 and on 14 x 14 at
    d = 64, K5 at N = 300.  Each shape is checked through the wrapper and
    through one bare launch into a prepared output.  Times: the wrapper
    (`ms`, events around each call, as in earlier runs), the kernel alone
    (`kernel_ms`, a burst of bare launches on prepared inputs), the plain
    version, and as the yardstick one F.scaled_dot_product_attention call
    on the same inputs, per call and in a burst (for K4 with the dense
    (BH, N, N) rel-pos bias as attn_mask, built beforehand and not
    timed); for K4 also both without the bias, in bursts, which says what
    the bias costs each."""
    import torch
    import torch.nn.functional as F

    from sam6d_tpu_torch.ops import flash_rpe as fr

    # bf16 output: both round the output (within half a step each), so
    # they may land two bf16 steps apart: rtol 1.6e-2.  The rounding of
    # the probabilities (2^-9 relative each) moves an output by a small
    # part of its typical size: atol is 5% of the outputs' standard
    # deviation, so a kernel wrong by one typical output value fails.
    # Unit-scale q and k spread the logits (standard deviation 1 before
    # the bias), so the outputs are not near-uniform averages of v.
    rtol = 1.6e-2
    rows = {"rpe": [], "plain": []}
    cases = (("rpe", 400, 14, 14, 80, 10), ("rpe", 16, 64, 64, 80, 5),
             ("plain", 128, 1, 257, 64, 10), ("plain", 4096, 1, 257, 64, 5),
             ("rpe", 8, 7, 9, 80, 0), ("rpe", 64, 14, 14, 64, 0),
             ("plain", 64, 1, 300, 64, 0))
    for kind, BH, h, w, d, reps in cases:
        N = h * w
        g = torch.Generator(device=dev).manual_seed(BH + N)
        q, k, v = (torch.randn(BH, N, d, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        out = torch.empty_like(q)
        # SDPA takes (batch, heads, L, E): the batch-heads as heads.
        q4, k4, v4 = (t[None] for t in (q, k, v))
        if kind == "rpe":
            rh = (torch.randn(2 * h - 1, d, generator=g, device=dev)
                  * 0.1).bfloat16()
            rw = (torch.randn(2 * w - 1, d, generator=g, device=dev)
                  * 0.1).bfloat16()
            kern = lambda: fr.flash_rpe_attention_cuda(q, k, v, rh, rw,
                                                       (h, w))
            bare = lambda: fr.launch(fr.KERNEL_RPE, q, k, v, rh, rw, (h, w),
                                     out)
            plain = lambda: fr.rpe_attention_plain(q, k, v, rh, rw, (h, w))
            qrh, qrw = fr.rel_pos_tables(q, rh, rw, (h, w))
            mask = (qrh[..., :, None] + qrw[..., None, :]).reshape(
                1, BH, N, N).bfloat16()
            del qrh, qrw
            lib = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask)
            # What the bias costs: the same inputs without it, through the
            # K5 instance and through SDPA (its flash route, no mask).
            no_bias = {
                "kernel": lambda: fr.launch(fr.KERNEL_PLAIN, q, k, v, None,
                                            None, (0, 0), out),
                "library": lambda: F.scaled_dot_product_attention(q4, k4,
                                                                  v4)}
            # q k^T and P v, the per-token tables (h + w dot products a
            # query: QRh[n, Y] for Y < h, QRw[n, X] for X < w), the bias add.
            flops = 4 * BH * N * N * d + 2 * BH * N * d * (h + w) \
                + 2 * BH * N * N
            nbytes = 4 * BH * N * d * 2 + (2 * h + 2 * w - 2) * d * 2
            shape = f"({BH},{N},{d}) bf16, grid {h}x{w}"
        else:
            no_bias = {}
            kern = lambda: fr.flash_attention_cuda(q, k, v)
            bare = lambda: fr.launch(fr.KERNEL_PLAIN, q, k, v, None, None,
                                     (0, 0), out)
            plain = lambda: fr.attention_plain(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)
            flops = 4 * BH * N * N * d
            nbytes = 4 * BH * N * d * 2
            shape = f"({BH},{N},{d}) bf16"
        want = plain().float()
        out_std = float(want.std())
        atol = 0.05 * out_std
        errs = {}
        for route, fn in (("wrapper", kern), ("kernel", bare)):
            got = fn().float()
            torch.cuda.synchronize()
            errs[route] = float((got - want).abs().max())
            require(bool(((got - want).abs() <= atol + rtol * want.abs())
                         .all()),
                    f"flash {kind} {shape} ({route}): max abs err "
                    f"{errs[route]} (atol {atol}, rtol {rtol})")
            del got
        del want
        row = dict(shape=shape, max_abs_err=max(errs.values()),
                   max_abs_err_by_route=errs, out_std=out_std, atol=atol,
                   rtol=rtol)
        if reps:
            per_call = {"kernel": kern, "plain": plain, "library": lib}
            bursts = {"kernel": bare, "library": lib,
                      **{f"{n}_no_bias": f for n, f in no_bias.items()}}
            t = time_in_turns(per_call, reps)
            tb = time_in_turns(bursts, reps, burst=20)
            if no_bias:
                row["no_bias_burst_ms"] = {n: tb[f"{n}_no_bias"]
                                           for n in no_bias}
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            row.update(ms=t["kernel"], kernel_ms=tb["kernel"],
                       plain_ms=t["plain"], library_ms=t["library"],
                       library_burst_ms=tb["library"], bound_ms=b_ms,
                       bound_by=b_by)
        else:
            row.update(ms=None, bound_ms=None)
        rows[kind].append(row)
        log(f"flash_{kind} {row}")
        del q, k, v, out, q4, k4, v4
        if kind == "rpe":
            del mask
    return rows["rpe"], rows["plain"]


def check_decode_tail(dev):
    """K6 at P = 64 and at the AMG's full shape, keys (1024, 4096, 256)
    bf16.  The plain version materializes every stage (several GB in one
    call at P = 1024), so at P = 1024 it runs as 16 calls of 64 prompts,
    each prompt's statistics being its own.  Times: the wrapper (`ms`,
    with its checks and the hi / lo split of W1 and W2), the kernel alone
    (`kernel_ms`: a burst of bare launches on prepared operands) and the
    plain version.  No PyTorch call computes these statistics."""
    import torch

    from sam6d_tpu_torch.ops import decode_tail as dt

    def inputs(P, seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def r(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=dev) * s

        return dict(keys=r(P, 4096, 256, s=0.5).bfloat16(),
                    hyper=r(P, 3, 32, s=0.5), w1=r(256, 256, s=0.05),
                    b1=r(256, s=0.05), ln_scale=1.0 + r(256, s=0.1),
                    ln_bias=r(256, s=0.1), w2=r(64, 128, s=0.1),
                    b2=r(128, s=0.05))

    kw = dict(mask_threshold=0.0, stability_offset=1.0)
    rows = []
    for P, reps in ((64, 5), (1024, 5)):
        inp = inputs(P, P)
        kern = lambda: dt.decode_tail_stats_cuda(**inp, **kw)

        def plain(chunk=64):
            return torch.cat([dt.decode_tail_stats_plain(**dict(
                inp, keys=inp["keys"][i:i + chunk],
                hyper=inp["hyper"][i:i + chunk]), **kw)
                for i in range(0, P, chunk)])

        got, want = kern(), plain()
        torch.cuda.synchronize()
        diff = (got - want).abs()
        # Counts 8 and boxes 4 px, as the JAX package holds its TPU
        # kernel to its reference: float32 summation order flips pixels
        # whose logit lies within rounding of a threshold.
        for rows_, atol in (((0, 1, 6), 8.0), ((2, 3, 4, 5), 4.0)):
            e = float(diff[:, list(rows_)].max())
            require(e <= atol, f"decode_tail P={P} rows {rows_}: {e} > {atol}")
        err = float(diff.max())
        bufs = dt.prepare(inp["keys"], inp["w1"], inp["w2"])
        vec = [inp[k] for k in ("keys", "hyper", "b1", "ln_scale", "ln_bias",
                                "b2")]
        bare = lambda: dt.launch(*vec, *bufs, 0.0, 1.0, 1e-6)
        bare()
        torch.cuda.synchronize()
        require(torch.equal(bufs[-1], got),
                f"decode_tail P={P}: the bare launch differs from the wrapper")
        del got, want, diff
        t = time_in_turns({"kernel": kern, "plain": plain}, reps)
        tb = time_in_turns({"kernel": bare}, reps, burst=5)
        # Per token: stage 1 (256 x 256) as two bf16 products (the keys
        # are bf16, W1 split into hi and lo), stage 2 (4 x 64 x 128) as
        # three, on the tensor cores; on the CUDA cores the contraction
        # (4 x 12 x 32 multiply-adds) and ~10 operations for each
        # LayerNorm / GELU value (256 + 512).  The float32 bound of
        # earlier runs counts every product once at the CUDA cores' peak.
        tokens = P * 4096
        tc_flops = tokens * 2 * (2 * 256 * 256 + 3 * 4 * 64 * 128)
        f32_flops = tokens * (2 * 4 * 12 * 32 + 10 * (256 + 512))
        flops = tokens * (2 * (256 * 256 + 4 * 64 * 128 + 4 * 12 * 32)
                          + 10 * (256 + 512))
        nbytes = tokens * 256 * 2 + P * (96 + 96) * 4 + (256 * 256 + 64
                                                         * 128 + 896) * 4
        b_ms, b_by = bound_tc(nbytes, tc_flops, f32_flops)
        f32_ms, _ = bound(nbytes, flops, "float32")
        rows.append(dict(shape=f"P={P}, keys ({P},4096,256) bf16",
                         max_abs_err=err, ms=t["kernel"],
                         kernel_ms=tb["kernel"],
                         plain_ms=t["plain"], plain_calls=P // 64,
                         bound_ms=b_ms, bound_by=b_by,
                         bound_ms_float32_cuda_cores=f32_ms))
        log(f"decode_tail {rows[-1]}")
    return rows


def tiny_ism(device):
    """The tiny ISM of the CPU tests (vit_b layout at img 64, DINOv2 at
    28^2), float32, random weights from a seed, thresholds opened, the
    fused AMG tail on any device."""
    import torch

    from sam6d_tpu_torch import config as c
    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.params import init_random_

    seg = c.SegmentorConfig(points_per_side=4, points_per_batch=8,
                            pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
                            box_nms_thresh=0.95, segmentor_width_size=0,
                            fused_tail=True)
    desc = c.DescriptorConfig(image_size=28, patch_size=14, embed_dim=32,
                              depth=2, num_heads=2)
    cfg = c.ISMConfig(segmentor=seg, descriptor=desc, confidence_thresh=-1.0)
    sam = init_random_(SAM("vit_b", 64, encoder_kwargs=dict(
        embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
        window_size=2), device="cpu"), torch.Generator().manual_seed(0))
    fill_rel_pos_(sam, torch.Generator().manual_seed(2))
    dm = init_random_(DescriptorModel(desc), torch.Generator().manual_seed(1))
    return ISMDetector(cfg, SamAutomaticMaskGenerator(sam.to(device), seg),
                       dm, device=device)


def check_tiny_ism(dev):
    """One tiny-config ISM frame on the card (K4, K5, K6) against the same
    frame on the CPU (their plain versions), fused tail on both."""
    import numpy as np

    rng = np.random.RandomState(0)
    tem = dict(template_images=rng.rand(1, 3, 28, 28, 3).astype(np.float32),
               template_masks=rng.rand(1, 3, 28, 28) > 0.3,
               template_poses=np.broadcast_to(np.eye(4, dtype=np.float32),
                                              (3, 4, 4)).copy(),
               pointcloud=(rng.randn(1, 64, 3) * 0.05).astype(np.float32))
    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    depth = np.full((64, 64), 1.5, np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    out = []
    for device in ("cpu", dev):
        det = tiny_ism(device)
        det.onboard_templates(**tem)
        out.append(det.detect(image, depth, K))
    cpu, gpu = out
    require(len(cpu) > 0 and len(gpu) == len(cpu),
            f"tiny ISM: {len(gpu)} detections on the card, {len(cpu)} on "
            f"the CPU")
    oc, og = np.argsort(-cpu.scores), np.argsort(-gpu.scores)
    agree = float((gpu.masks[og] == cpu.masks[oc]).mean())
    box_err = float(np.abs(gpu.boxes[og] - cpu.boxes[oc]).max())
    score_err = float(np.abs(gpu.scores[og] - cpu.scores[oc]).max())
    # float32 on both: masks agree on > 99.9% of pixels, boxes within 3 px,
    # scores within 1e-4 (summation order only), the same object ids.
    require(agree > 0.999 and box_err <= 3.0 and score_err <= 1e-4
            and np.array_equal(gpu.object_ids[og], cpu.object_ids[oc]),
            f"tiny ISM: mask agreement {agree}, box err {box_err}, "
            f"score err {score_err}")
    log(f"tiny-config ISM frame on the card matches the CPU: {len(gpu)} "
        f"detections, mask agreement {agree:.6f}, box err {box_err}, "
        f"score err {score_err:.3g}")


def check_tiny_bf16(dev):
    """The bfloat16 kernel instances that the full-width ISM launches,
    held to the CPU inside their modules: a 2-block SAM encoder with head
    dim 80 (K4 on mma.sync; windows of 3 pad its 8 x 8 grid to 9 x 9, one
    global block; rel-pos tables N(0, 0.1)) and a 2-block DINOv2 ViT with
    head dim 64 (K5), on the card against the same modules on the CPU
    (plain versions).  Modules, not a whole frame: in bfloat16 the two
    devices' roundings flip the AMG's near-threshold pixels, which says
    nothing about the kernels.  The CPU encoder also runs with its tables
    zeroed: the card must sit far closer to the CPU than that (a quarter
    of the bias's effect), so a kernel that drops or misplaces the bias
    fails."""
    import copy

    import torch

    from sam6d_tpu_torch.models.ism.dinov2 import DinoViT
    from sam6d_tpu_torch.models.ism.sam.encoder import ImageEncoderViT
    from sam6d_tpu_torch.ops import flash_rpe
    from sam6d_tpu_torch.params import init_random_

    bf16 = torch.bfloat16
    enc = ImageEncoderViT(img_size=128, embed_dim=160, depth=2, num_heads=2,
                          out_chans=64, window_size=3,
                          global_attn_indexes=(1,), dtype=bf16)
    init_random_(enc, torch.Generator().manual_seed(2))
    fill_rel_pos_(enc, torch.Generator().manual_seed(3))
    no_bias = copy.deepcopy(enc)
    with torch.no_grad():
        for name, p in no_bias.named_parameters():
            if "rel_pos" in name:
                p.zero_()
    vit = init_random_(DinoViT(patch_size=14, embed_dim=128, depth=2,
                               num_heads=2, img_size=56, dtype=bf16),
                       torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    x_enc = torch.randn(2, 128, 128, 3, generator=g)
    x_vit = torch.randn(4, 56, 56, 3, generator=g)
    launches = [flash_rpe.KERNEL_RPE.launches, flash_rpe.KERNEL_PLAIN.launches]
    with torch.no_grad():
        cpu_enc, cpu_nb = enc(x_enc), no_bias(x_enc)
        cpu_cls, cpu_patch = vit(x_vit)
        gpu_enc = enc.to(dev)(x_enc.to(dev))
        gpu_cls, gpu_patch = vit.to(dev)(x_vit.to(dev))
    torch.cuda.synchronize()
    require(flash_rpe.KERNEL_RPE.launches - launches[0] == 2
            and flash_rpe.KERNEL_PLAIN.launches - launches[1] == 2,
            "tiny bf16 modules did not launch K4 and K5 once per block")
    errs = dict(encoder=rel_err(gpu_enc, cpu_enc),
                bias_effect=rel_err(cpu_nb, cpu_enc),
                dino_cls=rel_err(gpu_cls, cpu_cls),
                dino_patch=rel_err(gpu_patch, cpu_patch))
    log(f"tiny bf16 modules, card against CPU (relative Frobenius): {errs}")
    # bf16 rounds every product and sum of the 2 blocks: on the CPU these
    # modules in bf16 sit 0.7-0.8% from their float32 selves.  Two bf16
    # devices that round apart may differ by up to sqrt(2) times that;
    # 3% allowed.
    for k in ("encoder", "dino_cls", "dino_patch"):
        require(errs[k] <= 3e-2, f"tiny bf16 {k}: relative error {errs[k]}")
    require(errs["encoder"] <= 0.25 * errs["bias_effect"],
            f"tiny bf16 encoder: card-CPU error {errs['encoder']} against a "
            f"bias effect of {errs['bias_effect']}")
    return errs


def check_geo_embed_bwd(dev):
    """K3 against its plain version, both fed the winners that K2 writes
    for the same inputs: at the training shape (56, 197, 197), d = 256,
    bfloat16, and at a tiny float32 shape with constructed exact ties
    across k (all three k equal: every channel a three-way tie).  Also:
    two launches on the same inputs give the same bits (the cross-block
    sum runs in a fixed order).  Times: the wrapper (`ms`), the kernel
    alone (`kernel_ms`: a burst of bare launches on prepared outputs), the
    plain version.  No PyTorch call computes these gradients."""
    import torch

    from sam6d_tpu_torch.config import GeoEmbeddingConfig
    from sam6d_tpu_torch.models.pem.geo_embedding import (
        GeometricStructureEmbedding,
        geometric_embedding_indices,
    )
    from sam6d_tpu_torch.ops import geo_embed
    from sam6d_tpu_torch.params import init_random_

    # Relative (Frobenius) per output.  bf16 at the training shape: the
    # same bf16 operands, float32 sums over 2.2M pairs taken in another
    # order: 1e-3.  float32 with all k tied: the kernel's split products
    # (each operand hi + lo to 2^-17) and the order of the sums: 1e-5.
    rows = []
    cases = ((torch.bfloat16, 56, 197, 256, False, 1e-3, 5),
             (torch.float32, 2, 33, 32, True, 1e-5, 10))
    for dtype, B, N, d, ties, tol, reps in cases:
        mod = GeometricStructureEmbedding(GeoEmbeddingConfig(hidden_dim=d),
                                          dtype)
        init_random_(mod, torch.Generator().manual_seed(0))
        mod.to(dev)
        with torch.no_grad():
            Md = mod._fold(40, 20.0, mod.proj_d).contiguous()
            Ma = mod._fold(28, 12.0, mod.proj_a).contiguous()
        g = torch.Generator(device=dev).manual_seed(B)
        pts = torch.rand(B, N, 3, generator=g, device=dev) * 2 - 1
        pts[:, 0] = 100.0  # the bg sentinel
        d_idx, a_idx = geometric_embedding_indices(pts, 0.2, 15.0, 3)
        d_idx = torch.clamp_max(d_idx, 20.0).contiguous()
        a_idx = a_idx.contiguous()
        if ties:
            a_idx = a_idx[..., :1].expand_as(a_idx).contiguous()
        cot = torch.randn(B, N, N, d, generator=g, device=dev).to(dtype)
        _, win = geo_embed.geo_embed_maxk_cuda(
            d_idx, a_idx, Md, Ma, torch.zeros(d, device=dev), 20.0, 12.0,
            dtype, winners=True)
        args = (d_idx, a_idx, win, cot, 20.0, 12.0)
        got = geo_embed.geo_embed_maxk_bwd_cuda(*args)
        again = geo_embed.geo_embed_maxk_bwd_cuda(*args)
        want = geo_embed.geo_embed_maxk_bwd_plain(*args, 40)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"geo_embed_bwd {dtype}: two launches differ")
        errs = {n: rel_err(a, b) for n, a, b in
                zip(("dMd", "dMa", "dbias"), got, want)}
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(max(errs.values()) <= tol,
                f"geo_embed_bwd {dtype} ({B},{N},{N}): relative errors "
                f"{errs} > {tol}")
        bufs = geo_embed.prepare_bwd(cot)
        bare = lambda: geo_embed.launch_bwd(*args, *bufs)
        bare()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(bufs[1:], got)),
                f"geo_embed_bwd {dtype}: the bare launch differs")
        del got, again, want
        t = time_in_turns({
            "kernel": lambda: geo_embed.geo_embed_maxk_bwd_cuda(*args),
            "plain": lambda: geo_embed.geo_embed_maxk_bwd_plain(*args, 40),
        }, reps)
        tb = time_in_turns({"kernel": bare}, reps, burst=10)
        # Per pair and channel 40 + 84 multiply-adds (dMd, dMa), on the
        # tensor cores (bf16 operands; float32 operands as four split
        # products); bytes: g, the winners and the index fields read once,
        # three outputs written.  The float32 bound of earlier runs
        # counted the e_k rebuild too (40 + 84 + 84) at the CUDA cores'
        # peak.
        es = torch.finfo(dtype).bits // 8
        pairs = B * N * N
        nbytes = pairs * (d * es + d + 16) + 69 * d * 4
        splits = 4 if dtype == torch.float32 else 1
        b_ms, b_by = bound_tc(nbytes, pairs * d * 2 * (40 + 84) * splits)
        f32_ms, _ = bound(pairs * (d * es + 16) + 28 * d * es + 69 * d * 4,
                          pairs * d * 2 * (40 + 84 + 84), "float32")
        rows.append(dict(shape=f"({B},{N},{N}),d={d},{dtype}"
                               + (", exact ties" if ties else ""),
                         max_abs_err=err, rel_errs=errs, tolerance=tol,
                         deterministic=True, ms=t["kernel"],
                         kernel_ms=tb["kernel"], plain_ms=t["plain"],
                         bound_ms=b_ms, bound_by=b_by,
                         bound_ms_float32_cuda_cores=f32_ms))
        log(f"geo_embed_bwd {rows[-1]}")
        del cot, args, win, bufs
    return rows


def load_helper(name: str):
    """A module of tests/helpers/, loaded by its path (that directory is no
    package)."""
    import importlib.util

    path = ROOT / "tests" / "helpers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_scatter_rows(dev):
    """K7 at the fine-stage positional encoding's shapes, (28, 2048 * S) rows
    of 32 bf16 channels into (28, 2048, 32) float32, on six kinds of
    indices: uniform at S = 64 and 32 (1% negative, dropped); the encoding's
    own ball-query indices at (r = 0.1, S = 32) and (r = 0.2, S = 64), built
    by the port's pairwise_distance + ball_query_from_d2 on 28
    radius-normalised clouds of 2048 points; the same at S = 64 on those
    clouds shrunk to a patch inside the radius (every point a neighbour of
    every other: the encoding's most skewed indices, 64 targets of 2048
    rows); every row to one target.  Required: two launches give the same
    bits (`spread_between_launches` 0); the result equals
    scatter_rows_plain on CPU copies bit for bit; offsets and perm equal
    inverse_index_plain's.  Times: the wrapper (`ms`), alone (`kernel_ms`:
    20 bare launches between two events, /20), the plain version on the
    card, `index_add_` of the same rows (float32 source and flat indices,
    built beforehand, not timed); the device time of each of K7's kernels
    and the kernel launches a call (`kernels_ms`, `launches_a_call`,
    torch.profiler).  Bounds: the function's bytes, and this design's own
    traffic (`design_floor_ms`)."""
    import torch

    from sam6d_tpu_torch.ops import scatter_rows as sr

    bq = load_helper("ball_query_clouds")
    B, N, C = 28, 2048, 32
    pts = torch.from_numpy(bq.synthetic_clouds(B, N)).to(dev)
    rows = []
    for kind, S, reps in (("uniform", 64, 10), ("uniform", 32, 10),
                          ("ball_query", 32, 10), ("ball_query", 64, 10),
                          ("dense_patch", 64, 10), ("one_target", 64, 4)):
        Q = N * S
        g = torch.Generator(device=dev).manual_seed(S)
        if kind == "uniform":
            idx = torch.randint(0, N, (B, Q), generator=g, device=dev)
            idx[torch.rand(B, Q, generator=g, device=dev) < 0.01] = -1
        elif kind == "ball_query":
            idx = bq.ball_query_rows(pts, 0.1 if S == 32 else 0.2, S)
        elif kind == "dense_patch":  # within 0.18 of each other, r = 0.2
            idx = bq.ball_query_rows(pts * 0.09, 0.2, S)
        else:
            idx = torch.full((B, Q), N // 3, dtype=torch.long, device=dev)
        idx = idx.contiguous()
        dy = torch.randn(B, Q, C, generator=g, device=dev).bfloat16()
        h = bq.hits(idx, N).float().flatten()
        name = f"{kind} S={S}"
        got = sr.scatter_rows_cuda(idx, dy, N)
        again = sr.scatter_rows_cuda(idx, dy, N)
        plan = sr.scatter_plan(B, Q, N, C, 2, dy.data_ptr() % 16)
        bufs = sr.prepare(idx, N, C, plan)
        bare = lambda: sr.launch(idx, dy, N, plan, *bufs)  # noqa: E731
        bare()
        offsets, perm = sr.inverse_index_cuda(idx, N)
        torch.cuda.synchronize()
        spread = max(float((got - again).abs().max()),
                     float((bufs[0] - got).abs().max()))
        require(spread == 0.0 and torch.equal(got, again)
                and torch.equal(bufs[0], got),
                f"scatter_rows {name}: two launches differ by {spread}")
        idx_c, dy_c = idx.cpu(), dy.cpu()
        want = sr.scatter_rows_plain(idx_c, dy_c, N)
        err = float((got.cpu() - want).abs().max())
        require(torch.equal(got.cpu(), want),
                f"scatter_rows {name}: not the CPU's bits (max abs {err})")
        w_off, w_perm = sr.inverse_index_plain(idx_c, N)
        require(torch.equal(offsets.cpu(), w_off)
                and torch.equal(perm.cpu(), w_perm),
                f"scatter_rows {name}: offsets / perm differ from the plain")
        n_kept = int(w_off[:, -1].sum())
        del got, again, want, offsets, perm, w_off, w_perm, idx_c, dy_c
        offs = torch.arange(B, device=dev)[:, None] * N
        flat = torch.where(idx >= 0, idx + offs, B * N).reshape(-1)
        dyf = dy.reshape(-1, C).float()
        t = time_in_turns({
            "kernel": lambda: sr.scatter_rows_cuda(idx, dy, N),
            "plain": lambda: sr.scatter_rows_plain(idx, dy, N),
            "library": lambda: torch.zeros(B * N + 1, C, device=dev)
            .index_add_(0, flat, dyf),
        }, reps)
        tb = time_in_turns({"kernel": bare}, reps, burst=20)
        kernels_ms, launches_a_call = k7_kernel_ms(bare)
        # The function: idx and dy read once, out written once.  This
        # design: idx read twice, perm written and read (kept rows), dy of
        # the kept rows, out, and the tile counts written, read and
        # rewritten by the scan, read by the placement, offsets twice.
        nbytes = B * Q * (C * 2 + 8) + B * N * C * 4
        b_ms, b_by = bound(nbytes, B * Q * C, "float32")
        design = (2 * B * Q * 8 + n_kept * (8 + C * 2) + B * N * C * 4
                  + 4 * B * plan.tiles * N * 4 + 2 * B * (N + 1) * 4)
        rows.append(dict(
            shape=f"({B},{Q},{C}) bf16 -> ({B},{N},{C}) f32, {name}",
            max_abs_err=err, spread_between_launches=spread,
            hits_max=float(h.max()), hits_p99=float(torch.quantile(h, 0.99)),
            hits_mean=float(h.mean()), kept_rows=n_kept,
            ms=t["kernel"], kernel_ms=tb["kernel"], plain_ms=t["plain"],
            library_ms=t["library"], bound_ms=b_ms, bound_by=b_by,
            design_floor_ms=bound(design, 0, "float32")[0],
            kernels_ms=kernels_ms, launches_a_call=launches_a_call))
        log(f"scatter_rows {rows[-1]}")
        del idx, dy, flat, dyf, bufs
    return rows


def check_tiny_train_step(dev):
    """One tiny-config training forward and backward (float32, random
    weights from a seed, two synthetic samples, fixed pose noise) on the
    card (K1, K2 and K3 through the fused embedding, K7 under the
    positional encoding) against the same on the CPU (plain versions, the
    unfused embedding): the loss, every gradient leaf and the BatchNorm
    statistics."""
    import numpy as np
    import torch

    from sam6d_tpu_torch import config as c
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.provider.training_dataset import (
        SyntheticPoseDataset,
        collate,
    )
    from sam6d_tpu_torch.train.loss import pem_loss
    from sam6d_tpu_torch.train.state import _to_device

    tcfg = c.TrainConfig(batch_size=2, img_size=32, n_sample_observed_point=64,
                         n_sample_template_point=48)
    ds = SyntheticPoseDataset(tcfg, n_samples=2)
    batch = collate([ds[0], ds[1]])
    rng = np.random.RandomState(0)
    n_rot, n_trans = (torch.from_numpy(rng.randn(2, 3).astype(np.float32))
                      for _ in range(2))
    kernels = [fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
               scatter_rows.KERNEL]
    res = []
    for device in ("cpu", dev):
        model = init_random_(PEM(tiny_pem_config(), device="cpu"),
                             torch.Generator().manual_seed(0)).to(device)
        b = _to_device(batch, device)
        before = [k.launches for k in kernels]
        out = model.train_forward(
            b["pts"], b["rgb"], b["rgb_choose"], b["tem_rgb"], b["tem_pts"],
            b["tem_choose"], b["gt_r"], b["gt_t"],
            noise=(5.0, n_rot.to(device), n_trans.to(device)))
        loss, _ = pem_loss(out, b["gt_r"], b["gt_t"])
        loss.backward()
        res.append(dict(
            loss=float(loss.detach()),
            grads={n: p.grad.cpu() for n, p in model.named_parameters()},
            bufs={n: v.cpu() for n, v in model.named_buffers()},
            launches=[k.launches - n for k, n in zip(kernels, before)]))
    cpu, gpu = res
    require(all(n > 0 for n in gpu["launches"]),
            f"tiny train step on the card launched {gpu['launches']} of "
            f"{[k.name for k in kernels]}")
    # The card runs the fused embedding (clamped Chebyshev plus the
    # sentinel delta, 2e-4 from the unfused path the CPU takes), and the
    # pairwise-distance diagonal is the square root of a cancellation
    # residual that the two devices' matmuls leave differently (~1e-3 on
    # the diagonal's embedding, as in check_tiny_bank): loss 1e-4
    # relative, each gradient leaf 5e-3 relative plus 1e-6 absolute for
    # the leaves that are zero in exact arithmetic, BatchNorm statistics
    # 1e-4.
    loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    grad_errs = {n: float((gpu["grads"][n] - w).norm() / w.norm().clamp_min(
        1e-30)) for n, w in cpu["grads"].items()}
    bad = [n for n, w in cpu["grads"].items()
           if not float((gpu["grads"][n] - w).norm())
           <= 5e-3 * float(w.norm()) + 1e-6]
    buf_err = max(float((gpu["bufs"][n] - v).abs().max())
                  for n, v in cpu["bufs"].items())
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:3]
    log(f"tiny train step, card against CPU: loss {gpu['loss']:.6f} / "
        f"{cpu['loss']:.6f} (rel {loss_err:.3g}), worst gradient leaves "
        f"{worst}, BatchNorm statistics max abs err {buf_err:.3g}, "
        f"launches {dict(zip([k.name for k in kernels], gpu['launches']))}")
    require(loss_err <= 1e-4, f"tiny train step: loss rel err {loss_err}")
    require(not bad, f"tiny train step: gradient leaves off: {bad}")
    require(buf_err <= 1e-4, f"tiny train step: BatchNorm stats {buf_err}")
    return dict(loss_rel_err=loss_err, worst_grad_rel_err=worst,
                bn_max_abs_err=buf_err)



def write_gt_detection(scene_dir: str, out_path: str,
                       far_mm: float = 1200.0):
    """A detection_ism.json holding the example scene's own object
    (`pipeline/make_example.py`): its pixels are those nearer than the
    scene's far plane, its score is 1."""
    import numpy as np

    from sam6d_tpu_torch.utils.detections import Detections, save_json_bop23
    from sam6d_tpu_torch.utils.png import read_png

    mask = read_png(str(Path(scene_dir) / "depth.png")) < far_mm
    ys, xs = np.nonzero(mask)
    dets = Detections(
        masks=mask[None],
        boxes=np.array([[xs.min(), ys.min(), xs.max(), ys.max()]],
                       np.float32),
        scores=np.ones(1, np.float32), object_ids=np.zeros(1, np.int64))
    save_json_bop23(out_path, dets.to_bop23(scene_id=0, image_id=0))


def synthetic_scene(rng, H=480, W=640):
    """A few flat-coloured shapes on a textured background, their depth
    (0.6-0.8 m on a 1.0 m plane) and LINEMOD-like intrinsics."""
    import numpy as np

    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    bg = (0.5 + 0.25 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 13.0)[..., None]
          + 0.1 * rng.rand(H, W, 3))
    img = bg * np.array([0.6, 0.7, 0.8], np.float32)
    depth = np.ones((H, W), np.float32)
    for _ in range(5):
        color = rng.rand(3)
        cy, cx = rng.randint(80, H - 80), rng.randint(80, W - 80)
        ry, rx = rng.randint(30, 80), rng.randint(30, 80)
        if rng.rand() < 0.5:
            inside = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[inside] = color
        depth[inside] = 0.6 + 0.2 * rng.rand()
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8), depth, K


def phase_ism(dev):
    import dataclasses

    import numpy as np
    import torch

    from sam6d_tpu_torch.config import default_ism_config
    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.utils.timer import StageTimer

    cfg = default_ism_config()
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    sam = SAM(cfg.segmentor.model_type, dtype=dtype, device="cpu")
    init_random_(sam, torch.Generator().manual_seed(0))
    fill_rel_pos_(sam, torch.Generator().manual_seed(2))
    sam = cast_dense_weights(sam.to(dev).eval())
    desc = DescriptorModel(cfg.descriptor, dtype=dtype)
    init_random_(desc, torch.Generator().manual_seed(1))
    desc = cast_dense_weights(desc.to(dev).eval())
    log(f"full-width SAM {cfg.segmentor.model_type} and DINOv2-L (bf16) with "
        f"random weights: {time.perf_counter() - t0:.1f} s")
    det = ISMDetector(cfg, SamAutomaticMaskGenerator(sam, cfg.segmentor),
                      desc, device=dev)
    # Frames 1 and 2 open the IoU, stability and confidence thresholds;
    # frame 2 also the box NMS, since random weights give near-duplicate
    # masks that the NMS would fold into one and the descriptor batch
    # should be a real bucket.
    dets_by_frame = [det]
    for nms in (cfg.segmentor.box_nms_thresh, 1.0):
        seg = dataclasses.replace(cfg.segmentor, pred_iou_thresh=-1e9,
                                  stability_score_thresh=-1e9,
                                  box_nms_thresh=nms)
        dets_by_frame.append(ISMDetector(
            dataclasses.replace(cfg, segmentor=seg, confidence_thresh=-1.0),
            SamAutomaticMaskGenerator(sam, seg), desc, device=dev))
    require(det.segmentor.fused, "the fused AMG tail is not chosen on CUDA")

    rng = np.random.RandomState(0)
    S, T = cfg.descriptor.image_size, 42
    yy, xx = np.mgrid[:S, :S]
    tem_masks = np.stack([((yy - S / 2) ** 2 + (xx - S / 2) ** 2
                           < (S * (0.25 + 0.2 * rng.rand())) ** 2)
                          for _ in range(T)])[None]
    tem_images = rng.rand(1, T, S, S, 3).astype(np.float32) \
        * tem_masks[..., None]
    poses = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.randn(T, 3, 3))[0]
    pc = (rng.randn(1, cfg.pointcloud_sample_num, 3) * 0.04).astype(
        np.float32)
    frames = [synthetic_scene(rng) for _ in range(3)]
    kernels = all_kernels()[2:5]
    torch.cuda.synchronize()

    for k in kernels:
        k.launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    det.onboard_templates(tem_images, tem_masks, poses, pc)
    ev[1].record()
    ev[1].synchronize()
    onboard_ms = ev[0].elapsed_time(ev[1])
    onboard_launches = {k.name: k.launches for k in kernels}
    results = []
    for i, (image, depth, K) in enumerate(frames):
        d = dets_by_frame[i]
        d.ref_data = det.ref_data
        before = {k.name: k.launches for k in kernels}
        timer = StageTimer(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = d.detect(image, depth, K, timer=timer)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        results.append(dict(
            thresholds=("default", "opened", "opened, NMS off")[i],
            frame_ms=ms,
            stages_ms=timer.report(), counts=dict(d.last_counts),
            launches={k.name: k.launches - before[k.name] for k in kernels},
            detections=len(dets)))
        n = len(dets)
        require(dets.masks.shape == (n, 480, 640), "mask shape")
        if n:
            require(np.isfinite(dets.scores).all()
                    and (dets.scores >= 0).all() and (dets.scores <= 1).all(),
                    f"scores outside [0, 1]: {dets.scores}")
            b = dets.boxes
            require((b[:, 0::2] >= 0).all() and (b[:, 0::2] <= 639).all()
                    and (b[:, 1::2] >= 0).all() and (b[:, 1::2] <= 479).all(),
                    "boxes outside the frame")
        log(f"frame {i} (thresholds {results[-1]['thresholds']}): "
            f"{ms:.1f} ms, counts {results[-1]['counts']}, stages "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        results[-1]["stages_ms"].items())
            + f" ms, launches {results[-1]['launches']}")
    launches = {k.name: k.launches for k in kernels}
    for k in kernels:
        require(launches[k.name] > 0, f"{k.name} never ran on the ISM path")
    # Per frame: 32 SAM blocks (K4) and 24 DINOv2-L blocks a descriptor
    # pass (K5); the frames with opened thresholds have proposals, so a
    # pass.
    for i, r in enumerate(results):
        lc = r["launches"]
        require(lc["flash_rpe_attention"] == 32
                and lc["flash_attention"] % 24 == 0
                and (i == 0 or lc["flash_attention"] > 0),
                f"ISM frame {i} launched K4 / K5 {lc}")
    require(results[1]["detections"] > 0 and results[2]["detections"] > 0,
            "no detection with opened thresholds")
    log(f"ISM onboarding (1 object x {T} views): {onboard_ms:.1f} ms, "
        f"launches {onboard_launches}")
    log(f"ISM main-path launches {launches}")
    frame = frames[1]
    return (lambda: dets_by_frame[1].detect(*frame)), dict(
        onboard_ms=onboard_ms, onboard_launches=onboard_launches,
        frames=results, launches=launches)


def profile_once(fn, what: str, warm: int = 1):
    """torch.profiler over one call of fn after `warm` calls: the
    device-busy share of its wall time and the kernels that take the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (the kernels and copies themselves): a CPU
    # op's self device time repeats the kernels it launched.
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    n_device = sum(r[2] for r in rows)
    top = [dict(name=k[:90], device_ms=us / 1e3, calls=n)
           for k, us, n in rows[:25] if us > 0]
    log(f"profiled {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{n_device} device kernels and copies")
    for r in top[:12]:
        log(f"  {r['device_ms']:8.3f} ms  {r['calls']:5d}x  {r['name']}")
    flash = flash_device_time(rows)
    log(f"  K4 / K5 device time: {flash}")
    # K7's kernels, and PyTorch's kernel behind torch.gather and its
    # backward (not a port of any TPU kernel).
    named = {label: device_time(rows, part) for label, part in (
        ("scatter_rows (K7)", "scatter_rows_"),
        *K7_PARTS,
        ("torch.gather", "_scatter_gather_elementwise_kernel"))}
    log(f"  by name: {named}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_events=n_device, top=top, flash=flash, named=named)


# K7's four kernels, by a part of their names.
K7_PARTS = tuple((f"K7 {k}", f"scatter_rows_{k}_kernel")
                 for k in ("count", "scan", "place", "sum"))


def k7_kernel_ms(fn, calls: int = 5):
    """Device ms of each of K7's kernels a call of fn, and K7's kernel
    launches a call, by torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()]
    return ({label: device_time(rows, part)["device_ms"] / calls
             for label, part in K7_PARTS},
            device_time(rows, "scatter_rows_")["launches"] / calls)


def device_time(rows, part: str):
    """Device ms and launches of the profiler rows (name, device us, calls)
    whose kernel name holds `part`."""
    hit = [(us, n) for key, us, n in rows if part in key]
    return dict(device_ms=sum(us for us, _ in hit) / 1e3,
                launches=sum(n for _, n in hit))


def flash_device_time(rows):
    """Device ms and launches of K4 (the instances with the bias) and K5
    (without) among profiler rows (name, device us, calls): the kernel
    names are `flash_fwd_mma_kernel<DK, MT, BIAS>` (bf16) and
    `flash_fwd_kernel<DV, BIAS>` (float32), demangled or not."""
    out = {"flash_rpe_attention": [0.0, 0], "flash_attention": [0.0, 0]}
    for key, us, n in rows:
        if "flash_fwd" not in key:
            continue
        if "flash_fwd_mma_kernelI" in key or "flash_fwd_kernelI" in key:
            bias = "Lb1E" in key  # mangled: the bool argument
        else:
            bias = key.split(">")[0].rstrip().endswith("true")
        k = "flash_rpe_attention" if bias else "flash_attention"
        out[k][0] += us / 1e3
        out[k][1] += n
    return {k: dict(device_ms=ms, launches=n) for k, (ms, n) in out.items()}


def phase_profile(runner, request):
    """One 1-instance PEM request under torch.profiler, after two warm
    ones."""
    inp = request(1)
    return profile_once(lambda: runner.infer(inp), "1-instance request",
                        warm=2)


def phase_train(dev):
    """The PEM training slice at full width: the Solver that
    `train_cli --synthetic` builds (default_pem_config, bfloat16 compute
    with float32 parameters and optimizer state, batch 28 of
    SyntheticPoseDataset), 2 warm-up and 3 timed steps, each timed with
    CUDA events; counters zeroed before and read after."""
    import torch

    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.provider.training_dataset import collate
    from sam6d_tpu_torch.train import state as ts
    from sam6d_tpu_torch.train import train_cli

    warm, timed = 2, 3
    # The checkpoint (1.2 GB) goes to the ignored build directory, not to
    # chiprun_out.
    log_dir = ROOT / "build" / "train_log"
    args = train_cli.parse_args([
        "--synthetic", "--steps", str(warm + timed), "--epochs", "1",
        "--batch_size", "28", "--log_dir", str(log_dir)])
    t0 = time.perf_counter()
    solver = train_cli.build_solver(args)
    state = solver.state
    log(f"full-width PEM training state (bf16 compute, float32 parameters, "
        f"batch {solver.cfg.batch_size}): {time.perf_counter() - t0:.1f} s")
    kernels = [fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
               scatter_rows.KERNEL]
    steps = []
    inner = solver.step_fn
    last_end = []

    def timed_step(st, batch, generator):
        # Host time from the end of the previous step to the start of this
        # one: the Solver waiting for the prefetcher's next batch.
        t_in = time.perf_counter()
        wait = (t_in - last_end[-1]) * 1e3 if last_end else None
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        m = inner(st, batch, generator)
        e.record()
        e.synchronize()
        steps.append(dict(ms=s.elapsed_time(e), data_wait_ms=wait, **m))
        last_end.append(time.perf_counter())
        log(f"train step {len(steps)}: {steps[-1]['ms']:.1f} ms, loss "
            f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4g}, "
            f"update_skipped {m['update_skipped']:.0f}, waited for data "
            f"{wait if wait is None else round(wait, 2)} ms")
        return m

    solver.step_fn = timed_step
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    solver.solve(1)
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int(not torch.equal(a, p)) for a, p in
                  zip(before, state.model.parameters()))
    del before
    require(len(steps) == warm + timed and state.step == warm + timed,
            f"train: {len(steps)} steps ran")
    for k in kernels:
        require(launches[k.name] > 0, f"{k.name} never ran on the train path")
    for m in steps:
        require(all(math.isfinite(v) for k, v in m.items()
                    if k != "data_wait_ms"),
                f"train: non-finite metric in {m}")
    require(state.optimizer.count > 0 and changed > 0,
            f"train: no update applied ({state.optimizer.count} updates, "
            f"{changed} parameters changed)")
    ms = statistics.median(m["ms"] for m in steps[warm:])
    # K3 reads the winners that K2 saves in the forward: one byte a pair
    # and channel of the 2 x batch clouds of 197 points, d = 256.
    from sam6d_tpu_torch.config import default_pem_config

    n_c = default_pem_config().coarse_npoint + 1  # the bg token and 196
    winners_bytes = 2 * solver.cfg.batch_size * n_c * n_c * 256
    log(f"train slice: {warm} warm-up + {timed} timed steps, median "
        f"{ms:.1f} ms a step ({1e3 * solver.cfg.batch_size / ms:.1f} "
        f"samples/s), peak memory {peak / 2**30:.2f} GiB (the K3 winners: "
        f"{winners_bytes / 2**30:.3f} GiB), "
        f"{state.optimizer.count} updates applied, {changed} parameter "
        f"tensors changed, launches {launches}, wall {wall_s:.1f} s")
    ds = solver.dataloader.dataset
    batch = collate([ds[i] for i in range(solver.cfg.batch_size)])
    profile = profile_once(
        lambda: ts.train_step(state, batch, solver.generator), "train step")
    return dict(steps=steps, warmup=warm, step_ms=ms,
                samples_per_s=1e3 * solver.cfg.batch_size / ms,
                peak_bytes=peak, winners_bytes=winners_bytes,
                updates_applied=state.optimizer.count,
                params_changed=changed, launches=launches, wall_s=wall_s,
                profile=profile)



def phase_demo(dev, smi: str):
    """Phase 6: the file demo, render -> ISM -> PEM through files, at the
    full width of the default configs; see the module docstring."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from sam6d_tpu_torch.config import default_pem_config
    from sam6d_tpu_torch.models.ism.onboarding import load_template_crops
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe, fps, geo_embed
    from sam6d_tpu_torch.pipeline import demo
    from sam6d_tpu_torch.pipeline.make_example import make_example
    from sam6d_tpu_torch.pipeline.pem_data import load_all_templates
    from sam6d_tpu_torch.utils.png import read_png

    pem_kernels = [fps.KERNEL, geo_embed.KERNEL]
    ism_kernels = [flash_rpe.KERNEL_RPE, flash_rpe.KERNEL_PLAIN,
                   decode_tail.KERNEL]
    kernels = pem_kernels + ism_kernels
    by_stage = {}
    runs = {name: getattr(demo, f"run_{name}")
            for name in ("render", "ism", "pem")}

    def counted(name):
        def run(args, timer):
            before = {k.name: k.launches for k in kernels}
            runs[name](args, timer)
            torch.cuda.synchronize()
            key = name if name not in by_stage else f"{name}_gt"
            by_stage[key] = {k.name: k.launches - before[k.name]
                             for k in kernels}
        return run

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        scene, out = Path(tmp) / "scene", Path(tmp) / "out"
        cad = make_example(str(scene))
        args = ["--cad_path", cad, "--rgb_path", str(scene / "rgb.png"),
                "--depth_path", str(scene / "depth.png"),
                "--cam_path", str(scene / "camera.json"),
                "--output_dir", str(out), "--device", str(dev)]
        for name in runs:
            setattr(demo, f"run_{name}", counted(name))
        try:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            stages = demo.main(args + ["--stages", "render,ism,pem"])
            wall_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            ism_rows = json.loads((out / "detection_ism.json").read_text())
            first_pem = json.loads((out / "detection_pem.json").read_text())
            write_gt_detection(str(scene), str(out / "detection_ism.json"))
            t0 = time.perf_counter()
            stages_gt = demo.main(args + ["--stages", "pem"])
            wall_gt_s = time.perf_counter() - t0
        finally:
            for name, fn in runs.items():
                setattr(demo, f"run_{name}", fn)
        launches = {k.name: k.launches for k in kernels}

        tdir = out / "templates"
        # The host's share of the onboarding stages: the template loaders
        # alone (PNG decoding, crops, resizes), on the host's clock.
        host_s = {}
        for name, load in (
                ("pem_load_all_templates",
                 lambda: load_all_templates(str(tdir), default_pem_config())),
                ("ism_load_template_crops",
                 lambda: load_template_crops(str(tdir)))):
            t0 = time.perf_counter()
            load()
            host_s[name] = time.perf_counter() - t0
        surface_err = 0.0
        for i in range(42):
            mask = read_png(str(tdir / f"mask_{i}.png")) == 255
            rgb = read_png(str(tdir / f"rgb_{i}.png"))
            require(mask.any() and rgb.shape == (420, 420, 3),
                    f"template {i}: empty mask or shape {rgb.shape}")
            xyz = np.load(tdir / f"xyz_{i}.npy").astype(np.float32)[mask]
            surface_err = max(surface_err, float(
                np.abs(np.abs(xyz).max(axis=1) - 30.0).max()))
        require(surface_err <= 2.0,
                f"template xyz off the cube's surface by {surface_err} mm")
        keys = {"scene_id", "image_id", "category_id", "bbox", "score",
                "time", "segmentation"}
        require(isinstance(ism_rows, list) and all(
            set(r) == keys and 0.0 <= r["score"] <= 1.0
            and r["segmentation"]["size"] == [480, 640] for r in ism_rows),
            "detection_ism.json is not a list of BOP23 rows of the frame")
        require(isinstance(first_pem, list), "detection_pem.json")
        rows = json.loads((out / "detection_pem.json").read_text())
        require(len(rows) == 1, f"{len(rows)} poses on the scene's object")
        R = np.array(rows[0]["R"], np.float64).reshape(3, 3)
        t = np.array(rows[0]["t"], np.float64)
        det = float(np.linalg.det(R))
        require(abs(det - 1.0) < 1e-2 and np.isfinite(t).all()
                and np.isfinite(R).all(), f"pose: det R {det}, t {t}")
        vis = read_png(str(out / "vis_pem.png"))
        require(vis.shape == (480, 640, 3), f"vis_pem.png {vis.shape}")
        gt = json.loads((scene / "gt_pose.json").read_text())
    for k in ism_kernels:
        require(by_stage["ism"][k.name] > 0,
                f"{k.name} never ran in the demo's ISM stage")
    for stage in ("pem", "pem_gt"):
        for k in pem_kernels:
            require(by_stage[stage][k.name] > 0,
                    f"{k.name} never ran in the demo's {stage} stage")
    log(smi)
    log("demo stage times (ms, StageTimer, render,ism,pem): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items())
        + f"; wall {wall_s:.1f} s")
    log("demo stage times (ms, StageTimer, pem on the scene's object): "
        + ", ".join(f"{k} {v:.1f}" for k, v in stages_gt.items())
        + f"; wall {wall_gt_s:.1f} s")
    log("demo template loaders alone (host clock, s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in host_s.items()))
    log(f"demo: {len(ism_rows)} ISM detections, {len(first_pem)} poses; on "
        f"the scene's object det R {det:.6f}, t {np.round(t, 2).tolist()} "
        f"mm (ground truth {gt['t_mm']}); template xyz within "
        f"{surface_err:.3f} mm of the cube's surface; launches by stage "
        f"{by_stage}")
    return dict(stages_ms=stages, stages_gt_ms=stages_gt, wall_s=wall_s,
                loaders_host_s=host_s,
                wall_gt_s=wall_gt_s, ism_detections=len(ism_rows),
                poses=len(first_pem), pose_gt=dict(R=R.tolist(),
                                                   t_mm=t.tolist()),
                surface_err_mm=surface_err, launches_by_stage=by_stage,
                launches=launches)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import sam6d_tpu_torch  # noqa: F401  (fails outside the repository)
    from sam6d_tpu_torch.ops import (
        decode_tail,
        flash_rpe,
        fps,
        geo_embed,
        scatter_rows,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("== phase 1: environment and build")
    smi, name, build_s, ptxas = phase_environment()
    log("== phase 2: kernels against their plain versions")
    fps_rows = check_fps(dev)
    geo_rows = check_geo_embed(dev)
    rpe_rows, flash_rows = check_attention(dev)
    tail_rows = check_decode_tail(dev)
    bwd_rows = check_geo_embed_bwd(dev)
    scatter_rows_ = check_scatter_rows(dev)
    check_tiny_bank(dev)
    check_tiny_ism(dev)
    tiny_bf16 = check_tiny_bf16(dev)
    tiny_train = check_tiny_train_step(dev)
    log("== phase 3: PEM serving slice at full width")
    runner, request, sl = phase_slice(dev)
    sl["profile"] = phase_profile(runner, request)
    del runner
    torch.cuda.empty_cache()
    log("== phase 4: ISM serving slice at full width")
    frame, ism = phase_ism(dev)
    ism["profile"] = profile_once(frame, "ISM frame (opened thresholds)")
    del frame
    torch.cuda.empty_cache()
    log("== phase 5: PEM training slice at full width")
    train = phase_train(dev)
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 6: the file demo (render -> ISM -> PEM) at full width")
    demo_run = phase_demo(dev, smi)

    def entry(kernel, rows, main_row, launches, library=None):
        main = rows[main_row]
        return {
            "name": kernel.name, "route": "cuda",
            "source": str(kernel.source.relative_to(ROOT)),
            "replaces": kernel.replaces,
            "launches": launches[kernel.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["max_abs_err"] is not None),
            "ms": main["ms"], "kernel_ms": main.get("kernel_ms"),
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            "library": library, "shape": main["shape"], "by_shape": rows,
            "launches_demo": demo_run["launches"].get(kernel.name, 0),
        }

    # Main rows: FPS of one instance (2048 -> 196) and the bf16 embedding
    # of one instance (PEM request); a windowed SAM block (28 of the 32
    # K4 launches of a frame); DINOv2-L at a bucket of 256 proposals; the
    # AMG tail over all 1024 prompts, the plain version there in 16 calls
    # of 64 prompts; the embedding backward at the training shape; the
    # scatter on the training step's own ball-query indices at S = 64 (its
    # device time in the profiled step beside it).  K1 and K2 count the serving path's launches (their
    # slice) and carry the training path's as launches_train.
    report = {"kernels": [
        dict(entry(fps.KERNEL, fps_rows, 0, sl["launches"],
                   "none: no PyTorch call computes farthest point sampling"),
             launches_train=train["launches"][fps.KERNEL.name]),
        dict(entry(geo_embed.KERNEL, geo_rows, 0, sl["launches"],
                   "none: no single PyTorch call computes the Chebyshev "
                   "embedding with its max over k"),
             launches_train=train["launches"][geo_embed.KERNEL.name]),
        entry(flash_rpe.KERNEL_RPE, rpe_rows, 0, ism["launches"],
              "F.scaled_dot_product_attention with the dense (BH, N, N) "
              "rel-pos bias as attn_mask, built beforehand, not timed"),
        entry(flash_rpe.KERNEL_PLAIN, flash_rows, 1, ism["launches"],
              "F.scaled_dot_product_attention"),
        dict(entry(decode_tail.KERNEL, tail_rows, 1, ism["launches"],
                   "none: no PyTorch call computes the tail statistics"),
             plain_note="plain version in 16 calls of 64 prompts (one "
                        "call materializes several GB at P=1024)"),
        entry(geo_embed.KERNEL_BWD, bwd_rows, 0, train["launches"],
              "none: no single PyTorch call computes these gradients"),
        dict(entry(scatter_rows.KERNEL, scatter_rows_, 3, train["launches"],
                   "Tensor.index_add_ of float32 rows at flat indices, both "
                   "built beforehand, not timed"),
             device_in_step=train["profile"]["named"]["scatter_rows (K7)"]),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": ptxas, "tiny_bf16": tiny_bf16, "tiny_train": tiny_train,
         "slice": sl, "ism": ism, "train": train, "demo": demo_run,
         **report}, indent=1))
    log(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
