#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sam6d_tpu_torch/csrc/` (nvcc, one
process per source, all at once), then:

1. environment: the card's name and power limit, torch and CUDA
   versions, compute capability 9.0, the kernel build;
2. every kernel against its plain PyTorch version on the card at the
   shapes the serving, training and accuracy paths give it, with CUDA-event timings (kernel and
   plain version in turns, medians) and, where one PyTorch call computes
   the same function, that call's time as a yardstick (K4/K5 also at
   ragged shapes, through the wrapper and as one bare launch, that
   launch also timed alone in bursts; K1, K2, K3, K6 and K7 also timed
   alone; K1 through the route its plan picks at each shape; K2 at the
   training shape also with the winners that K3 reads, both kernels fed
   the same winners; K7 on uniform, ball-query (also on a dense patch)
   and one-target indices, its bits held to the CPU's; K8 at the two
   pose solves' shapes through the route the wrapper picks and through
   the other where it can, with the share of the coarse problems whose
   R and t equal the plain version's bit for bit; K9 at the AMG decode's
   two call forms and at tiny SAM's 576 rows in float32); plus the
   tiny-config PEM template bank, a tiny-config ISM frame (float32), a
   tiny FastSAM (the "n" scale at 160 px: head outputs and
   generate_masks) and bfloat16 SAM-encoder and DINOv2 blocks at the full
   model's head dims on the card against the same computed on the CPU;
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
   and K2 in each PEM stage.  The stage times (`StageTimer`) are printed;
7. released checkpoints reach the card: for FastSAM-x, MAE ViT-B,
   the PEM base, DINOv2-L and SAM ViT-H, a checkpoint in the released
   file's layout (tests/helpers/reference_checkpoints.py, from a numpy
   seed) is written with torch.save, converted by
   `python -m sam6d_tpu_torch.convert_weights` in a process of its own
   (host-clock time and peak resident memory printed), and loaded into
   its module with strict=True; SAM's decode_prompts runs on the
   converted ViT-H embedding of phase 6's frame with a point, a box and
   a mask prompt (finite (1, 4, 256, 256) logits); then `demo.main` with
   `--segmentor_model fastsam` and the converted FastSAM, DINOv2 and PEM
   weights runs the ism and pem stages on phase 6's scene and templates,
   and the pem stage again on the scene's own detection.  Required:
   FastSAM's masks at the frame's size, boxes inside it, finite; ISM
   scores in [0, 1]; one pose with |det R - 1| < 1e-2; K5 launched in
   the ISM stage, K1 and K2 in each PEM stage.  Stage times, proposal
   counts and launches by stage are printed;
8. PEM training from data at full width, in a temporary directory under
   `build/`: a MegaPose-layout tree (tests/helpers/megapose_tree.py: 28
   keys of 480 x 640 frames with 1-3 instances of 2 procedural objects,
   JPEGs from the numpy writer of tests/helpers/jpeg_writer.py, 16-bit
   depth PNGs, column-major RLE masks, 2 templates an object), then
   `train_cli --data_dir` (MegaPoseDataset -> the Solver's thread
   prefetcher -> train_step, batch 28, bf16 compute, float32 parameters
   and Adam state) for 3 steps, each timed with CUDA events beside the
   host's wait for its batch; one `__getitem__`, a JPEG decode and a
   `color_augment` timed on the host clock; then RenderedPoseDataset
   (uint8 planes) -> ProcessSampleStream (min(8, cores - 1) forked numpy
   workers) -> DevicePrefetcher -> train_step for 24 steps on the same
   state (the waits after the first N steps, which the workers' first
   batches serve, reported apart); the step on one batch on the card
   alone, beside MegaPose loading in a thread and in a forked process,
   in turns; then `save_params` -> `PEMRunner.load_params` (no missed
   entry) -> one onboarding and one request.  Required: the batch
   shapes, finite metrics, an applied update, K1, K2, K3 and K7 in both
   trainings (counters zeroed before, read after), uint8 planes on the
   card, no worker or loader alive after close, a pose with
   |det R - 1| < 1e-2, K1 and K2 in the handoff;
9. BOP evaluation at full width, in the same temporary directory: an
   LM-O-like tree (tests/helpers/bop_tree.py: a 60 mm cube listing
   discrete symmetries and a vase listing a continuous one; 3 test
   frames of 480 x 640, RGB and 16-bit depth PNGs at depth_scale 0.1;
   8 train_pbr JPEG frames with their visible masks), its templates from
   `render_bop_templates` (42 views of 420 px an object); `run_ism_eval`
   (SAM ViT-H + DINOv2-L, bf16, random weights from seeds, phase 4's
   opened thresholds) onboarded from the templates, then from train_pbr;
   `run_bop_eval` (default_pem_config) on a detection json of the GT
   visible masks, both objects in every frame; the `bop_score` CLI in a
   process of its own on the GT poses and on the PEM's csv, and once
   more in this process with each VSD render timed.  Required: rows of
   every frame whose category_id is the tree's and whose RLE decodes to
   480 x 640, K4, K5 and K6 in each ISM sweep (counters zeroed before,
   read after); a pose a detection with |det R - 1| < 1e-2 and a finite
   t, result_bop.csv, K1 and K2 in the PEM sweep; AR exactly 1.0 with
   VSD on the GT poses, a finite AR in [0, 1] on the PEM's;
10. the modules ported last, in the same temporary directory:
   PointNet++'s SSG classification net's first SA layer at its published
   widths (npoint 512, radius 0.2, nsample 32, MLP [64, 64, 128]) on 8
   clouds of 2048 points, then an FP module back to them (MLP [128,
   128]), seeded weights, float32, against the same modules on the CPU
   (K1's counter zeroed before, read after); the native host library
   (`utils/native.py`: its g++ build timed), the demo's render stage (42
   views at 420 px of the example cube) through it and through numpy,
   12 VSD depth renders at 480 x 640 of phase 9's GT poses through each
   in turns (masks within 2e-3 of the pixels, depth 1e-4 where both
   cover), its call counter required; a one-rank NCCL group:
   `PEMRunner` on a 1 x 1 ("dp", "hyp") mesh against the runner without
   one under the same injected uniforms (K1 and K2 required),
   `sync_hosts`, `write_shard_and_merge`, one step of `train_cli.main
   --tp 1` at batch 4 through the distributed code (finite metrics, an
   applied update, K1, K2, K3 and K7 required), the group destroyed; `profiling.trace` around one PEM request (the
   CUDA activity alone, the program's spans on its clock, every kernel
   inside the request's span), and `debug_tap` writing a tensor;
11. the accuracy loop (`sam6d_tpu_torch/tools/`), in the same temporary
   directory, launches counted only inside the driven calls
   (`LaunchTally`): (a) `smoke_train_eval`'s rendered recipe (the small
   PEM, batch 8, SMOKE_STEPS steps), its first batch's gradients held to
   the CPU's; the held-out median rotation error after training at most
   SMOKE_ROT_FRACTION of the untrained one; (b) `train_flagship`
   (default_pem_config, bf16, batch 8, the worker stream) for
   FLAGSHIP_STEPS steps, finite losses and every parameter updated, then
   `e2e_synthetic_ar.run_eval` on its 12-frame tree with the untrained
   and the trained weights (AR in [0, 1]; request and scorer times) and
   the GT poses through the same scorer (AR exactly 1.0); (c) ISM_STEPS
   steps each of `train_ism_descriptor` (use_flash=False) and
   `train_tiny_sam` (flash=False), every parameter the CPU's loss
   reaches with a finite gradient on the card within 1e-3 of the CPU's;
   the trained tiny SAM's AMG on one frame of each object, card against
   CPU (`check_tiny_sam_amg`: the embedding, every candidate's IoU,
   stability and box, the kept set, the masks); then
   `ism_accuracy_eval` (2 held-out objects x 3 frames, a bank of 6)
   with the depth connected-components and the tiny-SAM segmentors over
   the trained weights and (a)'s PEM: selection accuracy, template-view
   error and the ISM -> PEM AR; K4, K5 and K6 required there, all eight
   kernels in the phase.

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
        procrustes,
        scatter_rows,
        two_way,
    )

    return [fps.KERNEL, geo_embed.KERNEL, flash_rpe.KERNEL_RPE,
            flash_rpe.KERNEL_PLAIN, decode_tail.KERNEL, geo_embed.KERNEL_BWD,
            scatter_rows.KERNEL, procrustes.KERNEL, two_way.KERNEL]


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
    # Phase 11's smoke config: the 8 template clouds of 2 x 128 points ->
    # 128 and the 2 x 8 clouds -> 32.
    for B, N, npoint, reps in ((1, 2048, 196, 20), (8, 2048, 196, 20),
                               (1, 210000, 2048, 4), (28, 10000, 2048, 3),
                               (56, 2048, 196, 10), (8, 256, 128, 10),
                               (16, 128, 32, 10)):
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
    from sam6d_tpu_torch.ops import fps, geo_embed, procrustes
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
    kernels = [fps.KERNEL, geo_embed.KERNEL, procrustes.KERNEL]
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
    d = 64, K5 at N = 300, and float32 at phase 11's tiny SAM (4, 256,
    32) and tiny descriptor (64, 65, 32).  Each shape is checked through the wrapper and
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
    rows = {"rpe": [], "plain": []}
    cases = (("rpe", 400, 14, 14, 80, 10), ("rpe", 16, 64, 64, 80, 5),
             ("plain", 128, 1, 257, 64, 10), ("plain", 4096, 1, 257, 64, 5),
             ("rpe", 8, 7, 9, 80, 0), ("rpe", 64, 14, 14, 64, 0),
             ("plain", 64, 1, 300, 64, 0),
             # Phase 11's tiny SAM (a 16 x 16 grid, 4 heads of 32) and
             # tiny descriptor (65 tokens, 4 heads of 32, 16 crops), in
             # their float32.
             ("rpe", 4, 16, 16, 32, 0, torch.float32),
             ("plain", 64, 1, 65, 32, 0, torch.float32))
    for kind, BH, h, w, d, reps, *dtype in cases:
        dtype = dtype[0] if dtype else torch.bfloat16
        dname = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        N = h * w
        g = torch.Generator(device=dev).manual_seed(BH + N)
        q, k, v = (torch.randn(BH, N, d, generator=g, device=dev).to(dtype)
                   for _ in range(3))
        out = torch.empty_like(q)
        # SDPA takes (batch, heads, L, E): the batch-heads as heads.
        q4, k4, v4 = (t[None] for t in (q, k, v))
        if kind == "rpe":
            rh = (torch.randn(2 * h - 1, d, generator=g, device=dev)
                  * 0.1).to(dtype)
            rw = (torch.randn(2 * w - 1, d, generator=g, device=dev)
                  * 0.1).to(dtype)
            kern = lambda: fr.flash_rpe_attention_cuda(q, k, v, rh, rw,
                                                       (h, w))
            bare = lambda: fr.launch(fr.KERNEL_RPE, q, k, v, rh, rw, (h, w),
                                     out)
            plain = lambda: fr.rpe_attention_plain(q, k, v, rh, rw, (h, w))
            qrh, qrw = fr.rel_pos_tables(q, rh, rw, (h, w))
            mask = (qrh[..., :, None] + qrw[..., None, :]).reshape(
                1, BH, N, N).to(dtype)
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
            shape = f"({BH},{N},{d}) {dname}, grid {h}x{w}"
        else:
            no_bias = {}
            kern = lambda: fr.flash_attention_cuda(q, k, v)
            bare = lambda: fr.launch(fr.KERNEL_PLAIN, q, k, v, None, None,
                                     (0, 0), out)
            plain = lambda: fr.attention_plain(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)
            flops = 4 * BH * N * N * d
            nbytes = 4 * BH * N * d * 2
            shape = f"({BH},{N},{d}) {dname}"
        want = plain().float()
        out_std = float(want.std())
        # float32 rounds nothing to a narrower type: both sides differ by
        # the order of float32 sums only.
        rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-4
        atol = (0.05 if dtype == torch.bfloat16 else 1e-4) * out_std
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
    return rows["rpe"], rows["plain"] + check_hiera_attention(dev)


# SAM 2.1 Hiera-L's K5 calls at 1024 px, (BH, Nq, Nk) at head width 72:
# windows of stages 1-4, the global blocks, and the three pooling blocks
# (queries max-pooled 2 x 2 inside each window).
HIERA_K5 = ((2048, 64, 64), (4096, 16, 16), (128, 256, 256), (256, 64, 64),
            (8, 4096, 4096), (4096, 16, 64), (8192, 4, 16), (256, 64, 256))


def check_hiera_attention(dev):
    """K5 at Hiera-L's eight shapes (bfloat16, d = 72, fewer queries than
    keys in the pooling blocks), and one pooled shape in float32 without
    timing, against the plain version at check_attention's tolerances.
    Times as there: the wrapper (`ms`), the kernel alone in a burst
    (`kernel_ms`), the plain version, and F.scaled_dot_product_attention
    per call and in a burst; the bound counts 4 BH Nq Nk d operations and
    es BH d (2 Nq + 2 Nk) bytes."""
    import torch
    import torch.nn.functional as F

    from sam6d_tpu_torch.ops import flash_rpe as fr

    rows = []
    cases = [(BH, nq, nk, torch.bfloat16, 5) for BH, nq, nk in HIERA_K5]
    cases.append((64, 16, 64, torch.float32, 0))
    for BH, nq, nk, dtype, reps in cases:
        d = 72
        g = torch.Generator(device=dev).manual_seed(BH + nq + nk)
        q = torch.randn(BH, nq, d, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(BH, nk, d, generator=g, device=dev).to(dtype)
                for _ in range(2))
        out = torch.empty_like(q)
        q4, k4, v4 = (t[None] for t in (q, k, v))
        kern = lambda: fr.flash_attention_cuda(q, k, v)
        bare = lambda: fr.launch(fr.KERNEL_PLAIN, q, k, v, None, None,
                                 (0, 0), out)
        plain = lambda: fr.attention_plain(q, k, v)
        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)
        want = plain().float()
        out_std = float(want.std())
        rtol = 1.6e-2 if dtype == torch.bfloat16 else 1e-4
        atol = (0.05 if dtype == torch.bfloat16 else 1e-4) * out_std
        dname = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        shape = f"Hiera ({BH},{nq},{nk},{d}) {dname}"
        errs = {}
        for route, fn in (("wrapper", kern), ("kernel", bare)):
            got = fn().float()
            torch.cuda.synchronize()
            errs[route] = float((got - want).abs().max())
            require(bool(((got - want).abs() <= atol + rtol * want.abs())
                         .all()),
                    f"flash {shape} ({route}): max abs err {errs[route]} "
                    f"(atol {atol}, rtol {rtol})")
            del got
        del want
        row = dict(shape=shape, max_abs_err=max(errs.values()),
                   max_abs_err_by_route=errs, out_std=out_std, atol=atol,
                   rtol=rtol)
        if reps:
            t = time_in_turns({"kernel": kern, "plain": plain,
                               "library": lib}, reps)
            tb = time_in_turns({"kernel": bare, "library": lib}, reps,
                               burst=20)
            b_ms, b_by = bound(q.element_size() * BH * d * (2 * nq + 2 * nk),
                               4 * BH * nq * nk * d, "bfloat16")
            row.update(ms=t["kernel"], kernel_ms=tb["kernel"],
                       plain_ms=t["plain"], library_ms=t["library"],
                       library_burst_ms=tb["library"], bound_ms=b_ms,
                       bound_by=b_by)
        else:
            row.update(ms=None, bound_ms=None)
        rows.append(row)
        log(f"flash_hiera {row}")
        del q, k, v, out, q4, k4, v4
    return rows


def check_decode_tail(dev):
    """K6 at P = 64 and at the AMG's full shape, keys (1024, 4096, 256)
    bf16, and at phase 11's tiny SAM, keys (576, 256, 256) float32 (its
    24 x 24 prompt grid on a 16 x 16 token grid); then SAM 2's residual
    form at the full shape (res1 (4096, 256) and res0 (4096, 512) in the
    keys' bf16), which must also differ from the same call without the
    residuals.  The plain version materializes every stage (several GB in one
    call at P = 1024), so at P = 1024 it runs as 16 calls of 64 prompts,
    each prompt's statistics being its own.  Times: the wrapper (`ms`,
    with its checks and the hi / lo split of W1 and W2), the kernel alone
    (`kernel_ms`: a burst of bare launches on prepared operands) and the
    plain version.  No PyTorch call computes these statistics."""
    import torch

    from sam6d_tpu_torch.ops import decode_tail as dt

    def inputs(P, N, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)

        def r(*shape, s=1.0):
            return torch.randn(*shape, generator=g, device=dev) * s

        # SAM 2's residuals at the scale of a token's upscaled features.
        res = dict(res1=r(N, 256, s=0.5).to(dtype),
                   res0=r(N, 512, s=0.5).to(dtype))
        return dict(keys=r(P, N, 256, s=0.5).to(dtype),
                    hyper=r(P, 3, 32, s=0.5), w1=r(256, 256, s=0.05),
                    b1=r(256, s=0.05), ln_scale=1.0 + r(256, s=0.1),
                    ln_bias=r(256, s=0.1), w2=r(64, 128, s=0.1),
                    b2=r(128, s=0.05)), res

    kw = dict(mask_threshold=0.0, stability_offset=1.0)
    rows = []
    for P, N, dtype, reps, with_res in (
            (64, 4096, torch.bfloat16, 5, False),
            (1024, 4096, torch.bfloat16, 5, False),
            (576, 256, torch.float32, 5, False),
            (1024, 4096, torch.bfloat16, 5, True)):
        inp, res = inputs(P, N, dtype, P)
        if not with_res:
            res = {}
        kern = lambda: dt.decode_tail_stats_cuda(**inp, **res, **kw)

        def plain(chunk=64):
            return torch.cat([dt.decode_tail_stats_plain(**dict(
                inp, keys=inp["keys"][i:i + chunk],
                hyper=inp["hyper"][i:i + chunk]), **res, **kw)
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
        bare = lambda: dt.launch(*vec, *bufs, 0.0, 1.0, 1e-6,
                                 res.get("res1"), res.get("res0"))
        bare()
        torch.cuda.synchronize()
        require(torch.equal(bufs[-1], got),
                f"decode_tail P={P}: the bare launch differs from the wrapper")
        if with_res:
            # The residuals are read: the pixel counts move by more than
            # the 8 a rounding may flip.
            moved = float((dt.decode_tail_stats_cuda(**inp, **kw) - got)
                          [:, 6].abs().max())
            require(moved > 8.0, f"decode_tail P={P} with residuals: the "
                                 f"counts moved only {moved}")
        del got, want, diff
        t = time_in_turns({"kernel": kern, "plain": plain}, reps)
        tb = time_in_turns({"kernel": bare}, reps, burst=5)
        # Per token: stage 1 (256 x 256) as two bf16 products (bf16 keys,
        # W1 split into hi and lo; three for float32 keys, split as well),
        # stage 2 (4 x 64 x 128) as three, on the tensor cores; on the CUDA cores the contraction
        # (4 x 12 x 32 multiply-adds) and ~10 operations for each
        # LayerNorm / GELU value (256 + 512).  The float32 bound of
        # earlier runs counts every product once at the CUDA cores' peak.
        tokens = P * N
        splits = 2 if dtype == torch.bfloat16 else 3
        tc_flops = tokens * 2 * (splits * 256 * 256 + 3 * 4 * 64 * 128)
        f32_flops = tokens * (2 * 4 * 12 * 32 + 10 * (256 + 512))
        flops = tokens * (2 * (256 * 256 + 4 * 64 * 128 + 4 * 12 * 32)
                          + 10 * (256 + 512))
        nbytes = (tokens * 256 * inp["keys"].element_size()
                  + P * (96 + 96) * 4 + (256 * 256 + 64 * 128 + 896) * 4)
        if with_res:  # the residuals once, and their 768 adds a token
            nbytes += N * (256 + 512) * inp["keys"].element_size()
            f32_flops += tokens * (256 + 512)
            flops += tokens * (256 + 512)
        b_ms, b_by = bound_tc(nbytes, tc_flops, f32_flops)
        f32_ms, _ = bound(nbytes, flops, "float32")
        dname = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
        rows.append(dict(shape=f"P={P}, keys ({P},{N},256) {dname}"
                         + (", SAM 2's residuals" if with_res else ""),
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


def tiny_fastsam(device):
    """FastSAM at the "n" scale and 160 px, float32, random weights and
    BatchNorm statistics from a seed; conf 0.3 and max_det 24 keep a
    proposal set whose scores lie apart."""
    import torch

    from sam6d_tpu_torch.models.ism.fastsam import FastSAM
    from sam6d_tpu_torch.models.layers import BatchNorm
    from sam6d_tpu_torch.params import init_random_

    fs = FastSAM(img_size=160, conf=0.3, max_det=24, scale="n", device="cpu")
    g = torch.Generator().manual_seed(4)
    init_random_(fs.net, g)
    with torch.no_grad():
        for m in fs.net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                                 generator=g) * 0.1)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g))
    fs.net.to(device)
    return fs


def fastsam_with_probabilities(fs, image):
    """fs.generate_masks(image) and the mask probabilities it composed
    (None when no proposal passed)."""
    from sam6d_tpu_torch.models.ism import fastsam

    probs = []
    compose = fastsam.mask_probabilities
    fastsam.mask_probabilities = lambda *a: probs.append(compose(*a)) or probs[-1]
    try:
        out = fs.generate_masks(image)
    finally:
        fastsam.mask_probabilities = compose
    return out, (probs[0].cpu().numpy() if probs else None)


def check_tiny_fastsam(dev):
    """The tiny FastSAM on the card (cuDNN convolutions, float32, TF32
    off) against the same module on the CPU: the head outputs and
    prototypes within 1e-4 (of order 1; summation order only), and
    generate_masks on a 120 x 160 frame: the same proposals, boxes within
    1e-3 px, masks equal except at pixels whose CPU probability lies
    within 1e-4 of the 0.5 threshold (their count is printed)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(1, 160, 160, 3).astype(np.float32))
    image = (rng.rand(120, 160, 3) * 255).astype(np.uint8)
    heads, results = [], []
    for device in ("cpu", dev):
        fs = tiny_fastsam(device)
        with torch.no_grad():
            outs, proto = fs.net(x.to(device))
        heads.append([proto.cpu()] + [t.cpu() for lv in outs for t in lv])
        results.append(fastsam_with_probabilities(fs, image))
    head_err = max(float((g - c).abs().max()) for c, g in zip(*heads))
    (cpu, probs), (gpu, _) = results
    n = len(cpu["masks"])
    require(n > 3 and gpu["masks"].shape == cpu["masks"].shape
            and len(probs) == n,
            f"tiny FastSAM: {len(gpu['masks'])} proposals on the card, {n} "
            f"on the CPU")
    box_err = float(np.abs(gpu["boxes"] - cpu["boxes"]).max())
    differ = gpu["masks"] != cpu["masks"]
    edge = float(np.abs(probs[differ] - 0.5).max()) if differ.any() else 0.0
    require(head_err <= 1e-4 and box_err <= 1e-3 and edge < 1e-4,
            f"tiny FastSAM: head err {head_err}, box err {box_err}, "
            f"differing pixels {int(differ.sum())} up to {edge} from 0.5")
    log(f"tiny FastSAM (n, 160 px) on the card matches the CPU: head err "
        f"{head_err:.3g}, {n} proposals, box err {box_err:.3g} px, "
        f"{int(differ.sum())} differing mask pixels")
    return dict(head_max_abs_err=head_err, proposals=n,
                box_max_abs_err=box_err, differing_pixels=int(differ.sum()))


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
    # Phase 11's smoke config: 2 x 8 clouds of 33 points, d = 64, float32.
    cases = ((torch.bfloat16, 56, 197, 256, False, 1e-3, 5),
             (torch.float32, 2, 33, 32, True, 1e-5, 10),
             (torch.float32, 16, 33, 64, False, 1e-5, 5))
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


def check_procrustes(dev):
    """K8 at the pose solves' shapes at the bin's largest bucket: the
    coarse (16, 6000) problems of 3 points without weights, the fine 16
    of 2048 with the fine stage's weights (a few zero, the rest in (0, 1)).
    Required: R and t within 1e-5 of the plain version on the card, and
    the bare launch's result equal to the wrapper's.  Reported: the share
    of problems whose R and t equal the plain version's bit for bit, the
    times through the wrapper (`ms`), alone (`kernel_ms`: 20 bare launches
    between two events, /20) and of the plain version; each route where
    it can take the shape (`route_ms`: the thread route takes problems of
    THREAD_N points alone).  Bound: the inputs read and R, t written once;
    about 42 float32 operations a point and 1300 a problem's 3x3 solve."""
    import torch

    from sam6d_tpu_torch.ops import procrustes as pr

    rows = []
    for lead, n, weighted, reps in (((16, 6000), 3, False, 10),
                                    ((16,), 2048, True, 10)):
        g = torch.Generator(device=dev).manual_seed(n)
        src = torch.randn(*lead, n, 3, generator=g, device=dev)
        rot, _ = torch.linalg.qr(torch.randn(*lead, 3, 3, generator=g,
                                             device=dev))
        ref = (src @ rot.transpose(-1, -2) + 0.01 * torch.randn(
            *lead, n, 3, generator=g, device=dev))
        w = None
        if weighted:
            w = torch.rand(*lead, n, generator=g, device=dev)
            w[torch.rand(*lead, n, generator=g, device=dev) < 0.1] = 0.0
        P = math.prod(lead)
        s2, r2 = src.reshape(P, n, 3), ref.reshape(P, n, 3)
        w2 = None if w is None else w.reshape(P, n)
        with torch.no_grad():
            R, t = pr.weighted_procrustes(src, ref, w)
        Rp, tp = pr.weighted_procrustes_plain(src, ref, w)
        route = pr.procrustes_route(n)
        bufs = pr.prepare(s2)
        bare = {r: (lambda r=r: pr.launch(s2, r2, w2, *bufs, 0.0, 1e-5, r))
                for r in pr.ROUTES if r == "block" or n == pr.THREAD_N}
        bare[route]()
        torch.cuda.synchronize()
        err = max(float((R - Rp).abs().max()), float((t - tp).abs().max()))
        require(err <= 1e-5, f"procrustes {lead} x {n}: {err} from the plain")
        require(torch.equal(bufs[0], R.reshape(P, 3, 3))
                and torch.equal(bufs[1], t.reshape(P, 3)),
                f"procrustes {lead} x {n}: the bare launch differs")
        same = ((R == Rp).flatten(-2).all(-1) & (t == tp).all(-1))
        det = torch.linalg.det(R.double())
        tm = time_in_turns({
            "kernel": lambda: pr.weighted_procrustes(src, ref, w),
            "plain": lambda: pr.weighted_procrustes_plain(src, ref, w),
        }, reps)
        tb = time_in_turns(bare, reps, burst=20)
        nbytes = P * n * (24 + (4 if weighted else 0)) + P * 48
        b_ms, b_by = bound(nbytes, P * (42 * n + 1300), "float32")
        rows.append(dict(
            shape=f"{lead} x ({n}, 3){' weighted' if weighted else ''}",
            route=route, max_abs_err=err,
            bitwise_share=float(same.float().mean()),
            max_det_err=float((det - 1).abs().max()),
            ms=tm["kernel"], kernel_ms=tb[route], plain_ms=tm["plain"],
            route_ms=tb, bound_ms=b_ms, bound_by=b_by))
        log(f"procrustes {rows[-1]}")
    return rows


def check_two_way(dev):
    """K9 at the AMG decode's two call forms (64 grid prompts over the
    4096 key rows of SAM ViT-H: the first block's batch-1 float32 image
    side, the second block's bf16 keys of batch 64; bf16 compute) and at
    tiny SAM's 576 rows in float32.  Required: every output within the
    card tests' tolerance of the plain version on the card (relative
    Frobenius error 4e-3 in bf16, 2e-6 in float32) and the bare launch's
    result equal to the wrapper's.  Times: the wrapper (`ms`), the kernel
    alone (`kernel_ms`: bare launches on prepared operands, in bursts),
    the plain version.  Bound: the inputs read and the outputs written
    once; the products (four 256 x 128 a row, one of them once a row in
    the batch-1 form) on the tensor cores, or at the CUDA cores' float32
    peak."""
    import torch

    from sam6d_tpu_torch.ops import two_way as tw

    cases = load_helper("two_way_cases")
    rows = []
    for B, N, T, Bk, dtype in ((64, 4096, 7, 1, torch.bfloat16),
                               (64, 4096, 7, 64, torch.bfloat16),
                               (64, 576, 7, 1, torch.float32)):
        with torch.no_grad():
            _, _, keys, key_pe, k_tok, v_tok, _, _, w = cases.op_case(
                B, N, T, Bk, dtype, device=dev)
            pe = key_pe.reshape(N, 256)
            wt = tw.kernel_weights(w, dtype, keys.device)
            kern = lambda: tw.two_way_keys_cuda(keys, pe, k_tok, v_tok, w,
                                                dtype)
            plain = lambda: tw.two_way_keys_plain(keys, key_pe, k_tok,
                                                  v_tok, w, dtype)
            got, want = kern(), plain()
            outs = tw.prepare(keys, k_tok)
            bare = lambda: tw.launch(keys, pe, k_tok, v_tok, wt, *outs)
            bare()
            torch.cuda.synchronize()
            errs = [float((g.float() - x.float()).norm() / x.float().norm())
                    for g, x in zip(got, want)]
            rel = 4e-3 if dtype == torch.bfloat16 else 2e-6
            require(max(errs) < rel, f"two_way {B}x{N} Bk={Bk}: {errs}")
            require(all(torch.equal(a, b) for a, b in zip(outs, got)),
                    f"two_way {B}x{N} Bk={Bk}: the bare launch differs")
            del got, want
            t = time_in_turns({"kernel": kern, "plain": plain}, 10)
            tb = time_in_turns({"kernel": bare}, 10, burst=10)
        es = 2 if dtype == torch.bfloat16 else 4
        rows_ = B * N
        nbytes = (Bk * N * 256 * keys.element_size() + N * 256 * 4
                  + 2 * B * T * 128 * es + 4 * 128 * 256 * es
                  + rows_ * (256 + 2 * 128) * es)
        macs = rows_ * 3 * 256 * 128 + (N if Bk == 1 else rows_) * 256 * 128
        if dtype == torch.bfloat16:
            b_ms, b_by = bound_tc(nbytes, 2 * macs)
        else:
            b_ms, b_by = bound(nbytes, 2 * macs, "float32")
        rows.append(dict(
            shape=f"B={B}, N={N}, T={T}, keys batch {Bk} {keys.dtype}, "
                  f"{dtype}", rel_err=errs, ms=t["kernel"],
            kernel_ms=tb["kernel"], plain_ms=t["plain"], bound_ms=b_ms,
            bound_by=b_by))
        log(f"two_way {rows[-1]}")
    return rows


def grads_card_vs_cpu(dev, module, loss_fn, what: str, tol: float = 1e-3,
                      atol: float = 1e-6, kernels=()):
    """One loss and backward of `module` (on the CPU, weights kept) on the
    CPU and on a copy on the card: the loss within 1e-4 relative; every
    parameter that the CPU's loss reaches has a finite gradient on the
    card within `tol` relative (Frobenius) of the CPU's, plus `atol`
    absolute for the leaves whose gradient is zero in exact arithmetic
    (an attention's key bias adds one logit to a whole softmax row: both
    devices leave float noise there); those it does not reach have none
    or one within `atol` on the card; the buffers (BatchNorm statistics) after the
    forward within 1e-4; and each of `kernels` launched on the card.
    loss_fn(module, device) -> loss."""
    import copy

    import torch

    res = []
    for device in ("cpu", dev):
        m = copy.deepcopy(module).to(device)
        before = [k.launches for k in kernels]
        loss = loss_fn(m, device)
        loss.backward()
        res.append(dict(
            loss=float(loss.detach()),
            grads={n: (None if p.grad is None else p.grad.float().cpu())
                   for n, p in m.named_parameters()},
            bufs={n: v.float().cpu() for n, v in m.named_buffers()},
            launches=[k.launches - n for k, n in zip(kernels, before)]))
    cpu, gpu = res
    reached = [n for n, g in cpu["grads"].items() if g is not None and g.any()]
    errs, bad = {}, []
    for n in reached:
        g, w = gpu["grads"][n], cpu["grads"][n]
        require(g is not None and bool(torch.isfinite(g).all()),
                f"{what}: {n} has no finite gradient on the card")
        errs[n] = rel_err(g, w)
        if not float((g - w).norm()) <= tol * float(w.norm()) + atol:
            bad.append((n, errs[n], float(w.norm())))
    unreached = sorted(set(cpu["grads"]) - set(reached))
    for n in unreached:
        g = gpu["grads"][n]
        require(g is None or float(g.norm()) <= atol,
                f"{what}: {n} has a gradient on the card only")
    loss_err = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    buf_err = max((float((gpu["bufs"][n] - v).abs().max())
                   for n, v in cpu["bufs"].items()), default=0.0)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    launches = dict(zip([k.name for k in kernels], gpu["launches"]))
    log(f"{what}, card against CPU: loss {gpu['loss']:.6f} / "
        f"{cpu['loss']:.6f} (rel {loss_err:.3g}); {len(reached)} of "
        f"{len(cpu['grads'])} parameters reached, worst relative {worst}; "
        f"buffers max abs err {buf_err:.3g}; launches {launches}")
    require(all(n > 0 for n in gpu["launches"]),
            f"{what} on the card launched {launches}")
    require(loss_err <= 1e-4, f"{what}: loss rel err {loss_err}")
    require(not bad, f"{what}: gradients off (name, relative error, CPU "
                     f"norm): {bad}")
    require(buf_err <= 1e-4, f"{what}: buffers {buf_err}")
    return dict(loss_rel_err=loss_err, worst_grad_rel_err=worst,
                bn_max_abs_err=buf_err, reached=len(reached),
                params=len(cpu["grads"]), unreached=unreached)


def train_grads_card_vs_cpu(dev, make_model, batch, noise, what: str):
    """One training forward and backward of the PEM that `make_model()`
    builds on the CPU, on `batch` with the fixed pose noise `noise` = (std,
    n_rot, n_trans), on the card (K1, K2 and K3 through the fused
    embedding, K7 under the positional encoding) against the same on the
    CPU (plain versions, the unfused embedding): `grads_card_vs_cpu`.

    tolerance: the card runs the fused embedding (clamped Chebyshev plus
    the sentinel delta, 2e-4 from the unfused path the CPU takes), and the
    pairwise-distance diagonal is the square root of a cancellation
    residual that the two devices' matmuls leave differently (~1e-3 on the
    diagonal's embedding, as in check_tiny_bank): each gradient leaf 5e-3
    relative plus 1e-6 absolute for the leaves that are zero in exact
    arithmetic; the loss 1e-4 relative and the BatchNorm statistics 1e-4,
    as for every model."""
    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.train.loss import pem_loss
    from sam6d_tpu_torch.train.state import _to_device

    def loss_fn(model, device):
        b = _to_device(batch, device)
        out = model.train_forward(
            b["pts"], b["rgb"], b["rgb_choose"], b["tem_rgb"], b["tem_pts"],
            b["tem_choose"], b["gt_r"], b["gt_t"],
            noise=(noise[0], noise[1].to(device), noise[2].to(device)))
        cfg = model.cfg
        return pem_loss(out, b["gt_r"], b["gt_t"],
                        cfg.coarse_point_matching.loss_dis_thres,
                        cfg.fine_point_matching.loss_dis_thres)[0]

    return grads_card_vs_cpu(
        dev, make_model(), loss_fn, what, tol=5e-3,
        kernels=[fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
                 scatter_rows.KERNEL])


def check_tiny_train_step(dev):
    """One tiny-config training forward and backward (float32, random
    weights from a seed, two synthetic samples, fixed pose noise) on the
    card against the same on the CPU (`train_grads_card_vs_cpu`)."""
    import numpy as np
    import torch

    from sam6d_tpu_torch import config as c
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.provider.training_dataset import (
        SyntheticPoseDataset,
        collate,
    )

    tcfg = c.TrainConfig(batch_size=2, img_size=32, n_sample_observed_point=64,
                         n_sample_template_point=48)
    ds = SyntheticPoseDataset(tcfg, n_samples=2)
    batch = collate([ds[0], ds[1]])
    rng = np.random.RandomState(0)
    n_rot, n_trans = (torch.from_numpy(rng.randn(2, 3).astype(np.float32))
                      for _ in range(2))
    return train_grads_card_vs_cpu(
        dev, lambda: init_random_(PEM(tiny_pem_config(), device="cpu"),
                                  torch.Generator().manual_seed(0)),
        batch, (5.0, n_rot, n_trans), "tiny train step")


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
    from sam6d_tpu_torch.utils.timer import StageTimer, recording

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
    kernels = all_kernels()[2:5] + all_kernels()[-1:]  # K4, K5, K6, K9
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
        with recording() as rec:
            dets = d.detect(image, depth, K, timer=timer)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows = {name: sum(n for c, n, _, _ in rec.counts if c == name)
                for name in ("sam.key_rows_fused", "sam.key_rows_plain")}
        # K9 serves both blocks of every grid prompt's decode: 64 x 64 rows.
        P = cfg.segmentor.points_per_side ** 2
        require(rows == {"sam.key_rows_fused": 2 * P * 64 * 64,
                         "sam.key_rows_plain": 0},
                f"ISM frame {i} key rows {rows}")
        results.append(dict(
            thresholds=("default", "opened", "opened, NMS off")[i],
            frame_ms=ms,
            stages_ms=timer.report(), counts=dict(d.last_counts),
            key_rows=rows,
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
        # K9: two calls a batch of 64 of the 32 x 32 grid's prompts.
        require(lc["two_way_keys"] == 32,
                f"ISM frame {i} launched K9 {lc['two_way_keys']} times")
    require(results[1]["detections"] > 0 and results[2]["detections"] > 0,
            "no detection with opened thresholds")
    log(f"ISM onboarding (1 object x {T} views): {onboard_ms:.1f} ms, "
        f"launches {onboard_launches}")
    log(f"ISM main-path launches {launches}")
    sam2 = sam2_frame(dev, cfg, desc, det.ref_data, frames[1], kernels)
    frame = frames[1]
    return (lambda: dets_by_frame[1].detect(*frame)), dict(
        onboard_ms=onboard_ms, onboard_launches=onboard_launches,
        frames=results, launches=launches, sam2=sam2)


# Hiera-L's query rows x heads a frame at 1024 px, by block kind (blocks
# 0-1 and 3-7 windowed at 256^2 and 128^2, 9-43 at 64^2 but for the
# global 23, 33, 43, 45-47 at 32^2; the pooling blocks 2, 8, 44).
HIERA_ROWS = {"hiera.attn_rows_window": 1_687_552,
              "hiera.attn_rows_pooled": 114_688,
              "hiera.attn_rows_global": 98_304, "hiera.attn_rows_plain": 0}


def sam2_frame(dev, cfg, desc, ref_data, frame, kernels):
    """One frame of the ISM with SAM 2.1 Hiera-L at full width (bf16,
    random weights, thresholds opened), built as the file demo builds it
    for `--segmentor_model sam2`, on phase 4's templates.  Its launches
    from zero: 48 K5 launches inside `encode` (one a Hiera block), no K4,
    one K6 launch in its residual form over all 1024 prompts, 32 K9
    launches; its counters: Hiera's rows by kind, none plain, 2 x 1024 x
    4096 fused key rows, 1024 x 4096 residual rows."""
    import dataclasses

    import numpy as np
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam2.model import SAM2
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.ops import flash_rpe
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.pipeline.demo import SAM2_MODEL
    from sam6d_tpu_torch.utils.timer import StageTimer, recording

    seg = dataclasses.replace(cfg.segmentor, model_type=SAM2_MODEL,
                              pred_iou_thresh=-1e9,
                              stability_score_thresh=-1e9)
    sam = SAM2(seg.model_type, dtype=torch.bfloat16, device="cpu")
    init_random_(sam, torch.Generator().manual_seed(3))
    sam = cast_dense_weights(sam.to(dev).eval())
    k5, encode, in_encoder = flash_rpe.KERNEL_PLAIN, sam.encode, []

    def counted_encode(*a, **k):
        n = k5.launches
        out = encode(*a, **k)
        in_encoder.append(k5.launches - n)
        return out

    sam.encode = counted_encode
    det = ISMDetector(dataclasses.replace(cfg, segmentor=seg,
                                          confidence_thresh=-1.0),
                      SamAutomaticMaskGenerator(sam, seg), desc, device=dev)
    require(det.segmentor.fused, "SAM 2: the fused AMG tail is not chosen")
    det.ref_data = ref_data
    det.detect(*frame)  # warm
    torch.cuda.synchronize()
    in_encoder.clear()
    before = {k.name: k.launches for k in kernels}
    timer = StageTimer(dev)
    t0 = time.perf_counter()
    with recording() as rec:
        dets = det.detect(*frame, timer=timer)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lc = {k.name: k.launches - before[k.name] for k in kernels}
    names = list(HIERA_ROWS) + ["sam.key_rows_fused", "sam.key_rows_plain",
                                "sam2.tail_residual_rows"]
    rows = {n: sum(c for name, c, _, _ in rec.counts if name == n)
            for n in names}
    P = seg.points_per_side ** 2
    want = dict(HIERA_ROWS, **{"sam.key_rows_fused": 2 * P * 64 * 64,
                               "sam.key_rows_plain": 0,
                               "sam2.tail_residual_rows": P * 64 * 64})
    require(rows == want, f"SAM 2 frame counters {rows}, want {want}")
    require(in_encoder == [48], f"SAM 2: K5 launched {in_encoder} times in "
                                f"the encoder, not 48")
    require(lc["flash_rpe_attention"] == 0 and lc["decode_tail_stats"] == 1
            and lc["two_way_keys"] == 32
            and (lc["flash_attention"] - 48) % 24 == 0,
            f"SAM 2 frame launches {lc}")
    n = len(dets)
    require(n > 0 and dets.masks.shape == (n, 480, 640),
            f"SAM 2 frame: {n} detections, masks {dets.masks.shape}")
    require(np.isfinite(dets.scores).all(), "SAM 2 frame: scores")
    out = dict(frame_ms=ms, stages_ms=timer.report(), counts=rows,
               launches=lc, hiera_k5_launches=in_encoder[0], detections=n)
    log(f"SAM 2 frame (thresholds opened): {ms:.1f} ms, detections {n}, "
        f"launches {lc}, stages " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["stages_ms"].items()))
    del det, sam
    torch.cuda.empty_cache()
    return out


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



def counted_stages(demo, kernels, by_stage):
    """Wrap the demo's stage functions so that each run adds its launches
    of `kernels` to by_stage[stage] (a repeated stage as stage_gt); returns
    a function that restores them."""
    import torch

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

    for name in runs:
        setattr(demo, f"run_{name}", counted(name))

    def restore():
        for name, fn in runs.items():
            setattr(demo, f"run_{name}", fn)
    return restore


def phase_demo(dev, smi: str, tmp: Path):
    """Phase 6: the file demo, render -> ISM -> PEM through files, at the
    full width of the default configs, in `tmp`; see the module
    docstring.  The scene and the rendered templates stay for phase 7."""
    import gc

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

    scene, out = tmp / "scene", tmp / "out"
    cad = make_example(str(scene))
    args = ["--cad_path", cad, "--rgb_path", str(scene / "rgb.png"),
            "--depth_path", str(scene / "depth.png"),
            "--cam_path", str(scene / "camera.json"),
            "--output_dir", str(out), "--device", str(dev)]
    restore = counted_stages(demo, kernels, by_stage)
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
        restore()
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



def released_modules():
    """The port module each converter kind loads into, at the released
    checkpoints' widths, on the CPU (zero weights)."""
    import torch

    from sam6d_tpu_torch.config import default_ism_config, default_pem_config
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.fastsam import FastSAM
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.models.vit import ViT

    cfg = default_ism_config()
    return {
        "fastsam": lambda: FastSAM(scale=cfg.fastsam.scale,
                                   device="cpu").net,  # FastSAM-x
        "mae": lambda: ViT(),  # ViT-B/16 at 224
        "pem": lambda: PEM(default_pem_config(), device="cpu"),
        "dinov2": lambda: DescriptorModel(cfg.descriptor).vit,  # ViT-L/14
        "sam": lambda: SAM("vit_h", dtype=torch.bfloat16, device="cpu"),
    }


# The converter's CLI as `python -m` runs it (runpy), with a thread that
# samples the process's resident memory (/proc/self/statm) every 10 ms
# and prints its peak in bytes, or -1 where statm cannot be read.  (The
# rusage maximum of a child also counts the pages of the parent it was
# forked from, and the card's machine has no VmHWM in /proc/self/status.)
CONVERT_CLI = """import os, runpy, sys, threading, time
peak = [0]
def sample():
    page = os.sysconf("SC_PAGE_SIZE")
    while True:
        try:
            with open("/proc/self/statm") as f:
                peak[0] = max(peak[0], int(f.read().split()[1]) * page)
        except (OSError, IndexError, ValueError):
            peak[0] = -1
            return
        time.sleep(0.01)
threading.Thread(target=sample, daemon=True).start()
sys.argv = ["convert_weights"] + sys.argv[1:]
runpy.run_module("sam6d_tpu_torch.convert_weights", run_name="__main__")
print(peak[0])
"""


def convert_cli(kind: str, ckpt: Path, out: Path):
    """`python -m sam6d_tpu_torch.convert_weights` in a process of its
    own: its wall time (host clock), its own timings line and its peak
    resident memory (GiB)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CONVERT_CLI, "--kind", kind, "--ckpt",
         str(ckpt), "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0, f"convert_weights --kind {kind} exited "
            f"with {proc.returncode}: {proc.stderr[-2000:]}")
    said, peak = proc.stdout.strip().splitlines()[-2:]
    return seconds, (int(peak) / 2 ** 30 if int(peak) > 0 else None), said


def check_sam_prompts(sam, dev, image):
    """SAM ViT-H on the converted weights: one frame's embedding (K4 in
    every block), then SamPredictor's two calls: a point prompt, then the
    point, a box and the best mask's logits as a mask prompt."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.ops import flash_rpe

    k4 = flash_rpe.KERNEL_RPE
    before = k4.launches
    with torch.no_grad():
        img, scale, _ = sam.preprocess(torch.from_numpy(image).to(dev))
        emb = sam.encode(img[None])
        pts = torch.tensor([[[320.0, 240.0]]], device=dev) * scale
        labels = torch.ones(1, 1, dtype=torch.long, device=dev)
        logits, iou = sam.decode_prompts(emb, pts, labels)
        box = torch.tensor([[240.0, 160.0, 400.0, 320.0]], device=dev) * scale
        mask = logits[:, int(iou[0].argmax())][..., None]
        logits, iou = sam.decode_prompts(emb, pts, labels, box, mask)
        torch.cuda.synchronize()
    out = logits.float().cpu().numpy()
    h, w = emb.shape[1:3]  # 64 x 64 for ViT-H at 1024
    require(out.shape == (1, 4, 4 * h, 4 * w) and np.isfinite(out).all()
            and np.isfinite(iou.float().cpu().numpy()).all(),
            f"decode_prompts: logits {out.shape}, finite "
            f"{np.isfinite(out).all()}")
    require(k4.launches - before == 32,
            f"the ViT-H encoder launched K4 {k4.launches - before} times")
    return dict(logits_shape=list(out.shape), k4_launches=32,
                logits_abs_max=float(np.abs(out).max()))


def phase_weights(dev, smi: str, tmp: Path):
    """Phase 7: released-layout checkpoints through the converter's CLI,
    strict loads, SAM's prompts on the converted ViT-H, and the FastSAM
    demo on phase 6's scene and templates; see the module docstring."""
    import gc
    import shutil

    import numpy as np
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.fastsam import FastSAM
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.ops import flash_rpe, fps, geo_embed
    from sam6d_tpu_torch.params import load_npz
    from sam6d_tpu_torch.pipeline import demo
    from sam6d_tpu_torch.utils.png import read_png
    from sam6d_tpu_torch.utils.timer import StageTimer

    rc = load_helper("reference_checkpoints")
    wdir = tmp / "weights"
    wdir.mkdir()
    conversions, npz, sam = {}, {}, None
    for seed, (kind, build) in enumerate(released_modules().items()):
        module = build()
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        t0 = time.perf_counter()
        ref = rc.reference_state_dict(kind, shapes, seed=10 + seed)
        ckpt, npz[kind] = wdir / f"{kind}.pth", wdir / f"{kind}.npz"
        torch.save(rc.checkpoint(kind, {k: torch.from_numpy(v)
                                        for k, v in ref.items()}), ckpt)
        n_ref = len(ref)
        del ref
        write_s = time.perf_counter() - t0
        ckpt_gb = ckpt.stat().st_size / 1e9
        seconds, rss_gib, said = convert_cli(kind, ckpt, npz[kind])
        ckpt.unlink()
        t0 = time.perf_counter()
        state = load_npz(str(npz[kind]))
        module.load_state_dict(state)  # strict: no missing, no unexpected
        load_s = time.perf_counter() - t0
        conversions[kind] = dict(
            convert_s=seconds, cli_said=said, peak_rss_gib=rss_gib,
            checkpoint_gb=ckpt_gb,
            npz_gb=npz[kind].stat().st_size / 1e9, tensors_in=n_ref,
            tensors_out=len(state), synthesize_and_save_s=write_s,
            strict_load_s=load_s)
        if kind == "sam":
            require(sum(k.startswith("prompt.mask_downscaling")
                        for k in state) == 10,
                    "the SAM file lacks the mask-downscaling weights")
            sam = module
        del module, state
        gc.collect()
        log(f"convert {kind}: {seconds:.2f} s (host clock, a process of its "
            f"own), peak resident memory "
            f"{'not measured' if rss_gib is None else f'{rss_gib:.2f} GiB'}, "
            f"checkpoint {ckpt_gb:.3f} GB "
            f"({n_ref} tensors) -> {conversions[kind]['tensors_out']} "
            f"tensors, strict load {load_s:.2f} s; the CLI: {said}")

    scene, out6 = tmp / "scene", tmp / "out"
    image = read_png(str(scene / "rgb.png"))[..., :3]
    sam = cast_dense_weights(sam.to(dev).eval())
    prompts = check_sam_prompts(sam, dev, image)
    del sam
    npz["sam"].unlink()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"SAM ViT-H decode_prompts (point, box, mask) on the converted "
        f"weights: {prompts}")

    # The demo with FastSAM, on phase 6's scene and templates (not its
    # descriptor cache, which holds other weights' descriptors).
    out = tmp / "out_fastsam"
    shutil.copytree(out6 / "templates", out / "templates",
                    ignore=shutil.ignore_patterns("descriptors.npz"))
    args = ["--cad_path", str(scene / "obj_example.ply"),
            "--rgb_path", str(scene / "rgb.png"),
            "--depth_path", str(scene / "depth.png"),
            "--cam_path", str(scene / "camera.json"),
            "--output_dir", str(out), "--device", str(dev),
            "--segmentor_model", "fastsam",
            "--fastsam_params", str(npz["fastsam"]),
            "--dinov2_params", str(npz["dinov2"]),
            "--pem_params", str(npz["pem"])]
    kernels = [flash_rpe.KERNEL_PLAIN, fps.KERNEL, geo_embed.KERNEL]
    by_stage, seen = {}, {}
    generate, detect = FastSAM.generate_masks, ISMDetector.detect

    def recording_generate(self, image, timer=None):
        # FastSAM's own stages, each waiting for its device work.
        stages = StageTimer(self.device, sync=True)
        seen["proposals"] = generate(self, image, timer=stages)
        seen["fastsam_ms"] = stages.report()
        return seen["proposals"]

    def recording_detect(self, *a, **k):
        dets = detect(self, *a, **k)
        seen["counts"] = dict(self.last_counts)
        return dets

    FastSAM.generate_masks = recording_generate
    ISMDetector.detect = recording_detect
    restore = counted_stages(demo, kernels, by_stage)
    try:
        for k in all_kernels():
            k.launches = 0
        t0 = time.perf_counter()
        stages = demo.main(args + ["--stages", "ism,pem"])
        wall_s = time.perf_counter() - t0
        ism_rows = json.loads((out / "detection_ism.json").read_text())
        first_pem = json.loads((out / "detection_pem.json").read_text())
        write_gt_detection(str(scene), str(out / "detection_ism.json"))
        t0 = time.perf_counter()
        stages_gt = demo.main(args + ["--stages", "pem"])
        wall_gt_s = time.perf_counter() - t0
    finally:
        restore()
        FastSAM.generate_masks, ISMDetector.detect = generate, detect
    launches = {k.name: k.launches for k in all_kernels()}

    p = seen["proposals"]
    n = len(p["masks"])
    b = p["boxes"]
    require(n > 0 and p["masks"].shape == (n, 480, 640)
            and p["masks"].dtype == bool and b.shape == (n, 4)
            and np.isfinite(b).all() and (b >= 0).all()
            and (b[:, 0::2] <= 639).all() and (b[:, 1::2] <= 479).all(),
            f"FastSAM proposals: masks {p['masks'].shape}, boxes {b.shape}")
    require(all(0.0 <= r["score"] <= 1.0
                and r["segmentation"]["size"] == [480, 640]
                for r in ism_rows), "ISM scores outside [0, 1]")
    require(isinstance(first_pem, list), "detection_pem.json")
    rows = json.loads((out / "detection_pem.json").read_text())
    require(len(rows) == 1, f"{len(rows)} poses on the scene's object")
    R = np.array(rows[0]["R"], np.float64).reshape(3, 3)
    t = np.array(rows[0]["t"], np.float64)
    det = float(np.linalg.det(R))
    require(abs(det - 1.0) < 1e-2 and np.isfinite(t).all()
            and np.isfinite(R).all(), f"pose: det R {det}, t {t}")
    require(by_stage["ism"][flash_rpe.KERNEL_PLAIN.name] > 0,
            "K5 never ran in the FastSAM demo's ISM stage")
    for stage in ("pem", "pem_gt"):
        for k in (fps.KERNEL, geo_embed.KERNEL):
            require(by_stage[stage][k.name] > 0,
                    f"{k.name} never ran in the FastSAM demo's {stage} stage")
    for f in npz.values():
        if f.exists():
            f.unlink()
    log(smi)
    log("FastSAM demo stage times (ms, StageTimer, ism,pem): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()) + f"; wall {wall_s:.1f} s")
    log("FastSAM demo stage times (ms, StageTimer, pem on the scene's "
        "object): " + ", ".join(f"{k} {v:.1f}" for k, v in stages_gt.items())
        + f"; wall {wall_gt_s:.1f} s")
    log("FastSAM generate_masks stages in the demo (ms, StageTimer): "
        + ", ".join(f"{k} {v:.1f}" for k, v in seen["fastsam_ms"].items()))
    log(f"FastSAM demo: proposal counts {seen['counts']}, {len(ism_rows)} "
        f"ISM detections, {len(first_pem)} poses; on the scene's object "
        f"det R {det:.6f}; launches by stage {by_stage}")
    return dict(conversions=conversions, sam_prompts=prompts,
                stages_ms=stages, stages_gt_ms=stages_gt, wall_s=wall_s,
                wall_gt_s=wall_gt_s, proposal_counts=seen["counts"],
                fastsam_stages_ms=seen["fastsam_ms"],
                ism_detections=len(ism_rows), poses=len(first_pem),
                pose_gt=dict(R=R.tolist(), t_mm=t.tolist()),
                launches_by_stage=by_stage, launches=launches)

def timed_steps(step_fn, kernels_note: str):
    """Wrap step_fn(state, batch, generator) -> metrics: CUDA events
    around each step, the host's wait for the batch from the end of the
    previous step (or from the time appended to the returned `marks`
    before the first) to the start of this one, and the batch's shapes
    and image dtype; returns (wrapper, per-step records, marks)."""
    import torch

    steps, last_end = [], []

    def run(st, batch, generator):
        t_in = time.perf_counter()
        wait = (t_in - last_end[-1]) * 1e3
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        m = step_fn(st, batch, generator)
        e.record()
        e.synchronize()
        steps.append(dict(
            ms=s.elapsed_time(e), data_wait_ms=wait,
            shapes={k: list(v.shape) for k, v in batch.items()},
            rgb_dtype=str(batch["rgb"].dtype),
            rgb_device=str(getattr(batch["rgb"], "device", "host")), **m))
        last_end.append(time.perf_counter())
        log(f"{kernels_note} step {len(steps)}: {steps[-1]['ms']:.1f} ms, "
            f"loss {m['loss']:.4f}, grad_norm {m['grad_norm']:.4g}, "
            f"update_skipped {m['update_skipped']:.0f}, waited for data "
            f"{wait:.1f} ms")
        return m

    return run, steps, last_end


def host_sample_times(ds, jpeg_path: str, n: int = 4):
    """Host-clock ms of MegaPoseDataset.__getitem__ (n samples), of a full
    and a crop-limited JPEG decode of one frame, and of color_augment on a
    200 x 200 crop (10 seeds)."""
    import numpy as np

    from sam6d_tpu_torch.provider.augment import color_augment
    from sam6d_tpu_torch.utils.jpeg import read_jpeg

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    sample = [ms(lambda i=i: ds[i]) for i in range(n)]
    full = [ms(lambda: read_jpeg(jpeg_path)) for _ in range(3)]
    half = [ms(lambda: read_jpeg(jpeg_path, rows=240)) for _ in range(3)]
    crop = read_jpeg(jpeg_path)[140:340, 220:420]
    aug = [ms(lambda s=s: color_augment(np.random.RandomState(s), crop))
           for s in range(10)]
    return dict(sample_ms=sample, jpeg_full_ms=full, jpeg_rows240_ms=half,
                color_augment_ms=aug)


def phase_train_data(dev, smi: str, tmp: Path):
    """Phase 8: PEM training from data at full width, in `tmp`; see the
    module docstring."""
    import gc
    import os
    import threading

    import numpy as np
    import torch

    from sam6d_tpu_torch.config import TrainConfig, default_pem_config
    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.pipeline.pem_data import normalize_rgb_np
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
    from sam6d_tpu_torch.provider.training_dataset import (
        RenderedPoseDataset,
        collate,
    )
    from sam6d_tpu_torch.train import train_cli
    from sam6d_tpu_torch.train.checkpoint import save_params
    from sam6d_tpu_torch.train.solver import (
        DevicePrefetcher,
        ProcessSampleStream,
    )
    from sam6d_tpu_torch.train.state import train_step

    t_phase = time.perf_counter()
    B, n_keys, n_steps = 28, 28, 3
    kernels = [fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
               scatter_rows.KERNEL]

    # 1. A MegaPose-layout tree of 480 x 640 frames (numpy JPEG writer).
    t0 = time.perf_counter()
    tree = tmp / "megapose"
    load_helper("megapose_tree").write_megapose_tree(
        tree, n_keys=n_keys, height=480, width=640, seed=0,
        template_size=256)
    tree_s = time.perf_counter() - t0
    n_inst = [len(json.loads(p.read_text())) for p in sorted(
        tree.glob("MegaPose-GSO/train_pbr_web/shard-*/*.gt.json"))]
    log(f"MegaPose tree: {n_keys} keys of 480 x 640 ({sum(n_inst)} "
        f"instances, 1-3 a frame), 2 objects x 2 templates of 256 px, "
        f"written in {tree_s:.1f} s")

    # 2. train_cli --data_dir: MegaPoseDataset -> Solver (thread
    # prefetcher) -> train_step, bf16 compute, float32 parameters.
    log_dir = ROOT / "build" / "train_data_log"
    args = train_cli.parse_args([
        "--data_dir", str(tree), "--steps", str(n_steps), "--epochs", "1",
        "--batch_size", str(B), "--log_dir", str(log_dir)])
    solver = train_cli.build_solver(args)
    state = solver.state
    step_fn, steps, marks = timed_steps(solver.step_fn, "from-data")
    solver.step_fn = step_fn
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    marks.append(t0)  # the first wait: the first batch from scratch
    solver.solve(1)
    solve_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    changed = sum(int(not torch.equal(a, p)) for a, p in
                  zip(before, state.model.parameters()))
    del before
    require(len(steps) == n_steps and state.step == n_steps,
            f"from-data training: {len(steps)} steps ran")
    for k in kernels:
        require(launches[k.name] > 0,
                f"{k.name} never ran in training from data")
    for m in steps:
        require(all(math.isfinite(v) for k, v in m.items()
                    if isinstance(v, float)),
                f"from-data training: non-finite metric in {m}")
    require(state.optimizer.count > 0 and changed > 0,
            f"from-data training: no update applied "
            f"({state.optimizer.count} updates, {changed} tensors changed)")
    cfg = solver.cfg  # (28, 2048, 3), (28, 224, 224, 3), (28, 2, 5000, 3)
    want = {"pts": [B, cfg.n_sample_observed_point, 3],
            "rgb": [B, cfg.img_size, cfg.img_size, 3],
            "tem_pts": [B, 2, cfg.n_sample_template_point, 3]}
    for m in steps:
        for k, shape in want.items():
            require(m["shapes"][k] == shape,
                    f"from-data batch {k} {m['shapes'][k]}, want {shape}")
    host = host_sample_times(solver.dataloader.dataset, str(sorted(
        tree.glob("MegaPose-GSO/train_pbr_web/shard-*/*.rgb.jpg"))[0]))
    step_ms = statistics.median(m["ms"] for m in steps)
    waits = [m["data_wait_ms"] for m in steps]
    log(smi)
    log(f"from data: {n_steps} steps at batch {B}, median {step_ms:.1f} ms "
        f"a step (CUDA events), waits for data (the first from the solve's "
        f"start) {[round(w, 1) for w in waits]} ms, solve {solve_s:.1f} s "
        f"wall, peak memory "
        f"{peak / 2**30:.2f} GiB, {state.optimizer.count} updates, "
        f"{changed} tensors changed, launches {launches}")
    log("host ms (clock): MegaPoseDataset.__getitem__ "
        f"{[round(x, 1) for x in host['sample_ms']]}, JPEG 480 x 640 full "
        f"{[round(x, 1) for x in host['jpeg_full_ms']]}, to row 240 "
        f"{[round(x, 1) for x in host['jpeg_rows240_ms']]}, color_augment "
        f"200 x 200 median {statistics.median(host['color_augment_ms']):.1f}"
        f" (max {max(host['color_augment_ms']):.1f})")
    from_data = dict(steps=steps, step_ms=step_ms, data_wait_ms=waits,
                     solve_s=solve_s, peak_bytes=peak,
                     updates_applied=state.optimizer.count,
                     params_changed=changed, launches=launches,
                     host=host, tree_s=tree_s, instances=sum(n_inst))

    # 3. RenderedPoseDataset(uint8_rgb) -> ProcessSampleStream (forked
    # numpy workers) -> DevicePrefetcher -> train_step, the same state.
    # The workers' first batches are all made during the first wait, and
    # the queues hold n_workers of them, so the steps after the first
    # n_workers read batches that were made while the card trained: their
    # waits are the steady ones.
    n_workers = min(8, (os.cpu_count() or 2) - 1)
    n_rsteps = 24
    t0 = time.perf_counter()
    ds = RenderedPoseDataset(TrainConfig(batch_size=B), n_objects=8,
                             n_samples=10 ** 9, seed=0, uint8_rgb=True)
    ds_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    collate([ds[10 ** 6 + j] for j in range(B)])
    batch_s = time.perf_counter() - t0  # one worker's batch, uncontended
    gc.collect()
    for k in kernels:
        k.launches = 0
    r_step, r_steps, r_marks = timed_steps(train_step, "rendered")
    t0 = time.perf_counter()
    r_marks.append(t0)  # the first wait: from the workers' start
    stream = ProcessSampleStream(ds, B, n_workers=n_workers, depth=4)
    pf = DevicePrefetcher(stream, device=dev, depth=2)
    try:
        it = iter(pf)
        for _ in range(n_rsteps):
            last_batch = next(it)
            r_step(state, last_batch, solver.generator)
    finally:
        pf.close()
        stream.close()
    stream_s = time.perf_counter() - t0
    r_launches = {k.name: k.launches for k in kernels}
    alive = [p.pid for p in stream.workers if p.is_alive()]
    require(not alive, f"rendered stream: workers {alive} still alive")
    for k in kernels:
        require(r_launches[k.name] > 0,
                f"{k.name} never ran on the rendered stream")
    for m in r_steps:
        require(m["rgb_dtype"] == "torch.uint8"
                and m["rgb_device"].split(":")[0] == torch.device(dev).type,
                f"rendered stream: rgb arrived as {m['rgb_dtype']} on "
                f"{m['rgb_device']}")
        require(all(math.isfinite(v) for k, v in m.items()
                    if isinstance(v, float)),
                f"rendered stream: non-finite metric in {m}")
    require(len(r_steps) == n_rsteps,
            f"rendered stream: {len(r_steps)} steps ran")
    r_ms = statistics.median(m["ms"] for m in r_steps)
    r_waits = [m["data_wait_ms"] for m in r_steps]
    steady = r_waits[n_workers:]
    steady_ms = [m["ms"] for m in r_steps[n_workers:]]
    log(f"rendered stream: {n_workers} workers, dataset built in "
        f"{ds_s:.1f} s, one batch of {B} in the main process "
        f"{batch_s * 1e3:.1f} ms (host clock), {n_rsteps} steps at batch "
        f"{B}, median {r_ms:.1f} ms a step, waits for data (the first from "
        f"the workers' start) {[round(w, 1) for w in r_waits]} ms; after "
        f"the first {n_workers} steps: waits median "
        f"{statistics.median(steady):.1f} max {max(steady):.1f} ms, steps "
        f"median {statistics.median(steady_ms):.1f} max "
        f"{max(steady_ms):.1f} ms; {stream_s:.1f} s wall, launches "
        f"{r_launches}, no worker alive after close")
    rendered = dict(n_workers=n_workers, dataset_s=ds_s,
                    batch_ms_main=batch_s * 1e3, steps=r_steps,
                    step_ms=r_ms, data_wait_ms=r_waits,
                    steady_from_step=n_workers + 1,
                    steady_wait_ms_median=statistics.median(steady),
                    steady_wait_ms_max=max(steady),
                    steady_step_ms_median=statistics.median(steady_ms),
                    stream_s=stream_s, launches=r_launches)

    # 3b. The from-data step slows while the Solver's thread loads.  Time
    # the step on one batch already on the card, alone and beside the
    # same MegaPose loading in a thread of this interpreter or in a forked
    # process, in turns: a thread that slows it and a process that does
    # not point at the shared interpreter (the GIL), not at the cores or
    # the batch's copy.
    import multiprocessing as mp

    md = solver.dataloader.dataset

    def load_loop(stop):
        i = 0
        while not stop.is_set():
            md[i % len(md)]
            i += 1

    beside = {"alone": [], "loader thread": [], "loader process": []}
    for _ in range(2):
        for label, ms in beside.items():
            if label == "loader process":
                stop = mp.get_context("fork").Event()
                loader = mp.get_context("fork").Process(
                    target=load_loop, args=(stop,), daemon=True)
            else:
                stop = threading.Event()
                loader = threading.Thread(target=load_loop, args=(stop,),
                                          daemon=True)
            if label != "alone":
                loader.start()
                time.sleep(0.2)
            s_ev, e_ev = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            s_ev.record()
            train_step(state, last_batch, solver.generator)
            e_ev.record()
            e_ev.synchronize()
            ms.append(s_ev.elapsed_time(e_ev))
            stop.set()
            if label != "alone":
                loader.join(timeout=10.0)
                if isinstance(loader, mp.Process) and loader.is_alive():
                    loader.terminate()
                    loader.join(timeout=2.0)
                require(not loader.is_alive(), f"{label} still alive")
    log(f"step on one rendered batch on the card, in turns (CUDA events, "
        f"ms): { {k: [round(x, 1) for x in v] for k, v in beside.items()} }")
    rendered["loader_beside_step_ms"] = beside

    # 4. The trained weights back into serving.
    path = save_params(str(tmp / "pem_trained.npz"), state.model)
    del solver, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    pem_cfg = default_pem_config()
    runner = PEMRunner(pem_cfg, device=dev, seed=0)
    misses = runner.load_params(path)
    require(misses == [], f"handoff: {len(misses)} missed entries "
            f"{misses[:4]}")
    idx = next(i for i in range(1000) if ds.sample(i, aug=False)["obj_idx"]
               == 0)
    s = ds.sample(idx, aug=False)
    for k in (fps.KERNEL, geo_embed.KERNEL):
        k.launches = 0
    tem_rgb, tem_choose, tem_pts = ds.template_arrays(0)
    runner.onboard_arrays(tem_rgb, tem_pts, tem_choose)
    model_pts = ds.meshes[0].sample(pem_cfg.n_sample_model_point, seed=0) / 1e3
    out = runner.infer({
        "pts": s["pts"][None], "rgb": normalize_rgb_np(s["rgb"])[None],
        "rgb_choose": s["rgb_choose"][None],
        "model_pts": model_pts[None].astype(np.float32),
        "score": np.ones(1, np.float32)})
    torch.cuda.synchronize()
    h_launches = {k.name: k.launches for k in (fps.KERNEL, geo_embed.KERNEL)}
    R, t = out["pred_R"][0], out["pred_t"][0]
    det = float(np.linalg.det(R))
    require(abs(det - 1.0) < 1e-2 and np.isfinite(R).all()
            and np.isfinite(t).all(), f"handoff pose: det R {det}, t {t}")
    for name, n in h_launches.items():
        require(n > 0, f"{name} never ran in the handoff request")
    wall_s = time.perf_counter() - t_phase
    log(f"handoff: save_params -> PEMRunner.load_params (0 missed), "
        f"onboarding 8 views, one request on rendered sample {idx}: det R "
        f"{det:.6f}, t {np.round(t, 4).tolist()} m (ground truth "
        f"{np.round(s['gt_t'], 4).tolist()}), launches {h_launches}")
    log(f"phase 8 wall {wall_s:.1f} s")
    return dict(from_data=from_data, rendered=rendered,
                handoff=dict(misses=len(misses), det_R=det, t=t.tolist(),
                             launches=h_launches),
                wall_s=wall_s, launches=launches)


def phase_bop(dev, smi: str, tmp: Path):
    """Phase 9: BOP evaluation at full width, in `tmp`; see the module
    docstring."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from sam6d_tpu_torch.config import default_ism_config, default_pem_config
    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.models.layers import cast_dense_weights
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe, fps, geo_embed
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.pipeline import bop_score, ism_eval
    from sam6d_tpu_torch.pipeline.bop_eval import run_bop_eval, write_bop_csv
    from sam6d_tpu_torch.pipeline.renderer import render_bop_templates
    from sam6d_tpu_torch.utils.rle import rle_to_mask

    t_phase = time.perf_counter()
    ism_kernels = [flash_rpe.KERNEL_RPE, flash_rpe.KERNEL_PLAIN,
                   decode_tail.KERNEL]
    pem_kernels = [fps.KERNEL, geo_embed.KERNEL]

    def counts(kernels):
        return {k.name: k.launches for k in kernels}

    # 1. An LM-O-like tree (tests/helpers/bop_tree.py) and its templates.
    bt = load_helper("bop_tree")
    ds, templates = tmp / "lmo", tmp / "lmo_templates"
    t0 = time.perf_counter()
    tree = bt.write_bop_tree(ds, height=480, width=640, n_test=3, n_pbr=8)
    tree_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    render_bop_templates(str(ds / "models"), str(templates))
    render_s = time.perf_counter() - t0
    ids = set(tree["obj_ids"])
    log(f"BOP tree: objects {sorted(ids)}, 3 test frames (PNG, depth_scale "
        f"0.1) and 8 train_pbr frames (JPEG) of 480 x 640, written in "
        f"{tree_s:.1f} s; render_bop_templates (2 x 42 views of 420 px) "
        f"{render_s:.1f} s")

    # 2. The ISM sweep at full width with phase 4's opened thresholds,
    # onboarded from the rendered templates, then from train_pbr.
    cfg = default_ism_config()
    seg = dataclasses.replace(cfg.segmentor, pred_iou_thresh=-1e9,
                              stability_score_thresh=-1e9)
    cfg = dataclasses.replace(cfg, segmentor=seg, confidence_thresh=-1.0)
    dtype = torch.bfloat16
    sam = SAM(cfg.segmentor.model_type, dtype=dtype, device="cpu")
    init_random_(sam, torch.Generator().manual_seed(0))
    fill_rel_pos_(sam, torch.Generator().manual_seed(2))
    sam = cast_dense_weights(sam.to(dev).eval())
    desc = DescriptorModel(cfg.descriptor, dtype=dtype)
    init_random_(desc, torch.Generator().manual_seed(1))
    desc = cast_dense_weights(desc.to(dev).eval())
    onboarded = {}
    wrapped = {name: getattr(ism_eval, name)
               for name in ("onboard_objects", "onboard_objects_pbr")}

    def timed(name):
        def run(*args, **kwargs):
            before = counts(ism_kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wrapped[name](*args, **kwargs)
            torch.cuda.synchronize()
            onboarded[name] = dict(
                s=time.perf_counter() - t0,
                launches={k: v - before[k]
                          for k, v in counts(ism_kernels).items()})
            return out
        return run

    ism = {}
    for name in wrapped:
        setattr(ism_eval, name, timed(name))
    try:
        for onboarding in ("render", "pbr"):
            det = ISMDetector(cfg, SamAutomaticMaskGenerator(sam, seg), desc,
                              device=dev)
            out = tmp / f"ism_{onboarding}"
            for k in ism_kernels:
                k.launches = 0
            t0 = time.perf_counter()
            rows = ism_eval.run_ism_eval(det, str(ds), str(templates),
                                         str(out), onboarding=onboarding)
            wall_s = time.perf_counter() - t0
            launches = counts(ism_kernels)
            ob = onboarded[{"render": "onboard_objects",
                            "pbr": "onboard_objects_pbr"}[onboarding]]
            frame_s = {r["image_id"]: r["time"] for r in rows}
            require(rows and sorted(frame_s) == [0, 1, 2],
                    f"ISM sweep ({onboarding}): rows of frames "
                    f"{sorted(frame_s)}")
            for r in rows:
                require(r["category_id"] in ids
                        and rle_to_mask(r["segmentation"]).shape == (480, 640)
                        and 0.0 <= r["score"] <= 1.0,
                        f"ISM sweep ({onboarding}): row {r['category_id']} "
                        f"{r['segmentation']['size']} {r['score']}")
            for k in ism_kernels:
                require(launches[k.name] > 0,
                        f"{k.name} never ran in the ISM sweep ({onboarding})")
            require(os.path.exists(out / "ism_descriptors.npz")
                    and det.ref_data.descriptors.shape[:2] == (2, 42),
                    f"ISM sweep ({onboarding}): the descriptor cache")
            ism[onboarding] = dict(
                wall_s=wall_s, onboarding_s=ob["s"],
                onboarding_launches=ob["launches"],
                frame_s=frame_s, rows=len(rows),
                by_object={i: sum(r["category_id"] == i for r in rows)
                           for i in sorted(ids)},
                launches=launches,
                frame_launches={k: launches[k] - ob["launches"][k]
                                for k in launches})
            log(f"ISM sweep, {onboarding} onboarding: {len(rows)} rows "
                f"{ism[onboarding]['by_object']}, onboarding "
                f"{ob['s']:.2f} s (launches {ob['launches']}), frames "
                + ", ".join(f"{v * 1e3:.1f}" for v in frame_s.values())
                + f" ms (rows' time), sweep wall {wall_s:.1f} s, frame "
                f"launches {ism[onboarding]['frame_launches']}")
    finally:
        for name, fn in wrapped.items():
            setattr(ism_eval, name, fn)
    del sam, desc, det
    torch.cuda.empty_cache()

    # 3. The PEM sweep at full width on the GT masks (random weights find
    # no object): both objects in every frame, so the bank cache switches.
    det_path = tmp / "lmo_gt_detections.json"
    dets = bt.gt_detections(ds)
    bt.save_json(det_path, dets)
    pem_out = tmp / "pem"
    for k in pem_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rows = run_bop_eval(default_pem_config(), str(ds), str(det_path),
                        str(templates), str(pem_out), device=dev)
    torch.cuda.synchronize()
    pem_wall_s = time.perf_counter() - t0
    pem_launches = counts(pem_kernels)
    require(len(rows) == len(dets) == 6,
            f"PEM sweep: {len(rows)} rows for {len(dets)} detections")
    for r in rows:
        R = np.array(r["R"], np.float64).reshape(3, 3)
        d = float(np.linalg.det(R))
        require(abs(d - 1.0) < 1e-2 and np.isfinite(R).all()
                and np.isfinite(r["t"]).all(),
                f"PEM sweep pose: det R {d}, t {r['t']}")
    csv = pem_out / "result_bop.csv"
    require(csv.exists() and len(csv.read_text().splitlines()) == 7,
            "PEM sweep: result_bop.csv")
    for k in pem_kernels:
        require(pem_launches[k.name] > 0, f"{k.name} never ran in the PEM "
                                          "sweep")
    # `time` runs from each frame's start: frame 0 holds both onboardings;
    # in frames 1 and 2 each row adds one instance.
    per_instance_s = []
    for im in (1, 2):
        ts = sorted(r["time"] for r in rows if r["im_id"] == im)
        per_instance_s += list(np.diff([0.0] + ts))
    log(f"PEM sweep: {len(rows)} poses, rows' time (s) "
        + ", ".join(f"({r['im_id']}, {r['obj_id']}) {r['time']:.4f}"
                    for r in rows)
        + f"; per instance in frames 1-2 "
        + ", ".join(f"{v * 1e3:.1f}" for v in per_instance_s)
        + f" ms; sweep wall {pem_wall_s:.1f} s; launches {pem_launches}")

    # 4. The scorer's CLI in a process of its own: the GT poses with VSD
    # score AR 1 exactly; the PEM's csv a finite AR in [0, 1].
    def score_cli(path):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sam6d_tpu_torch.pipeline.bop_score",
             "--csv", str(path), "--dataset_dir", str(ds)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"bop_score CLI: {proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), wall

    gt_csv = tmp / "lmo_gt_poses.csv"
    write_bop_csv(bt.gt_pose_rows(ds), str(gt_csv))
    gt_score, gt_wall_s = score_cli(gt_csv)
    require(gt_score["ar"] == 1.0 and gt_score.get("ar_vsd") == 1.0
            and gt_score["n_gt"] == 6, f"GT poses scored {gt_score}")
    pem_score, pem_score_s = score_cli(csv)
    require(all(math.isfinite(pem_score[k]) and 0.0 <= pem_score[k] <= 1.0
                for k in ("ar", "ar_mssd", "ar_mspd", "ar_vsd")),
            f"PEM poses scored {pem_score}")
    # The rasterizer's share of the scorer (the native library since PR
    # 12; phase 10 times it against numpy): the PEM csv once more in this
    # process, each VSD depth render timed.
    renders = []
    render_depth = bop_score._render_depth

    def timed_render(*args):
        t0 = time.perf_counter()
        out = render_depth(*args)
        renders.append(time.perf_counter() - t0)
        return out

    bop_score._render_depth = timed_render
    try:
        t0 = time.perf_counter()
        again = bop_score.score_dataset(bop_score.read_bop_csv(str(csv)),
                                        str(ds))
        score_s = time.perf_counter() - t0
    finally:
        bop_score._render_depth = render_depth
    require(again == pem_score, f"in-process score {again} != CLI's")
    render_ms = 1e3 * statistics.median(renders)
    wall_s = time.perf_counter() - t_phase
    log(smi)
    log(f"bop_score CLI (own process): GT poses {gt_wall_s:.2f} s -> "
        f"{gt_score}; PEM poses {pem_score_s:.2f} s -> {pem_score}")
    log(f"bop_score in process on the PEM's csv: {score_s:.3f} s, of it "
        f"{len(renders)} VSD depth renders at 480 x 640 {sum(renders):.3f} s "
        f"({100 * sum(renders) / score_s:.1f}%), median {render_ms:.1f} ms "
        f"a render")
    log(f"phase 9 wall {wall_s:.1f} s")
    return dict(tree_s=tree_s, render_s=render_s, ism=ism,
                pem=dict(wall_s=pem_wall_s, launches=pem_launches,
                         rows_time_s=[(r["im_id"], r["obj_id"], r["time"])
                                      for r in rows],
                         per_instance_s=per_instance_s),
                score=dict(gt=gt_score, gt_cli_s=gt_wall_s, pem=pem_score,
                           pem_cli_s=pem_score_s, in_process_s=score_s,
                           renders=len(renders), render_s=sum(renders),
                           render_ms_median=render_ms),
                wall_s=wall_s)


def check_pointnet2(dev):
    """PointNet++'s SSG classification net's first SA layer at its
    published widths (Qi et al. 2017: npoint 512, radius 0.2, nsample 32,
    MLP [64, 64, 128]) on B = 8 clouds of 2048 points with use_xyz and no
    features, then an FP module back to the 2048 points (MLP [128, 128]);
    seeded weights and BatchNorm statistics, eval mode, float32, on the
    card (FPS through K1) against the same modules on the CPU."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.ops import fps
    from sam6d_tpu_torch.ops.pointnet2_modules import (
        PointnetFPModule,
        PointnetSAModule,
    )
    from sam6d_tpu_torch.params import init_random_

    gen = torch.Generator().manual_seed(10)
    sa = init_random_(PointnetSAModule([64, 64, 128], npoint=512, radius=0.2,
                                       nsample=32), gen).eval()
    fp = init_random_(PointnetFPModule([128, 128], in_channels=128),
                      gen).eval()
    with torch.no_grad():
        for name, b in list(sa.named_buffers()) + list(fp.named_buffers()):
            b.copy_((0.5 + torch.rand(b.shape, generator=gen))
                    if name.endswith("running_var")
                    else 0.1 * torch.randn(b.shape, generator=gen))
    rng = np.random.RandomState(10)
    xyz = torch.from_numpy((rng.rand(8, 2048, 3) - 0.5).astype(np.float32))

    def run(x):
        with torch.inference_mode():
            new_xyz, feats = sa(x)
            return new_xyz, feats, fp(x, new_xyz, None, feats)

    t0 = time.perf_counter()
    cpu = run(xyz)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    sa.to(dev)
    fp.to(dev)
    x = xyz.to(dev)
    run(x)  # first use: cuBLAS handles, allocator
    torch.cuda.synchronize()
    fps.KERNEL.launches = 0
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    gpu = run(x)
    e.record()
    e.synchronize()
    card_ms = s.elapsed_time(e)
    launches = fps.KERNEL.launches
    require(launches > 0, "pointnet2: K1 never ran in PointnetSAModule")
    with torch.inference_mode():
        idx_gpu = fps.furthest_point_sample(x, 512).cpu()
    idx_cpu = fps.fps_plain(xyz, 512)
    require(torch.equal(idx_gpu, idx_cpu), "pointnet2: K1's centres differ "
                                           "from the CPU's")
    errs = {}
    for name, g, c in zip(("new_xyz", "sa_feats", "fp_feats"), gpu, cpu):
        require(tuple(g.shape) == tuple(c.shape)
                and bool(torch.isfinite(g).all()),
                f"pointnet2 {name}: {tuple(g.shape)}")
        errs[name] = dict(max_abs_err=float((g.cpu() - c).abs().max()),
                          rel_err=rel_err(g, c))
        # Tolerances, Frobenius relative: the SA 1e-5 (the card's and the
        # CPU's float32 matmuls sum in other orders, ~1e-7 relative; a
        # squared distance that close to radius^2 would move one
        # neighbour of one ball).  The FP 1e-4: its dense points include
        # the 512 centres, whose distance to themselves is the square
        # root of the cancellation residual |x|^2 - 2 x.x + |x|^2 (about
        # 1e-4, not 0), which the two devices' matmuls leave different, so
        # those points' inverse-distance weights differ (4.6e-5 measured
        # on an H100).
        tol = 1e-4 if name == "fp_feats" else 1e-5
        require(errs[name]["rel_err"] <= tol,
                f"pointnet2 {name}: rel err {errs[name]['rel_err']} > {tol}")
    log(f"pointnet2 SSG SA (8 x 2048 -> 512, r 0.2, 32, [64, 64, 128]) + FP "
        f"(-> 2048, [128, 128]), float32: card {card_ms:.2f} ms (one call, "
        f"CUDA events), CPU {cpu_ms:.1f} ms (host clock, this machine's "
        f"cores), K1 launches {launches}; errors against the CPU {errs} "
        f"(tolerance 1e-5 relative, the FP's 1e-4)")
    return dict(card_ms=card_ms, cpu_ms=cpu_ms, k1_launches=launches,
                errors=errs)


def check_native(smi: str, tmp: Path):
    """The native host library: its build, the demo's render stage through
    it (and through numpy, in the same run), and 12 VSD depth renders at
    480 x 640 through each in turns."""
    import os

    import numpy as np

    from sam6d_tpu_torch.pipeline import renderer
    from sam6d_tpu_torch.pipeline.make_example import make_example
    from sam6d_tpu_torch.utils import native
    from sam6d_tpu_torch.utils.mesh import load_mesh

    lib = native.LIBRARY
    t0 = time.perf_counter()
    require(lib.load() is not None,
            f"native library: {native.build_error()}")
    load_s = time.perf_counter() - t0
    log(f"native library {lib.path.relative_to(ROOT)}: g++ build "
        f"{lib.build_s} s, load {load_s:.3f} s")
    calls0 = dict(lib.calls)

    # The demo's render stage: 42 views at 420 px of the example cube.
    cad = make_example(str(tmp / "p10_scene"))
    rasterized = lib.calls["rasterize"]
    render_ms = {}
    for route in ("native", "numpy", "native"):
        if route == "numpy":
            os.environ[native.NO_NATIVE_ENV] = "1"
        try:
            t0 = time.perf_counter()
            renderer.render_templates(cad, str(tmp / f"p10_{route}"), 420)
            render_ms.setdefault(route, []).append(
                (time.perf_counter() - t0) * 1e3)
        finally:
            os.environ.pop(native.NO_NATIVE_ENV, None)
    require(lib.calls["rasterize"] - rasterized == 84,
            "native: the render stage did not go through the library")

    # VSD's depth renders: phase 9's tree, each GT pose at 480 x 640.
    bt = load_helper("bop_tree")
    ds = tmp / "lmo"
    rows = bt.gt_pose_rows(ds)
    scene_dir = sorted((ds / "test").iterdir())[0]
    cams = json.loads((scene_dir / "scene_camera.json").read_text())
    K = np.asarray(cams[str(rows[0]["im_id"])]["cam_K"],
                   np.float64).reshape(3, 3)
    meshes = {r["obj_id"]: load_mesh(str(ds / "models" /
                                         f"obj_{r['obj_id']:06d}.ply"))
              for r in rows}
    times = {"native": [], "numpy": []}
    max_disagree = max_depth_err = 0.0
    for i in range(12):
        r = rows[i % len(rows)]
        mesh = meshes[r["obj_id"]]
        R = np.asarray(r["R"], np.float64).reshape(3, 3)
        verts = mesh.vertices @ R.T + np.asarray(r["t"])
        attrs = np.zeros((len(mesh.vertices), 1), np.float32)
        out = {}
        for route in (("native", "numpy") if i % 2 == 0
                      else ("numpy", "native")):
            fn = (native.rasterize if route == "native"
                  else renderer.rasterize_numpy)
            t0 = time.perf_counter()
            out[route] = fn(verts, mesh.faces, K, (480, 640), attrs)
            times[route].append((time.perf_counter() - t0) * 1e3)
        (_, m_n, d_n), (_, m_p, d_p) = out["native"], out["numpy"]
        both = m_n & m_p
        require(both.sum() > 100, "native: the object is not in view")
        max_disagree = max(max_disagree, float((m_n != m_p).mean()))
        max_depth_err = max(max_depth_err,
                            float(np.abs(d_n[both] - d_p[both]).max()
                                  / np.abs(d_p[both]).max()))
    require(max_disagree <= 2e-3, f"native masks disagree on "
                                  f"{max_disagree} of the pixels")
    require(max_depth_err <= 1e-4, f"native depth rel err {max_depth_err}")

    calls = {k: v - calls0.get(k, 0) for k, v in lib.calls.items()}
    med = {k: statistics.median(v) for k, v in times.items()}
    log(smi)
    log(f"demo render stage (42 views at 420 px, render_templates): native "
        + ", ".join(f"{v:.1f}" for v in render_ms["native"])
        + f" ms, numpy {render_ms['numpy'][0]:.1f} ms (PR 8's numpy: "
        f"2218.4 ms)")
    log(f"12 VSD depth renders at 480 x 640 in turns: median native "
        f"{med['native']:.2f} ms, numpy {med['numpy']:.2f} ms; masks "
        f"disagree on at most {max_disagree:.2e} of the pixels (limit 2e-3),"
        f" depth within {max_depth_err:.1e} relative where both cover "
        f"(limit 1e-4)")
    log(f"native calls {calls}")
    return dict(build_s=lib.build_s, render_stage_ms=render_ms,
                vsd_render_ms=times, vsd_render_median_ms=med,
                mask_disagree=max_disagree, depth_rel_err=max_depth_err,
                calls=calls)


def check_distributed(dev, tmp: Path, request):
    """torch.distributed on one card: a one-rank NCCL group, PEMRunner on
    a 1 x 1 ("dp", "hyp") mesh against the runner without one, the
    barrier, the shard merge, one step of `train_cli.main` with --tp 1
    through the distributed code; the group destroyed at the end.  (The
    group of one rank is started here: `init_distributed` starts none for
    one process, and then only reports it.)"""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from sam6d_tpu_torch.config import default_pem_config
    from sam6d_tpu_torch.ops import fps, geo_embed, scatter_rows
    from sam6d_tpu_torch.parallel.distributed import (
        init_distributed,
        sync_hosts,
    )
    from sam6d_tpu_torch.parallel.mesh import make_mesh
    from sam6d_tpu_torch.parallel.pem_serving import MeshPEMRunner
    from sam6d_tpu_torch.pipeline.bop_eval import write_shard_and_merge
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
    from sam6d_tpu_torch.train import train_cli

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        require(init_distributed() and dist.get_backend() == backend,
                f"the one-rank {backend} group")
        mesh = make_mesh((1, 1), ("dp", "hyp"), dev.type)
        cfg = default_pem_config()
        S, Np = cfg.feature_extraction.img_size, cfg.n_sample_template_point
        T = cfg.n_template_view
        rng = np.random.RandomState(3)
        tem = dict(tem_rgb=rng.rand(T, S, S, 3).astype(np.float32),
                   tem_pts=(rng.randn(T, Np, 3) * 0.04).astype(np.float32),
                   tem_choose=rng.randint(0, S * S, (T, Np)).astype(np.int64))
        t0 = time.perf_counter()
        plain = PEMRunner(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        meshed = MeshPEMRunner(cfg, mesh, state_dict=plain.model.state_dict(),
                               device=dev, dtype=torch.bfloat16)
        plain.onboard_arrays(**tem)
        meshed.tem_pts, meshed.tem_feat = plain.tem_pts, plain.tem_feat
        meshed.make_template_bank(plain.tem_pts, plain.tem_feat)
        init_s = time.perf_counter() - t0
        inp = request(1)
        gen = torch.Generator(device=dev).manual_seed(4)
        shape = (1, 3 * cfg.coarse_point_matching.nproposal1, 1)
        u = tuple(torch.rand(shape, generator=gen, device=dev)
                  for _ in range(2))
        for k in (fps.KERNEL, geo_embed.KERNEL):
            k.launches = 0
        t0 = time.perf_counter()
        got = meshed.infer(inp, uniforms=u)
        torch.cuda.synchronize()
        mesh_ms = (time.perf_counter() - t0) * 1e3
        runner_launches = {k.name: k.launches
                           for k in (fps.KERNEL, geo_embed.KERNEL)}
        want = plain.infer(inp, uniforms=u)
        # Warm: the first mesh request also opened NCCL's communicator.
        # Host clock around each call (infer returns host arrays), in
        # turns plain, mesh, mesh, plain, ...
        warm = {"plain": [], "mesh": []}
        for i in range(8):
            for name in (("plain", "mesh") if i % 2 == 0
                         else ("mesh", "plain")):
                r = plain if name == "plain" else meshed
                t1 = time.perf_counter()
                r.infer(inp, uniforms=u)
                warm[name].append((time.perf_counter() - t1) * 1e3)
        warm_ms = {k: statistics.median(v) for k, v in warm.items()}
        for k in runner_launches:
            require(runner_launches[k] > 0,
                    f"{k} never ran in the mesh runner's request")
        diff = max(float(np.abs(got[k] - want[k]).max())
                   for k in ("pred_R", "pred_t", "pose_score"))
        # The same kernels on the same inputs and draws (a hyp axis of
        # one rank solves the whole budget): 1e-5 allows only a
        # reordered reduction.
        require(diff <= 1e-5, f"mesh runner differs from the plain runner "
                              f"by {diff}")
        del plain, meshed
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        sync_hosts("phase 10")
        barrier_ms = (time.perf_counter() - t0) * 1e3
        rows = [{"scene_id": 0, "im_id": i} for i in range(3)]
        merged = write_shard_and_merge(str(tmp / "p10_merge"), rows,
                                       prefix="pem_shard",
                                       merged_name="merged.json")
        require(merged == rows, f"merge under the group: {merged}")

        # One step of the CLI's entry point (init_distributed finds the
        # group; mesh (1, 1), shard_train_state, the parallel step) at
        # batch 4, the step recorded through the train_step it looks up.
        kernels = [fps.KERNEL, geo_embed.KERNEL, geo_embed.KERNEL_BWD,
                   scatter_rows.KERNEL]
        metrics, before = [], []
        train_step = train_cli.train_step

        def step(state, batch, generator):
            before.extend(p.detach().clone()
                          for p in list(state.model.parameters())[:8])
            metrics.append(train_step(state, batch, generator))
            return metrics[-1]

        train_cli.train_step = step
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        try:
            solver = train_cli.main([
                "--synthetic", "--steps", "1", "--epochs", "1",
                "--batch_size", "4", "--tp", "1", "--log_dir",
                str(tmp / "p10_train"), "--device", str(dev)])
        finally:
            train_cli.train_step = train_step
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {k.name: k.launches for k in kernels}
        require(solver.state.parallel is not None
                and solver.state.parallel.dp == 1, "train_cli's mesh")
        require(len(metrics) == 1 and all(math.isfinite(v)
                                          for v in metrics[0].values()),
                f"train_cli step metrics {metrics}")
        params = list(solver.state.model.parameters())
        require(metrics[0]["update_skipped"] == 0.0
                and any(not torch.equal(b, p) for b, p in zip(before, params)),
                "train_cli step: no update applied")
        for k, n in train_launches.items():
            require(n > 0, f"{k} never ran in the train_cli step")
        del solver, params, before
    finally:
        dist.destroy_process_group()
    require(not dist.is_initialized(), "the group was not destroyed")
    log(f"one-rank {backend} group: PEMRunner on a 1 x 1 (dp, hyp) mesh equals "
        f"the plain runner (max diff {diff}), first request {mesh_ms:.1f} "
        f"ms, warm median {warm_ms['mesh']:.2f} ms against the plain "
        f"runner's {warm_ms['plain']:.2f} ms (8 each, in turns), launches "
        f"{runner_launches}; runners and bank {init_s:.1f} s; "
        f"sync_hosts {barrier_ms:.2f} ms; merge of 3 rows; train_cli.main "
        f"--tp 1 step at batch 4 (loss {metrics[0]['loss']:.4f}, grad norm "
        f"{metrics[0]['grad_norm']:.4f}) {train_s:.1f} s with its "
        f"checkpoint, launches {train_launches}")
    return dict(mesh_request_ms=mesh_ms, warm_request_ms=warm,
                runner_launches=runner_launches,
                barrier_ms=barrier_ms, train_s=train_s,
                train_metrics=metrics[0], train_launches=train_launches)


def check_tooling(dev, tmp: Path, request):
    """`profiling.trace` around one PEM request: the CUDA activity, and
    the program's spans (`utils/timer.stage`: a `stage` span around the
    request, `PEMRunner.infer`'s own inside it) on the trace's clock;
    `debug_tap` with its variable set writes the tensor."""
    import os

    import numpy as np
    import torch

    from sam6d_tpu_torch.config import default_pem_config
    from sam6d_tpu_torch.ops.debug import DEBUG_ENV, debug_tap
    from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner
    from sam6d_tpu_torch.utils import profiling, timer

    cfg = default_pem_config()
    runner = PEMRunner(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    T, S = cfg.n_template_view, cfg.feature_extraction.img_size
    Np = cfg.n_sample_template_point
    rng = np.random.RandomState(5)
    runner.onboard_arrays(
        rng.rand(T, S, S, 3).astype(np.float32),
        (rng.randn(T, Np, 3) * 0.04).astype(np.float32),
        rng.randint(0, S * S, (T, Np)).astype(np.int64))
    inp = request(1)
    runner.infer(inp)
    trace_dir = tmp / "p10_trace"
    with profiling.trace(str(trace_dir)):
        with timer.stage(None, "phase10_pem_request"):
            runner.infer(inp)
    traces = list(trace_dir.glob("trace_*.json"))
    require(len(traces) == 1, f"profiling.trace wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    require({"phase10_pem_request", "pem_runner.infer", "pem.forward",
             "pem.coarse_solve"} <= set(spans),
            f"the trace's spans are {sorted(spans)}")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    n_device = len(kernels)
    top = spans["phase10_pem_request"]
    require(not any(e.get("cat") == "cpu_op" for e in events),
            "profiling.trace recorded the CPU activity by default")
    require(n_device > 0 and all(
        top["ts"] <= e["ts"] <= top["ts"] + top["dur"] for e in kernels),
        "a kernel of the request lies outside its span on the trace's clock")
    x = torch.randn(4, 5, device=dev)
    os.environ[DEBUG_ENV] = "1"
    try:
        require(debug_tap(x, "phase10", str(tmp / "p10_taps")) is x,
                "debug_tap is not the identity")
    finally:
        del os.environ[DEBUG_ENV]
    saved = np.load(tmp / "p10_taps" / "torch_debug_node_phase10.npy")
    require(np.array_equal(saved, x.cpu().numpy()), "debug_tap's file")
    log(f"profiling.trace: {traces[0].stat().st_size} bytes, "
        f"{len(events)} events ({n_device} device kernels, each inside the "
        f"request's span; {len(spans)} span names); "
        f"debug_tap wrote the tensor")
    return dict(trace_bytes=traces[0].stat().st_size, trace_events=len(events),
                trace_kernels=n_device)


def phase_last_modules(dev, smi: str, tmp: Path, request):
    """Phase 10: the modules ported last; see the module docstring."""
    t0 = time.perf_counter()
    out = dict(pointnet2=check_pointnet2(dev), native=check_native(smi, tmp),
               distributed=check_distributed(dev, tmp, request),
               tooling=check_tooling(dev, tmp, request))
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 10 wall {out['wall_s']:.1f} s")
    return out


# Phase 11: the accuracy loop.  Steps of 11a and its bound on the
# held-out rotation error, from the long run of smoke_train_eval on the
# card (`accuracy_runs.sh`; PERF.md section 6).
SMOKE_STEPS = 1000
SMOKE_ROT_FRACTION = 0.6
FLAGSHIP_STEPS = 30
ISM_STEPS = 5


class LaunchTally:
    """The kernels' launches within the main path's calls alone: `run`
    zeroes every count just before a call and adds the counts just after
    to the tally, so that the checks between calls (card against CPU)
    count nothing."""

    def __init__(self):
        self.kernels = all_kernels()
        self.counts = {k.name: 0 for k in self.kernels}

    def run(self, fn, *args, **kwargs):
        for k in self.kernels:
            k.launches = 0
        out = fn(*args, **kwargs)
        for k in self.kernels:
            self.counts[k.name] += k.launches
        return out


def ism_frames(objects, per_object: int):
    """The first `per_object` RGB frames (uint8 (H, W, 3)) of each object
    of an `e2e_synthetic_ar.build_multi_dataset` tree."""
    from sam6d_tpu_torch.utils.png import read_png

    return [read_png(f"{o['scene']}/rgb/{d['image_id']:06d}.png")[..., :3]
            for o in objects for d in o["dets"][:per_object]]


def check_tiny_sam_amg(dev, sam_ckpt: str, frames, what: str):
    """The tiny SAM's AMG as `ism_accuracy_eval` serves it
    (`load_tiny_sam_amg`: a 24 x 24 prompt grid, the tool's thresholds)
    on `frames`, on the card (K4 in every encoder block, K6 for the
    candidates' statistics) against the same weights on the CPU (their
    plain versions), the fused tail on both: the image embedding; every
    candidate's predicted IoU, stability and box, by index (3 a prompt,
    1728 a frame); which candidates the tool's thresholds keep; and the
    masks and boxes that the AMG returns.

    tolerance (float32 on both devices; K4 and K6 keep float32 accuracy,
    so the two differ by the order of float32 sums): the embedding 1e-4
    relative (Frobenius), each IoU 1e-3; a stability is a ratio of pixel
    counts that flips where a logit lies within rounding of a threshold,
    as K6's counts against its plain version (8 pixels): 0.05 on 99% of
    the candidates, and the kept sets differ by at most 1% of them; the
    returned masks equal in number, agreeing on 99.9% of their pixels,
    boxes within 3 px."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.models.ism.sam import amg as A
    from sam6d_tpu_torch.tools import train_tiny_sam as ts

    res = {}
    for device in ("cpu", dev):
        gen = ts.load_tiny_sam_amg(sam_ckpt, device=device)
        gen.fused = True
        cfg, sam = gen.cfg, gen.sam
        res[device] = []
        for frame in frames:
            with torch.no_grad():
                img, _, (eh, ew) = sam.preprocess(
                    torch.from_numpy(np.ascontiguousarray(frame)).to(device))
                emb = sam.encode(img[None])
                pts = torch.from_numpy(gen.point_grid * np.array(
                    [ew, eh], np.float32)).to(device)[None]
                _, _, iou, stab, boxes = A.fused_candidates(
                    emb, pts, sam=sam, points_per_batch=cfg.points_per_batch,
                    mask_threshold=cfg.mask_threshold,
                    stability_offset=cfg.stability_score_offset)
            out = gen.generate_masks(frame)
            iou, stab, boxes = (t.float().cpu().numpy()
                                for t in (iou, stab, boxes))
            keep = ((iou > cfg.pred_iou_thresh)
                    & (stab > cfg.stability_score_thresh)
                    & (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1]))
            res[device].append(dict(emb=emb.float().cpu(), iou=iou,
                                    stab=stab, boxes=boxes, keep=keep,
                                    masks=out["masks"], mboxes=out["boxes"]))
        del gen, sam
    rows = []
    for i, (c, g) in enumerate(zip(res["cpu"], res[dev])):
        dstab = np.abs(g["stab"] - c["stab"])
        row = dict(
            frame=i, candidates=len(c["iou"]),
            emb_rel_err=rel_err(g["emb"], c["emb"]),
            iou_max_abs_err=float(np.abs(g["iou"] - c["iou"]).max()),
            stab_max_abs_err=float(dstab.max()),
            stab_over_0_05=int((dstab > 0.05).sum()),
            box_max_abs_err=float(np.abs(g["boxes"] - c["boxes"]).max()),
            kept=[int(c["keep"].sum()), int(g["keep"].sum())],
            kept_differ=int((c["keep"] != g["keep"]).sum()),
            masks=[len(c["masks"]), len(g["masks"])],
            stab_quantiles=np.round(np.quantile(
                g["stab"], [0.5, 0.9, 1.0]), 3).tolist(),
            iou_quantiles=np.round(np.quantile(
                g["iou"], [0.5, 0.9, 1.0]), 3).tolist())
        if len(c["masks"]) == len(g["masks"]) and len(c["masks"]):
            row["mask_agreement"] = float((g["masks"] == c["masks"]).mean())
            row["mbox_max_abs_err"] = float(
                np.abs(g["mboxes"] - c["mboxes"]).max())
        rows.append(row)
        log(f"{what} frame {i}: {row}")
    for i, row in enumerate(rows):  # every frame logged before a check
        n = row["candidates"]
        require(row["emb_rel_err"] <= 1e-4 and row["iou_max_abs_err"] <= 1e-3,
                f"{what} frame {i}: embedding {row['emb_rel_err']}, IoU "
                f"{row['iou_max_abs_err']}")
        require(row["stab_over_0_05"] <= 0.01 * n
                and row["kept_differ"] <= 0.01 * n,
                f"{what} frame {i}: stability off by > 0.05 on "
                f"{row['stab_over_0_05']} of {n} candidates, kept sets "
                f"differ on {row['kept_differ']}")
        require(row["masks"][0] == row["masks"][1]
                and row.get("mask_agreement", 1.0) > 0.999
                and row.get("mbox_max_abs_err", 0.0) <= 3.0,
                f"{what} frame {i}: masks {row['masks']}, agreement "
                f"{row.get('mask_agreement')}, boxes "
                f"{row.get('mbox_max_abs_err')}")
    return rows


def accuracy_learnability(dev, tmp: Path, tally: LaunchTally):
    """11a: smoke_train_eval's rendered recipe (128 training objects, as
    its long run) for SMOKE_STEPS steps at batch 8; the held-out median rotation error after training must be at
    most SMOKE_ROT_FRACTION of the untrained one.  The first batch's
    gradients are held to the CPU's first."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.params import init_random_
    from sam6d_tpu_torch.provider.training_dataset import collate
    from sam6d_tpu_torch.tools import smoke_train_eval as se
    from sam6d_tpu_torch.train.checkpoint import save_train_state
    from sam6d_tpu_torch.train.state import create_train_state

    t0 = time.perf_counter()
    cfg, B = se.smoke_pem_config(), 8
    ds, ev = se.make_datasets("rendered", se.train_config(B), objects=128,
                              eval_objects=8, n_eval=16)
    rng = np.random.RandomState(0)
    noise = (5.0, *(torch.from_numpy(rng.randn(B, 3).astype(np.float32))
                    for _ in range(2)))
    step_check = train_grads_card_vs_cpu(
        dev, lambda: init_random_(PEM(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0)),
        collate([ds[j] for j in range(B)]), noise,
        "smoke-config train step")
    state = create_train_state(cfg, se.optim_config(3e-4, SMOKE_STEPS),
                               device=dev, seed=0)
    before = tally.run(se.evaluate, state.model, ev, n_eval=16, batch_size=B,
                       tag="11a untrained")
    gen = torch.Generator(device=dev).manual_seed(1)
    t1 = time.perf_counter()
    steps = tally.run(se.train, state, ds, SMOKE_STEPS, B, generator=gen,
                      log_every=100)
    train_s = time.perf_counter() - t1
    after = tally.run(se.evaluate, state.model, ev, n_eval=16, batch_size=B,
                      tag=f"11a trained {SMOKE_STEPS} steps")
    ckpt = save_train_state(str(tmp / "smoke_ckpt"), state)
    losses = [m["loss"] for m in steps]
    step_ms = [m["step_ms"] for m in steps[min(5, len(steps) - 1):]]
    out = dict(steps=SMOKE_STEPS, batch=B, loss_first=losses[0],
               loss_last=losses[-1], step_ms_median=statistics.median(step_ms),
               step_ms_spread=[min(step_ms), max(step_ms)],
               train_wall_s=train_s, ckpt=str(Path(ckpt).parent),
               rot_median=[before["rot_median"], after["rot_median"]],
               trans_median_mm=[before["trans_median"] * 1e3,
                                after["trans_median"] * 1e3],
               coarse_rot_median=[before["coarse_rot_median"],
                                  after["coarse_rot_median"]],
               step_check=step_check)
    log(f"11a: loss {losses[0]:.3f} -> {losses[-1]:.3f}, step "
        f"{out['step_ms_median']:.2f} ms (CUDA events, median after 5), "
        f"held-out rot median {before['rot_median']:.1f} -> "
        f"{after['rot_median']:.1f} deg, trans "
        f"{out['trans_median_mm'][0]:.1f} -> {out['trans_median_mm'][1]:.1f}"
        f" mm, {train_s:.1f} s of training")
    require(all(math.isfinite(x) for x in losses), "11a: non-finite loss")
    require(after["rot_median"] <= SMOKE_ROT_FRACTION * before["rot_median"],
            f"11a: held-out rotation median {after['rot_median']:.1f} deg is "
            f"above {SMOKE_ROT_FRACTION} x the untrained "
            f"{before['rot_median']:.1f}")
    out["wall_s"] = time.perf_counter() - t0
    return out


def accuracy_flagship(dev, tmp: Path, tally: LaunchTally):
    """11b: train_flagship for FLAGSHIP_STEPS steps at batch 8 (the worker
    stream, bf16), every parameter updated, then e2e_synthetic_ar's run_eval
    on its 12-frame tree with the untrained and the trained weights (AR in
    [0, 1]) and the GT poses through the same scorer (AR exactly 1)."""
    import os

    import torch

    from sam6d_tpu_torch.config import OptimConfig, default_pem_config
    from sam6d_tpu_torch.pipeline.bop_score import score_dataset
    from sam6d_tpu_torch.tools import e2e_synthetic_ar as e2e
    from sam6d_tpu_torch.tools import train_flagship as tf

    t0 = time.perf_counter()
    cfg, B = default_pem_config(), 8
    ds = tf.make_dataset(B, objects=16)
    stream = tf.make_stream(ds, B, FLAGSHIP_STEPS,
                            workers=max(1, min(7, (os.cpu_count() or 2) - 1)))
    state = tf.make_state(cfg, tf.optim_config(1e-4, FLAGSHIP_STEPS), dev)
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(1)
    log_ = tally.run(tf.train, state, stream, FLAGSHIP_STEPS,
                     str(tmp / "flagship_ckpt"), FLAGSHIP_STEPS, gen,
                     log_every=10)
    losses = [m["loss"] for m in log_]
    still = [n for n, p in state.model.named_parameters()
             if torch.equal(p.detach(), p0[n])]
    require(all(math.isfinite(x) for x in losses), "11b: non-finite loss")
    require(not still, f"11b: parameters not updated: {still[:8]}")
    require(all(m["update_skipped"] == 0.0 for m in log_[1:]),
            "11b: an update was skipped")

    eval_dir = tmp / "e2e_flagship"
    cad, tdir, scene, dets = e2e.build_dataset(str(eval_dir), frames=12)
    objs = [{"obj_id": 1, "scene_id": 0, "scene": scene}]
    gt = score_dataset(e2e.gt_rows(objs), str(eval_dir))
    require(gt["ar"] == 1.0, f"11b: GT poses AR {gt['ar']}")
    rand = tf.make_state(cfg, OptimConfig(), dev)
    ars = {}
    for tag, weights in (("untrained", rand.model.state_dict()),
                         ("trained", state.model.state_dict())):
        r = tally.run(e2e.run_eval, weights, cfg, cad, tdir, scene, dets,
                      str(eval_dir / tag), f"11b {tag}", device=dev)
        require(0.0 <= r["ar"] <= 1.0, f"11b: {tag} AR {r['ar']}")
        ars[tag] = dict(ar=r["ar"], ar_vsd=r.get("ar_vsd"),
                        ar_mssd=r["ar_mssd"], ar_mspd=r["ar_mspd"],
                        request_ms=[x * 1e3 for x in r["request_s"]],
                        score_s=r["score_s"])
    del rand
    warm = log_[min(3, len(log_) - 1):]
    step_ms = [m["step_ms"] for m in warm]
    wait_ms = [m["wait_ms"] for m in warm]
    out = dict(steps=FLAGSHIP_STEPS, batch=B, loss_first=losses[0],
               loss_last=losses[-1],
               step_ms_median=statistics.median(step_ms),
               wait_ms_median=statistics.median(wait_ms),
               gt_ar=gt["ar"], eval=ars, wall_s=time.perf_counter() - t0)
    for tag, r in ars.items():
        req = r["request_ms"]
        log(f"11b {tag}: AR {r['ar']:.4f} (vsd {r['ar_vsd']:.4f} mssd "
            f"{r['ar_mssd']:.4f} mspd {r['ar_mspd']:.4f}); request ms first "
            f"{req[0]:.1f} (onboarding), median of the rest "
            f"{statistics.median(req[1:]):.1f}; scorer {r['score_s']:.3f} s")
    log(f"11b: {FLAGSHIP_STEPS} steps at batch {B}, loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, step {out['step_ms_median']:.1f} ms (CUDA "
        f"events, median after 3), data wait {out['wait_ms_median']:.1f} ms; "
        f"GT poses AR {gt['ar']}")
    return out


def accuracy_ism(dev, tmp: Path, tally: LaunchTally, pem_ckpt: str):
    """11c: ISM_STEPS steps each of train_ism_descriptor (use_flash=False)
    and train_tiny_sam (flash=False) on the card, the first batch's
    gradients held to the CPU's; then ism_accuracy_eval on a few frames
    with both segmentors over the trained weights and 11a's PEM."""
    import numpy as np
    import torch

    from sam6d_tpu_torch.models.ism.detector import normalize_rgb
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe
    from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh
    from sam6d_tpu_torch.tools import e2e_synthetic_ar as e2e
    from sam6d_tpu_torch.tools import ism_accuracy_eval as ie
    from sam6d_tpu_torch.tools import train_ism_descriptor as td
    from sam6d_tpu_torch.tools import train_tiny_sam as ts
    from sam6d_tpu_torch.train.checkpoint import save_params

    t0 = time.perf_counter()
    out = {}
    # The descriptor: NT-Xent over 24 objects' view pairs.
    cfg = td.tiny_descriptor_config()
    rng = np.random.RandomState(0)
    pools = td.render_pools(32, 8, cfg.image_size, rng)
    model = td.make_descriptor(cfg, "cpu")
    batch = td.make_batch(pools, rng, 24)
    out["descriptor_grads"] = grads_card_vs_cpu(
        dev, model, lambda m, d: td.nt_xent(
            m.vit(normalize_rgb(torch.as_tensor(batch, device=d)))[0],
            0.1)[0], "11c descriptor (use_flash=False)")
    model = model.to(dev)
    opt, sched = td.make_optimizer(model.parameters(), 3e-4)
    desc_log = [tally.run(td.train_step, model, opt, sched,
                          td.make_batch(pools, rng, 24), 0.1)
                for _ in range(ISM_STEPS)]
    desc_path = save_params(str(tmp / "desc" / td.CKPT_FILE), model.vit)
    # The tiny SAM: SAM's loss over 8 prompts of 8 scenes.
    rng = np.random.RandomState(11)
    meshes = [make_procedural_mesh(rng) for _ in range(16)]
    sam = ts.make_tiny_sam(device="cpu")
    imgs, pts, gts = ts.make_training_batch(meshes, rng, B=8, P=8)
    out["sam_grads"] = grads_card_vs_cpu(
        dev, sam, lambda m, d: ts.sam_loss(
            m, *(torch.as_tensor(x, device=d) for x in (imgs, pts, gts)))[0],
        "11c tiny SAM (flash=False)")
    sam = sam.to(dev)
    opt, sched = td.make_optimizer(sam.parameters(), 3e-4,
                                   ts.cosine_decay(3e-4, ISM_STEPS))
    sam_log = []
    for _ in range(ISM_STEPS):
        b = ts.make_training_batch(meshes, rng, B=8, P=8)
        sam_log.append(tally.run(ts.train_step, sam, opt, sched, *b))
    sam_path = save_params(str(tmp / "sam" / ts.CKPT_FILE), sam)
    require(all(math.isfinite(x[0]) for x in desc_log + sam_log),
            "11c: non-finite training loss")
    out.update(descriptor_loss=[x[0] for x in desc_log],
               sam_loss=[x[0] for x in sam_log])
    del model, sam

    # The ISM -> PEM loop on 2 held-out objects x 3 frames, a bank of 6.
    before = dict(tally.counts)
    objects = e2e.build_multi_dataset(str(tmp / "ism_acc"), n_objects=2,
                                      frames=3)
    out["sam_amg"] = check_tiny_sam_amg(dev, sam_path, ism_frames(objects, 1),
                                        "11c tiny SAM AMG, card against CPU")
    det = ie.make_detector(desc_path, ie.make_segmentor("depth_cc", "", dev),
                           dev)
    tem_poses = tally.run(ie.onboard_bank, det, objects, 6)
    pem = ie.load_pem("smoke", pem_ckpt, dev)
    per = {}
    for kind in ("depth_cc", "tiny_sam"):
        det.segmentor = ie.make_segmentor(kind, sam_path, dev)
        rows, errs, by_obj, times = tally.run(ie.run_frames, det, objects,
                                              tem_poses)
        rec = tally.run(ie.score_segmentor, kind, objects, rows, errs,
                        by_obj, str(tmp / "ism_acc" / kind), pem[:2], dev)
        rec["frame_ms"] = [x * 1e3 for x in times]
        rec.pop("e2e_detail", None)
        per[kind] = rec
        log(f"11c {kind}: selection {rec['object_selection_acc']:.3f} over "
            f"{rec['frames']} frames, template-view error median "
            f"{rec['median_template_view_err_deg']:.1f} deg, e2e AR "
            f"{rec['e2e_ar_no_gt_masks']:.4f}, frame ms median "
            f"{statistics.median(rec['frame_ms']):.1f}")
        require(0.0 <= rec["e2e_ar_no_gt_masks"] <= 1.0,
                f"11c {kind}: AR {rec['e2e_ar_no_gt_masks']}")
    ism_launches = {k: tally.counts[k] - before[k] for k in before}
    for k in (flash_rpe.KERNEL_RPE, flash_rpe.KERNEL_PLAIN,
              decode_tail.KERNEL):
        require(ism_launches[k.name] > 0,
                f"11c: {k.name} not launched in the ISM loop")
    out.update(eval=per, ism_launches=ism_launches,
               wall_s=time.perf_counter() - t0)
    return out


def phase_accuracy(dev, tmp: Path):
    """Phase 11: the accuracy loop; see the module docstring."""
    t0 = time.perf_counter()
    tally = LaunchTally()
    a = accuracy_learnability(dev, tmp, tally)
    b = accuracy_flagship(dev, tmp, tally)
    c = accuracy_ism(dev, tmp, tally, a["ckpt"])
    missing = [k for k, n in tally.counts.items() if n == 0]
    require(not missing, f"phase 11 launched no {missing}")
    out = dict(learnability=a, flagship=b, ism=c, launches=tally.counts,
               wall_s=time.perf_counter() - t0)
    log(f"phase 11 launches {tally.counts}; wall {out['wall_s']:.1f} s "
        f"(11a {a['wall_s']:.1f}, 11b {b['wall_s']:.1f}, "
        f"11c {c['wall_s']:.1f})")
    return out


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
        procrustes,
        scatter_rows,
        two_way,
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
    procrustes_rows = check_procrustes(dev)
    two_way_rows = check_two_way(dev)
    check_tiny_bank(dev)
    check_tiny_ism(dev)
    tiny_fs = check_tiny_fastsam(dev)
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
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        log("== phase 6: the file demo (render -> ISM -> PEM) at full width")
        demo_run = phase_demo(dev, smi, Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        log("== phase 7: released-layout checkpoints through the converter, "
            "and the FastSAM demo, at full width")
        weights = phase_weights(dev, smi, Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        log("== phase 8: PEM training from data at full width")
        train_data = phase_train_data(dev, smi, Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        log("== phase 9: BOP evaluation at full width")
        bop = phase_bop(dev, smi, Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        log("== phase 10: pointnet2, the native library, torch.distributed "
            "on one card, profiling and the debug tap")
        last = phase_last_modules(dev, smi, Path(tmp), request)
        del request
        gc.collect()
        torch.cuda.empty_cache()
        log("== phase 11: the accuracy loop (learnability, full-width AR, "
            "the trained tiny descriptor and tiny SAM, ISM -> PEM AR)")
        accuracy = phase_accuracy(dev, Path(tmp))

    d = last["distributed"]
    phase10_launches = {k: d["runner_launches"].get(k, 0)
                        + d["train_launches"].get(k, 0)
                        for k in set(d["runner_launches"])
                        | set(d["train_launches"])}
    phase10_launches[fps.KERNEL.name] += last["pointnet2"]["k1_launches"]

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
            "launches_fastsam_demo": weights["launches"][kernel.name],
            **({"launches_train_data": train_data["launches"][kernel.name]}
               if kernel.name in train_data["launches"] else {}),
            "launches_phase10": phase10_launches.get(kernel.name, 0),
            "launches_phase11": accuracy["launches"][kernel.name],
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
        # K8 runs on the serving paths alone (the slice's two solves a
        # request); its row is the coarse solve's.
        {"name": procrustes.KERNEL.name, "route": "cuda",
         "source": str(procrustes.KERNEL.source.relative_to(ROOT)),
         "replaces": procrustes.KERNEL.replaces,
         "launches": sl["launches"][procrustes.KERNEL.name],
         "max_abs_err": max(r["max_abs_err"] for r in procrustes_rows),
         **{k: procrustes_rows[0][k] for k in (
             "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "shape")},
         "library": "none: no PyTorch call solves batched weighted "
                    "Procrustes", "by_shape": procrustes_rows},
        # K9 replaces no TPU kernel; its row is the second block's call.
        {"name": two_way.KERNEL.name, "route": "cuda",
         "source": str(two_way.KERNEL.source.relative_to(ROOT)),
         "replaces": two_way.KERNEL.replaces,
         "launches": ism["launches"][two_way.KERNEL.name],
         **{k: two_way_rows[1][k] for k in (
             "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "shape")},
         "library": "none: no PyTorch call computes the chain",
         "by_shape": two_way_rows},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "ptxas": ptxas, "tiny_bf16": tiny_bf16, "tiny_train": tiny_train,
         "tiny_fastsam": tiny_fs, "slice": sl, "ism": ism, "train": train,
         "demo": demo_run, "weights": weights, "train_data": train_data,
         "bop": bop, "last_modules": last, "accuracy": accuracy,
         **report}, indent=1))
    log(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
