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
   the same function, that call's time as a yardstick; plus the
   tiny-config PEM template bank, a tiny-config ISM frame (float32) and
   bfloat16 SAM-encoder and DINOv2 blocks at the full model's head dims
   on the card against the same computed on the CPU;
3. the PEM serving slice at full width (default_pem_config, bfloat16,
   random weights from a seed): onboarding of 42 views x 5000 points
   (FPS 210k -> 2048), the template bank, three 1-instance requests and
   one 5-instance request (bucket 8).  The launch counters are zeroed
   just before and read just after; every kernel of the path must have
   run.  One more 1-instance request then runs under torch.profiler;
4. the ISM serving slice at full width (default_ism_config: SAM ViT-H at
   1024^2, the 32 x 32 AMG grid, DINOv2-L at 224^2, bfloat16, random
   weights from a seed): onboarding of one object's 42 template views,
   then three 480 x 640 frames of a synthetic scene, one at the default
   thresholds and two with the IoU, stability and confidence thresholds
   opened.  Counters zeroed before and read after, as in phase 3; one
   more frame runs under torch.profiler.

Any failure exits non-zero.  The last lines are the nvidia-smi name and
power limit, {"kernels": [...]}, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
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


def time_in_turns(fns: dict, reps: int, warmup: int = 1):
    """Median ms of each callable, run in turns a, b, b, a, ...; CUDA
    events around every call."""
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
            fns[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in times.items()}


def all_kernels():
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe, fps, geo_embed

    return [fps.KERNEL, geo_embed.KERNEL, flash_rpe.KERNEL_RPE,
            flash_rpe.KERNEL_PLAIN, decode_tail.KERNEL]


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
    for k in kernels:
        k.lib()
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")
    log(f"built {len(kernels)} kernels from "
        f"{len({k.source for k in kernels})} sources in {build_s:.1f} s")
    return smi, name, build_s


def check_fps(dev):
    import torch

    from sam6d_tpu_torch.ops import fps

    rows = []
    for B, N, npoint, reps in ((1, 2048, 196, 20), (8, 2048, 196, 20),
                               (1, 210000, 2048, 4)):
        g = torch.Generator(device=dev).manual_seed(N + B)
        pts = torch.rand(B, N, 3, generator=g, device=dev) * 0.2 - 0.1
        got = fps.fps_cuda(pts, npoint)
        want = fps.fps_plain(pts, npoint)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        require(err == 0, f"fps {B}x{N}->{npoint}: indices differ")
        t = time_in_turns({"kernel": lambda: fps.fps_cuda(pts, npoint),
                           "plain": lambda: fps.fps_plain(pts, npoint)}, reps)
        # Input read once, indices written once; ~10 float32 operations
        # per point and step (3 sub, 3 mul, 2 add, min, compare).
        b_ms, b_by = bound(B * N * 12 + B * npoint * 8,
                           B * (npoint - 1) * N * 10, "float32")
        rows.append(dict(shape=f"({B},{N},3)->{npoint}", max_abs_err=err,
                         ms=t["kernel"], plain_ms=t["plain"], bound_ms=b_ms,
                         bound_by=b_by))
        log(f"fps {rows[-1]}")
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
        for B in (1, 8):
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
            t = time_in_turns({
                "kernel": lambda: geo_embed.geo_embed_maxk_cuda(*args),
                "plain": lambda: geo_embed.geo_embed_maxk_plain(*args),
            }, reps=10)
            es = torch.finfo(dtype).bits // 8
            pairs = B * N * N
            nbytes = pairs * (4 + 12 + d * es) + 68 * d * es + d * 4
            flops = pairs * (2 * (40 + 3 * 28) * d + 3 * (40 + 3 * 28))
            b_ms, b_by = bound(nbytes, flops, str(dtype).split(".")[-1])
            rows.append(dict(shape=f"B={B},N={N},d={d},{dtype}",
                             max_abs_err=err, ms=t["kernel"],
                             plain_ms=t["plain"], bound_ms=b_ms,
                             bound_by=b_by, dtype=str(dtype)))
            log(f"geo_embed {rows[-1]}")
    return rows


def check_tiny_bank(dev):
    """Tiny-config template bank (float32) on the card (kernels) against
    the same bank on the CPU (plain versions and the unfused path)."""
    import numpy as np
    import torch

    from sam6d_tpu_torch import config as c
    from sam6d_tpu_torch.models.pem.model import PEM
    from sam6d_tpu_torch.params import init_random_

    cfg = c.PEMConfig(
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
    )
    model = init_random_(PEM(cfg, device="cpu").eval(),
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
        f"{onboard_launches}")
    for inp, ms, lc in zip(requests, req_ms, req_launches):
        n = len(inp["pts"])
        log(f"request of {n} instance(s) (bucket {runner.bucket_for(n)}): "
            f"{ms:.2f} ms, launches {lc}")
    log(f"main-path launches {launches}; outputs finite, |det R - 1| < 1e-2")
    return runner, request, dict(
        onboard_ms=onboard_ms, onboard_launches=onboard_launches,
        request_ms=req_ms, request_launches=req_launches, launches=launches)


def check_attention(dev):
    """K4 at the SAM encoder's windowed (400, 196, 80) and global
    (16, 4096, 80) shapes and K5 at the DINOv2-L shapes (128 and 4096
    batch-heads of 257 x 64), bfloat16.  Yardstick: one call of
    F.scaled_dot_product_attention on the same inputs (for K4 with the
    dense (BH, N, N) rel-pos bias as attn_mask, built beforehand and not
    timed)."""
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
             ("plain", 128, 1, 257, 64, 10), ("plain", 4096, 1, 257, 64, 5))
    for kind, BH, h, w, d, reps in cases:
        N = h * w
        g = torch.Generator(device=dev).manual_seed(BH + N)
        q, k, v = (torch.randn(BH, N, d, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        # SDPA takes (batch, heads, L, E): the batch-heads as heads.
        q4, k4, v4 = (t[None] for t in (q, k, v))
        if kind == "rpe":
            rh = (torch.randn(2 * h - 1, d, generator=g, device=dev)
                  * 0.1).bfloat16()
            rw = (torch.randn(2 * w - 1, d, generator=g, device=dev)
                  * 0.1).bfloat16()
            kern = lambda: fr.flash_rpe_attention_cuda(q, k, v, rh, rw,
                                                       (h, w))
            plain = lambda: fr.rpe_attention_plain(q, k, v, rh, rw, (h, w))
            qrh, qrw = fr.rel_pos_tables(q, rh, rw, (h, w))
            mask = (qrh[..., :, None] + qrw[..., None, :]).reshape(
                1, BH, N, N).bfloat16()
            lib = lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask)
            # q k^T and P v, the bias tables' two products, the bias add.
            flops = 4 * BH * N * N * d + 2 * BH * N * d * (2 * h + 2 * w - 2) \
                + 2 * BH * N * N
            nbytes = 4 * BH * N * d * 2 + (2 * h + 2 * w - 2) * d * 2
            shape = f"({BH},{N},{d}) bf16, grid {h}x{w}"
        else:
            kern = lambda: fr.flash_attention_cuda(q, k, v)
            plain = lambda: fr.attention_plain(q, k, v)
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)
            flops = 4 * BH * N * N * d
            nbytes = 4 * BH * N * d * 2
            shape = f"({BH},{N},{d}) bf16"
        got, want = kern().float(), plain().float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        out_std = float(want.std())
        atol = 0.05 * out_std
        require(bool(((got - want).abs() <= atol + rtol * want.abs()).all()),
                f"flash {kind} {shape}: max abs err {err} (atol {atol}, "
                f"rtol {rtol})")
        t = time_in_turns({"kernel": kern, "plain": plain, "library": lib},
                          reps)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        rows[kind].append(dict(shape=shape, max_abs_err=err, out_std=out_std,
                               atol=atol, rtol=rtol, ms=t["kernel"],
                               plain_ms=t["plain"], library_ms=t["library"],
                               bound_ms=b_ms, bound_by=b_by))
        log(f"flash_{kind} {rows[kind][-1]}")
        del got, want
    return rows["rpe"], rows["plain"]


def check_decode_tail(dev):
    """K6 at P = 64 and at the AMG's full shape, keys (1024, 4096, 256)
    bf16.  The plain version materializes every stage (several GB in one
    call at P = 1024), so at P = 1024 it runs as 16 calls of 64 prompts,
    each prompt's statistics being its own.  No PyTorch call computes
    these statistics."""
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
        del got, want, diff
        t = time_in_turns({"kernel": kern, "plain": plain}, reps)
        # Per token: stage 1 (256 x 256), stage 2 (4 x 64 x 128) and the
        # contraction (4 x 12 x 32) multiply-adds, plus ~10 operations
        # for each LayerNorm / GELU value (256 + 512); float32.
        tokens = P * 4096
        flops = tokens * (2 * (256 * 256 + 4 * 64 * 128 + 4 * 12 * 32)
                          + 10 * (256 + 512))
        nbytes = tokens * 256 * 2 + P * (96 + 96) * 4 + (256 * 256 + 64
                                                         * 128 + 896) * 4
        b_ms, b_by = bound(nbytes, flops, "float32")
        rows.append(dict(shape=f"P={P}, keys ({P},4096,256) bf16",
                         max_abs_err=err, ms=t["kernel"],
                         plain_ms=t["plain"], plain_calls=P // 64,
                         bound_ms=b_ms, bound_by=b_by))
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
    kernels = all_kernels()[2:]
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
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_events=n_device, top=top)


def phase_profile(runner, request):
    """One 1-instance PEM request under torch.profiler, after two warm
    ones."""
    inp = request(1)
    return profile_once(lambda: runner.infer(inp), "1-instance request",
                        warm=2)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import sam6d_tpu_torch  # noqa: F401  (fails outside the repository)
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe, fps, geo_embed

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("== phase 1: environment and build")
    smi, name, build_s = phase_environment()
    log("== phase 2: kernels against their plain versions")
    fps_rows = check_fps(dev)
    geo_rows = check_geo_embed(dev)
    rpe_rows, flash_rows = check_attention(dev)
    tail_rows = check_decode_tail(dev)
    check_tiny_bank(dev)
    check_tiny_ism(dev)
    tiny_bf16 = check_tiny_bf16(dev)
    log("== phase 3: PEM serving slice at full width")
    runner, request, sl = phase_slice(dev)
    sl["profile"] = phase_profile(runner, request)
    del runner
    torch.cuda.empty_cache()
    log("== phase 4: ISM serving slice at full width")
    frame, ism = phase_ism(dev)
    ism["profile"] = profile_once(frame, "ISM frame (opened thresholds)")

    def entry(kernel, rows, main_row, launches, library=None):
        main = rows[main_row]
        return {
            "name": kernel.name, "route": "cuda",
            "source": str(kernel.source.relative_to(ROOT)),
            "replaces": kernel.replaces,
            "launches": launches[kernel.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["max_abs_err"] is not None),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            "library": library, "shape": main["shape"], "by_shape": rows,
        }

    # Main rows: FPS of one instance (2048 -> 196) and the bf16 embedding
    # of one instance (PEM request); a windowed SAM block (28 of the 32
    # K4 launches of a frame); DINOv2-L at a bucket of 256 proposals; the
    # AMG tail over all 1024 prompts, the plain version there in 16 calls
    # of 64 prompts.
    report = {"kernels": [
        entry(fps.KERNEL, fps_rows, 0, sl["launches"],
              "none: no PyTorch call computes farthest point sampling"),
        entry(geo_embed.KERNEL, geo_rows, 0, sl["launches"],
              "none: no single PyTorch call computes the Chebyshev "
              "embedding with its max over k"),
        entry(flash_rpe.KERNEL_RPE, rpe_rows, 0, ism["launches"],
              "F.scaled_dot_product_attention with the dense (BH, N, N) "
              "rel-pos bias as attn_mask, built beforehand, not timed"),
        entry(flash_rpe.KERNEL_PLAIN, flash_rows, 1, ism["launches"],
              "F.scaled_dot_product_attention"),
        dict(entry(decode_tail.KERNEL, tail_rows, 1, ism["launches"],
                   "none: no PyTorch call computes the tail statistics"),
             plain_note="plain version in 16 calls of 64 prompts (one "
                        "call materializes several GB at P=1024)"),
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "tiny_bf16": tiny_bf16, "slice": sl, "ism": ism,
         **report}, indent=1))
    log(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
