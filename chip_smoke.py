#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sam6d_tpu_torch/csrc/` (nvcc, one
process per source, all at once), then:

1. environment: the card's name and power limit, torch and CUDA
   versions, compute capability 9.0, the kernel build;
2. every kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, with CUDA-event timings (kernel and
   plain version in turns, medians), plus the tiny-config template bank
   on the card against the same bank computed on the CPU;
3. the PEM serving slice at full width (default_pem_config, bfloat16,
   random weights from a seed): onboarding of 42 views x 5000 points
   (FPS 210k -> 2048), the template bank, three 1-instance requests and
   one 5-instance request (bucket 8).  The launch counters are zeroed
   just before and read just after; every kernel must have run.
   One more 1-instance request then runs under torch.profiler: the
   device-busy share of its wall time and the kernels that take the
   most device time.

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


def phase_environment():
    import torch

    from sam6d_tpu_torch.ops import _kernels, fps, geo_embed

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
    kernels = [fps.KERNEL, geo_embed.KERNEL]
    t0 = time.perf_counter()
    _kernels.build_all(kernels)
    build_s = time.perf_counter() - t0
    for k in kernels:
        k.lib()
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")
    log(f"built {len(kernels)} kernels in {build_s:.1f} s")
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


def phase_profile(runner, request):
    """torch.profiler over one 1-instance request after two warm ones:
    device-busy share of the request's wall time and the kernels that
    take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    inp = request(1)
    for _ in range(2):
        runner.infer(inp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.infer(inp)
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
    log(f"profiled 1-instance request: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{n_device} device kernels and copies")
    for r in top[:12]:
        log(f"  {r['device_ms']:8.3f} ms  {r['calls']:5d}x  {r['name']}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_events=n_device, top=top)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import sam6d_tpu_torch  # noqa: F401  (fails outside the repository)
    from sam6d_tpu_torch.ops import fps, geo_embed

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("== phase 1: environment and build")
    smi, name, build_s = phase_environment()
    log("== phase 2: kernels against their plain versions")
    fps_rows = check_fps(dev)
    geo_rows = check_geo_embed(dev)
    check_tiny_bank(dev)
    log("== phase 3: PEM serving slice at full width")
    runner, request, sl = phase_slice(dev)
    sl["profile"] = phase_profile(runner, request)

    def entry(kernel, rows, main_row):
        main = rows[main_row]
        return {
            "name": kernel.name, "route": "cuda",
            "source": str(kernel.source.relative_to(ROOT)),
            "replaces": kernel.replaces,
            "launches": sl["launches"][kernel.name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "shape": main["shape"], "by_shape": rows,
        }

    # The per-request shapes: FPS of one instance (2048 -> 196) and the
    # bf16 embedding of one instance.
    report = {"kernels": [entry(fps.KERNEL, fps_rows, 0),
                          entry(geo_embed.KERNEL, geo_rows, 0)]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
         "build_s": build_s, "slice": sl, **report}, indent=1))
    log(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
