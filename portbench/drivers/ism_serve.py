"""ISM serving in a closed loop: `ISMDetector.detect(image, depth, K)` on
480 x 640 RGB-D frames, one at a time, each sent when the previous
frame's detections are back on the host.

Set-up: SAM and DINOv2 with seeded weights drawn on the card, the
detector, onboarding of the traffic's objects, the frames built from the
seed, and warm-up frames.  The window serves the frames in order,
cycling, for --seconds (with --trace 1: the traffic's `trace_frames`,
once without the profiler and once under it, with
`utils/timer.StageTimer(sync=True)` passed to `detect`).  Then the
program is freed and the reference judges the frames
`pem_traffic.check_frames` picks (`ism_judge`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.harness import configs, guard, ism_judge, ism_traffic
from portbench.harness.pem_traffic import among, check_frames
from portbench.harness.precision import tf32
from portbench.harness.record import Record


def ism_configs(cc: dict):
    """The port's and the reference's ISMConfig from the config file,
    with the segmentor and detector thresholds the file opens."""
    import portbench.reference.config as rconfig
    from sam6d_tpu_torch import config as pconfig

    return (configs.build(pconfig.ISMConfig, cc["ism"]),
            configs.build(rconfig.ISMConfig, cc["ism"]))


def sam_options(cc: dict) -> dict:
    """SAM's input size and encoder widths where the config file sets
    them (the benchmark's own CPU tests; the cells keep SAM's own)."""
    return {k: cc[k] for k in ("img_size", "encoder_kwargs") if k in cc}


def build_program(cc: dict, cfg, dev):
    """The port's detector with the benchmark's weights."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam.model import SAM
    from sam6d_tpu_torch.models.layers import cast_dense_weights

    dtype = configs.dtype(cc["compute_dtype"])
    with torch.device(dev):
        sam = SAM(cfg.segmentor.model_type, dtype=dtype, device=dev,
                  **sam_options(cc))
        desc = DescriptorModel(cfg.descriptor, dtype=dtype)
    with torch.device("meta"):
        rs, rd = (ism_judge.SAM(cfg.segmentor.model_type, device="meta",
                                **sam_options(cc)),
                  ism_judge.DescriptorModel(cfg.descriptor))
    sam.load_state_dict(ism_judge.draw_state_dict(
        rs, cc["weights_seed"], dev, rel_pos_std=cc["rel_pos_std"]))
    desc.load_state_dict(ism_judge.draw_state_dict(
        rd, cc["weights_seed"] + 1, dev))
    sam = cast_dense_weights(sam.eval())
    desc = cast_dense_weights(desc.eval())
    return ISMDetector(cfg, SamAutomaticMaskGenerator(sam, cfg.segmentor),
                       desc, device=dev)


def dets_dict(d) -> dict:
    ex = d.extras or {}
    n = len(d)
    return {"masks": np.asarray(d.masks, bool), "boxes": np.asarray(d.boxes),
            "scores": np.asarray(d.scores if n else np.zeros(0)),
            "object_ids": np.asarray(d.object_ids if n else np.zeros(0, int)),
            "semantic_score": np.asarray(ex.get("semantic_score", [])),
            "appe_score": np.asarray(ex.get("appe_score", [])),
            "best_template": np.asarray(ex.get("best_template", []))}


class Capture:
    """Forward hooks that keep the SAM encoder's embedding and the mask
    decoder's output tokens of a frame while `on` is set."""

    def __init__(self, sam):
        self.on, self.taken = None, {}
        self.hooks = [sam.encoder.register_forward_hook(self._enc),
                      sam.decoder.transformer.register_forward_hook(self._dec)]

    def _enc(self, _m, _i, out):
        if self.on is not None:
            self.taken.setdefault(self.on, {"tokens": []})["embedding"] = out

    def _dec(self, _m, _i, out):
        if self.on is not None:
            self.taken.setdefault(self.on, {"tokens": []})["tokens"].append(
                out[0])

    def close(self):
        for h in self.hooks:
            h.remove()


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Record:
    import torch

    from sam6d_tpu_torch.ops import decode_tail, flash_rpe
    from sam6d_tpu_torch.utils.timer import StageTimer

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_configs(cc)
    tem = ism_traffic.templates(tr, cfg.descriptor.image_size,
                                cfg.pointcloud_sample_num)
    frames = ism_traffic.frames(tr, seed)
    checked = check_frames([{"n": 0}] * len(frames), tr["check_frames"],
                           among(tr, trace), seed)
    det = build_program(cc, cfg, dev)
    det.onboard_templates(tem["images"], tem["masks"], tem["poses"],
                          tem["pointcloud"])
    for i in range(tr["warm_frames"]):
        det.detect(*frames[len(frames) - 1 - i])
    sync()
    guard.check_no_jax("after set-up")

    cap = Capture(det.segmentor.sam)
    kernels = (flash_rpe.KERNEL_RPE, flash_rpe.KERNEL_PLAIN, decode_tail.KERNEL)
    launches0 = {k.name: k.launches for k in kernels}
    rec = Record(cell=cell.name, seed=seed, trace=trace)
    served, outs, stages = [], {}, {}
    limit = tr["trace_frames"] if trace else None
    prof = None
    if trace:
        from portbench.harness.trace import Profile, plain_seconds

        def serve(k):
            det.detect(*frames[k % len(frames)])
        rec.extra["plain_s"] = plain_seconds(serve, limit, sync)
        prof = Profile().__enter__()
    rec.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    k = 0
    while True:
        i = k % len(frames)
        cap.on = i if (k < len(frames) and i in checked) else None
        timer = StageTimer(dev, sync=True) if trace else None
        a = time.perf_counter()
        try:
            d = det.detect(*frames[i], timer=timer)
        except Exception as exc:  # a failed frame counts, and misses
            rec.failures.append(repr(exc))
            d = None
        b = time.perf_counter()
        served.append({"frame": i, "ms": (b - a) * 1e3, "ok": d is not None,
                       "proposals": det.last_counts.get("sized", 0)})
        if timer is not None:
            for name, ms in timer.report().items():
                stages.setdefault(name, []).append(ms)
        if cap.on is not None and d is not None:
            outs[i] = dets_dict(d)
        k += 1
        if (limit is not None and k >= limit) or \
                (limit is None and b - start >= seconds):
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    sync()
    rec.window_s = time.perf_counter() - start
    cap.on = None
    cap.close()
    rec.frames = served
    rec.stage_ms = stages
    rec.launches = {k.name: k.launches - launches0[k.name] for k in kernels}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    rec.profile = prof
    if trace:
        rec.extra["calls"] = kernel_calls(det, served)
    guard.check_no_jax("after the window")

    progs = {}
    for i in checked:
        t = cap.taken.get(i)
        if i in outs and t and "embedding" in t:
            progs[i] = {"embedding": t["embedding"].float(),
                        "tokens": torch.cat(t["tokens"]).float(),
                        "dets": outs[i]}
    del det, cap, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    a = time.perf_counter()
    with tf32(False):
        sam, desc = ism_judge.models(cc, rcfg, dev)
        bank = ism_judge.onboard(desc, tem, dev)
        per = []
        for i in checked:
            if i not in progs:
                rec.check_errors.append(f"judged frame {i} was not served")
                continue
            per.append(ism_judge.judge_frame(sam, desc, bank, rcfg, frames[i],
                                             progs[i]))
        if trace:
            rec.flops_per_frame = flops_per_frame(sam, desc, rcfg, frames[0],
                                                  served)
    rec.check_s = time.perf_counter() - a
    rec.judged = len(per)
    rec.extra["detections"] = [p["detections"] for p in per]
    rec.numbers = ism_judge.worst(per) if per else {}
    rec.limits = cell.limits["numbers"]
    return rec


def kernel_calls(det, served) -> dict:
    """The shapes of the K4 and K6 calls of the traced frames: each SAM
    block one K4 call (windowed: the 14 x 14 windows of the zero-padded
    token grid; global: the whole grid), each frame one K6 call over
    every grid prompt's keys."""
    sam = det.segmentor.sam
    enc = sam.encoder
    g = sam.input_size // 16
    calls_k4, calls_k6 = [], []
    es = 2 if sam.dtype.itemsize == 2 else 4
    for _ in served:
        for i in range(enc.depth):
            at = getattr(enc, f"blocks_{i}").attn
            hd = at.dim // at.num_heads
            if at.window_size > 0:
                nw = -(-g // at.window_size) ** 2
                calls_k4.append((nw * at.num_heads, at.window_size,
                                 at.window_size, hd, es))
            else:
                calls_k4.append((at.num_heads, g, g, hd, es))
        P = det.cfg.segmentor.points_per_side ** 2
        calls_k6.append((P, g * g, es))
    return {"flash_rpe": calls_k4, "decode_tail": calls_k6}


def flops_per_frame(sam, desc, rcfg, frame, served) -> list:
    """The reference's operations for each traced frame: the SAM encoder
    and every grid prompt's decode (FlopCounterMode, once), and DINOv2-L
    for each proposal that reached the descriptor (once a crop, times the
    frame's proposals; padding rows not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    seg = rcfg.segmentor
    with FlopCounterMode(display=False) as fc:
        ism_judge.segment(sam, seg, frame[0])
    f_sam = float(fc.get_total_flops())
    S = rcfg.descriptor.image_size
    x = torch.zeros(1, S, S, 3, device=sam.device)
    m = torch.ones(1, S, S, dtype=torch.bool, device=sam.device)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        desc.compute_cls_and_patch(x, m)
    f_crop = float(fc.get_total_flops())
    return [f_sam + f["proposals"] * f_crop for f in served]


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control in the program's place on the frames a run of this
    seed judges: the reference SAM and DINOv2-L in bfloat16 with float8
    Dense products and TF32 geometry, driven by the port's own generator
    and detector (unfused decode: `fused_tail=False`, no kernel), judged
    as a run judges the program."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_configs(cc)
    cfg = dataclasses.replace(cfg, segmentor=dataclasses.replace(
        cfg.segmentor, fused_tail=False))
    tem = ism_traffic.templates(tr, cfg.descriptor.image_size,
                                cfg.pointcloud_sample_num)
    frames = ism_traffic.frames(tr, seed)
    checked = check_frames([{"n": 0}] * len(frames), tr["check_frames"],
                           among(tr, False), seed)
    per = []
    with tf32(True):
        csam, cdesc = ism_judge.models(cc, rcfg, dev, control=True)
        det = ISMDetector(cfg, SamAutomaticMaskGenerator(csam, cfg.segmentor),
                          cdesc, device=dev)
        det.onboard_templates(tem["images"], tem["masks"], tem["poses"],
                              tem["pointcloud"])
        cap = Capture(csam)
        progs = {}
        for i in checked:
            cap.on = i
            d = det.detect(*frames[i])
            t = cap.taken[i]
            progs[i] = {"embedding": t["embedding"].float(),
                        "tokens": torch.cat(t["tokens"]).float(),
                        "dets": dets_dict(d)}
        cap.close()
        del det, csam, cdesc, cap
    with tf32(False):
        sam, desc = ism_judge.models(cc, rcfg, dev)
        bank = ism_judge.onboard(desc, tem, dev)
        for i in checked:
            per.append(ism_judge.judge_frame(sam, desc, bank, rcfg, frames[i],
                                             progs[i]))
    return ism_judge.worst(per)
