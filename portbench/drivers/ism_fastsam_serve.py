"""ISM serving with FastSAM in a closed loop: `ISMDetector(cfg,
FastSAM(...), DescriptorModel(...)).detect(image, depth, K)` on 480 x
640 RGB-D frames, one at a time, each sent when the previous frame's
detections are back on the host.  The detector is built as the file
demo builds it for `--segmentor_model fastsam`: FastSAM from
`cfg.fastsam` in float32 (TF32 off, the port's setting), DINOv2 in the
configuration's compute dtype with float32 parameters.

Set-up: the weights drawn on the card (FastSAM's, `fastsam_judge.weights`;
DINOv2's as `ism_sam_h` draws them), the detector, onboarding of the
traffic's objects, the frames built from the seed, and warm-up frames.
The window serves the frames in order, cycling, for --seconds (with
--trace 1: the traffic's `trace_frames`, once without the profiler and
once under it, with `utils/timer.StageTimer(sync=True)` passed to
`detect`).  Then the program is freed and the reference judges the
frames `pem_traffic.check_frames` picks (`fastsam_judge`).
"""

from __future__ import annotations

import time

from portbench.drivers import ism_serve
from portbench.harness import (configs, fastsam_judge, guard, ism_judge,
                               ism_traffic)
from portbench.harness.pem_traffic import among, check_frames
from portbench.harness.precision import tf32
from portbench.harness.record import Record


def build_program(cc: dict, cfg, dev):
    """The port's detector with the benchmark's weights."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.fastsam import FASTSAM_SCALES, FastSAM
    from sam6d_tpu_torch.models.layers import cast_dense_weights

    f = cfg.fastsam
    if FASTSAM_SCALES[f.scale] != fastsam_judge.scale_of(cc):
        raise ValueError(f"FastSAM-{f.scale} is {FASTSAM_SCALES[f.scale]} in "
                         "the program, not the configuration's "
                         f"{fastsam_judge.scale_of(cc)}")
    seg = FastSAM(img_size=f.img_size, conf=f.conf_threshold,
                  iou=f.iou_threshold, max_det=f.max_det, scale=f.scale,
                  device=dev)
    seg.net.load_state_dict(fastsam_judge.weights(cc, dev)[0])
    with torch.device(dev):
        desc = DescriptorModel(cfg.descriptor,
                               dtype=configs.dtype(cc["compute_dtype"]))
    with torch.device("meta"):
        rd = ism_judge.DescriptorModel(cfg.descriptor)
    desc.load_state_dict(ism_judge.draw_state_dict(
        rd, cc["weights_seed"] + 1, dev))
    return ISMDetector(cfg, seg, cast_dense_weights(desc.eval()), device=dev)


class Capture:
    """What the judge needs of a frame, kept while `on` is set: the
    network's input, outputs and prototypes (a forward hook on `net`),
    the candidates FastSAM keeps (its best anchors' boxes and scores) and
    its proposals, by wrappers on the segmentor's own methods, which
    return what the methods return."""

    def __init__(self, seg):
        self.on, self.taken, self.seg = None, {}, seg
        self.hook = seg.net.register_forward_hook(self._net)
        candidates, generate = seg.candidates, seg.generate_masks

        def cand(*a, **k):
            out = candidates(*a, **k)
            if self.on is not None:
                self._get()["candidates"] = out[:2]
            return out

        def gen(*a, **k):
            out = generate(*a, **k)
            if self.on is not None:
                self._get()["proposals"] = out
            return out

        seg.candidates, seg.generate_masks = cand, gen

    def _get(self) -> dict:
        return self.taken.setdefault(self.on, {})

    def _net(self, _m, inp, out):
        if self.on is not None:
            self._get().update(input=inp[0], outs=out[0], proto=out[1])

    def program(self, i: int, det_out, counts: dict) -> dict | None:
        """The judge's view of frame i, once served and kept whole."""
        t = self.taken.get(i, {})
        if det_out is None or not {"outs", "candidates", "proposals"} <= \
                set(t):
            return None
        boxes, conf = t["candidates"]
        return {"input": t["input"], "outs": t["outs"], "proto": t["proto"],
                "cand_boxes": boxes, "cand_conf": conf,
                "proposals": t["proposals"], "sized": counts.get("sized", 0),
                "dets": ism_serve.dets_dict(det_out)}

    def close(self):
        self.hook.remove()
        del self.seg.candidates, self.seg.generate_masks


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Record:
    import torch

    from sam6d_tpu_torch.utils.timer import StageTimer

    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_serve.ism_configs(cc)
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

    cap = Capture(det.segmentor)
    rec = Record(cell=cell.name, seed=seed, trace=trace)
    served, progs, stages = [], {}, {}
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
        counts = dict(det.last_counts)
        served.append({"frame": i, "ms": (b - a) * 1e3, "ok": d is not None,
                       "proposals": counts.get("sized", 0),
                       "bucket": counts.get("bucket", 0)})
        if timer is not None:
            for name, ms in timer.report().items():
                stages.setdefault(name, []).append(ms)
        if cap.on is not None:
            p = cap.program(i, d, counts)
            if p is not None:
                progs[i] = p
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
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    rec.profile = prof
    if trace:
        rec.extra["calls"] = {"flash": kernel_calls(cfg, served)}
    guard.check_no_jax("after the window")
    del det, cap
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    a = time.perf_counter()
    per = judge(cc, rcfg, tem, frames, checked, progs, dev, rec)
    if trace:
        rec.flops_per_frame = flops_per_frame(cc, rcfg, dev, served)
    rec.check_s = time.perf_counter() - a
    rec.judged = len(per)
    rec.extra["detections"] = [p["detections"] for p in per]
    rec.numbers = fastsam_judge.worst(per) if per else {}
    rec.numbers["proposals"] = (sum(f["proposals"] for f in served)
                                / max(1, len(served)))
    rec.limits = cell.limits["numbers"]
    return rec


def judge(cc, rcfg, tem, frames, checked, progs, dev, rec=None) -> list:
    """The reference's numbers of each checked frame, float32, TF32 off."""
    per = []
    with tf32(False):
        net = fastsam_judge.network(cc, dev)
        desc = fastsam_judge.descriptor(cc, rcfg, dev)
        bank = ism_judge.onboard(desc, tem, dev)
        for i in checked:
            if i not in progs:
                if rec is not None:
                    rec.check_errors.append(f"judged frame {i} was not "
                                            "served")
                continue
            try:
                per.append(fastsam_judge.judge_frame(
                    net, desc, bank, rcfg, frames[i], progs[i]))
            except ValueError as exc:
                if rec is None:
                    raise
                rec.check_errors.append(f"frame {i}: {exc}")
    return per


def kernel_calls(cfg, served) -> list:
    """The shapes of the K5 calls of the traced frames: DINOv2 runs each
    frame's descriptor bucket through its blocks, each block one K5 call
    on (bucket x heads, tokens, head width), bf16."""
    d = cfg.descriptor
    n = (d.image_size // d.patch_size) ** 2 + 1
    hd = d.embed_dim // d.num_heads
    return [(f["bucket"] * d.num_heads, n, hd, 2)
            for f in served if f["bucket"] for _ in range(d.depth)]


def flops_per_frame(cc, rcfg, dev, served) -> list:
    """The reference's operations for each traced frame, as [float32,
    bf16]: FastSAM's network at the input size (FlopCounterMode, once)
    and DINOv2-L once for each proposal that reached the descriptor
    (padding rows not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    S = rcfg.fastsam.img_size
    with torch.device("meta"):
        net = fastsam_judge.ref.YOLOv8Seg(*fastsam_judge.scale_of(cc))
        desc = ism_judge.DescriptorModel(rcfg.descriptor)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        net(torch.zeros(1, S, S, 3, device="meta"))
    f_net = float(fc.get_total_flops())
    C = rcfg.descriptor.image_size
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        desc.compute_cls_and_patch(
            torch.zeros(1, C, C, 3, device="meta"),
            torch.ones(1, C, C, dtype=torch.bool, device="meta"))
    f_crop = float(fc.get_total_flops())
    return [[f_net, f["proposals"] * f_crop] for f in served]


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control in the program's place on the frames a run of this
    seed judges: the reference FastSAM network with TF32 operands and
    products inside the port's FastSAM selection, and the reference
    DINOv2-L in bfloat16 with float8 Dense products, in the port's
    detector; judged as a run judges the program."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.fastsam import FastSAM

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_serve.ism_configs(cc)
    tem = ism_traffic.templates(tr, cfg.descriptor.image_size,
                                cfg.pointcloud_sample_num)
    frames = ism_traffic.frames(tr, seed)
    checked = check_frames([{"n": 0}] * len(frames), tr["check_frames"],
                           among(tr, False), seed)
    f = cfg.fastsam
    progs = {}
    with tf32(True):
        seg = FastSAM(img_size=f.img_size, conf=f.conf_threshold,
                      iou=f.iou_threshold, max_det=f.max_det, scale=f.scale,
                      device=dev)
        seg.net = fastsam_judge.network(cc, dev, control=True)
        det = ISMDetector(cfg, seg, fastsam_judge.descriptor(
            cc, rcfg, dev, control=True), device=dev)
        det.onboard_templates(tem["images"], tem["masks"], tem["poses"],
                              tem["pointcloud"])
        cap = Capture(seg)
        for i in checked:
            cap.on = i
            p = cap.program(i, det.detect(*frames[i]), det.last_counts)
            if p is not None:
                progs[i] = p
        cap.close()
        del det, seg, cap
    return fastsam_judge.worst(judge(cc, rcfg, tem, frames, checked, progs,
                                     dev))
