"""ISM serving with SAM 2.1 Hiera-L in a closed loop:
`ISMDetector(cfg, SamAutomaticMaskGenerator(sam2, cfg.segmentor),
DescriptorModel(...)).detect(image, depth, K)` on 480 x 640 RGB-D
frames, one at a time, each sent when the previous frame's detections
are back on the host.  The detector is built as the file demo builds it
for `--segmentor_model sam2`: SAM 2 and DINOv2 in the configuration's
compute dtype with float32 parameters (`cast_dense_weights`), as
`ism_serve` builds SAM.

Set-up: the weights drawn on the card (SAM 2's, `sam2_judge.draw`;
DINOv2's as `ism_sam_h` draws them), the detector, onboarding of the
traffic's objects, the frames built from the seed, and warm-up frames.
The window serves the frames in order, cycling, for --seconds (with
--trace 1: the traffic's `trace_frames`, once without the profiler and
once under it, with `utils/timer.StageTimer(sync=True)` passed to
`detect`).  Then the program is freed and the reference judges the
frames `pem_traffic.check_frames` picks (`sam2_judge`).
"""

from __future__ import annotations

import dataclasses
import time

from portbench.drivers import ism_serve
from portbench.harness import configs, guard, ism_judge, ism_traffic, sam2_judge
from portbench.harness.pem_traffic import among, check_frames
from portbench.harness.precision import tf32
from portbench.harness.record import Record


def build_program(cc: dict, cfg, dev):
    """The port's detector with the benchmark's weights."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator
    from sam6d_tpu_torch.models.ism.sam2.model import SAM2
    from sam6d_tpu_torch.models.layers import cast_dense_weights

    dtype = configs.dtype(cc["compute_dtype"])
    opts = sam2_judge.trunk_options(cc)
    with torch.device(dev):
        sam = SAM2(cfg.segmentor.model_type, dtype=dtype, device=dev, **opts)
        desc = DescriptorModel(cfg.descriptor, dtype=dtype)
    with torch.device("meta"):
        rs = sam2_judge.ref.SAM2(device="meta", **opts)
        rd = ism_judge.DescriptorModel(cfg.descriptor)
    sam.load_state_dict(sam2_judge.draw(rs, cc["weights_seed"], dev))
    desc.load_state_dict(ism_judge.draw_state_dict(
        rd, cc["weights_seed"] + 1, dev))
    sam = cast_dense_weights(sam.eval())
    desc = cast_dense_weights(desc.eval())
    return ISMDetector(cfg, SamAutomaticMaskGenerator(sam, cfg.segmentor),
                       desc, device=dev)


class Capture:
    """What the judge needs of a frame, kept while `on` is set: SAM 2's
    encoding (a wrapper on the model's `encode`, which returns what
    `encode` returns), the two-way transformer's output tokens (a forward
    hook) and every candidate's stability and box from K6's statistics (a
    wrapper on the generator's `fused_candidates`, which returns what it
    returns)."""

    def __init__(self, sam):
        from sam6d_tpu_torch.models.ism.sam import amg

        self.on, self.taken, self.sam = None, {}, sam
        encode = sam.encode
        self.amg, self.candidates = amg, amg.fused_candidates

        def fused(*a, **k):
            out = self.candidates(*a, **k)
            if self.on is not None:
                self._get().update(stability=out[3], boxes=out[4])
            return out

        amg.fused_candidates = fused

        def enc(*a, **k):
            out = encode(*a, **k)
            if self.on is not None:
                self._get().update(embedding=out.embedding,
                                   feat_s1=out.feat_s1, feat_s0=out.feat_s0)
            return out

        sam.encode = enc
        self.hook = sam.sam_mask_decoder.transformer.register_forward_hook(
            self._dec)

    def _get(self) -> dict:
        return self.taken.setdefault(self.on, {"tokens": []})

    def _dec(self, _m, _i, out):
        if self.on is not None:
            self._get()["tokens"].append(out[0])

    def program(self, i: int, dets: dict) -> dict | None:
        """The judge's view of frame i, float32 copies."""
        import torch

        t = self.taken.get(i)
        if t is None or "embedding" not in t or not t["tokens"] \
                or "stability" not in t:
            return None
        return {**{k: t[k].float() for k in ("embedding", "feat_s1",
                                              "feat_s0", "stability",
                                              "boxes")},
                "tokens": torch.cat(t["tokens"]).float(), "dets": dets}

    def close(self):
        self.hook.remove()
        del self.sam.encode
        self.amg.fused_candidates = self.candidates


def run(cell, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda") -> Record:
    import torch

    # A program without SAM 2 stops here, before any set-up.
    from sam6d_tpu_torch.models.ism.sam2 import model as _sam2  # noqa: F401
    from sam6d_tpu_torch.ops import decode_tail, flash_rpe
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

    cap = Capture(det.segmentor.sam)
    kernels = (flash_rpe.KERNEL_PLAIN, decode_tail.KERNEL)
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
            outs[i] = ism_serve.dets_dict(d)
        k += 1
        if (limit is not None and k >= limit) or \
                (limit is None and b - start >= seconds):
            break
    if prof is not None:
        prof.__exit__(None, None, None)
    sync()
    rec.window_s = time.perf_counter() - start
    cap.on = None
    rec.frames = served
    rec.stage_ms = stages
    rec.launches = {k.name: k.launches - launches0[k.name] for k in kernels}
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else 0)
    rec.profile = prof
    if trace:
        rec.extra["calls"] = kernel_calls(det, served)
    guard.check_no_jax("after the window")

    progs = {i: p for i in checked if i in outs
             for p in [cap.program(i, outs[i])] if p is not None}
    cap.close()
    del det, cap, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    a = time.perf_counter()
    per = judge(cc, rcfg, tem, frames, checked, progs, dev, rec)
    if trace:
        rec.flops_per_frame = flops_per_frame(cc, rcfg, dev, frames[0],
                                              served)
    rec.check_s = time.perf_counter() - a
    rec.judged = len(per)
    rec.extra["detections"] = [p["detections"] for p in per]
    rec.numbers = sam2_judge.worst(per) if per else {}
    rec.numbers["proposals"] = (sum(f["proposals"] for f in served)
                                / max(1, len(served)))
    if trace:
        rec.numbers.update(counters_per_frame(len(served)))
    rec.limits = cell.limits["numbers"]
    return rec


COUNTERS = ("hiera.attn_rows_window", "hiera.attn_rows_pooled",
            "hiera.attn_rows_global", "hiera.attn_rows_plain",
            "sam.key_rows_fused", "sam.key_rows_plain",
            "sam2.tail_residual_rows")


def counters_per_frame(frames: int) -> dict:
    """The program's counters over the profiled frames, a frame each
    (printed with the numbers; no limit reads them)."""
    import sys

    from portbench.harness.spans import RECORDER

    got = getattr(sys.modules.get(RECORDER), "PROFILED", None)
    out = {}
    for name in COUNTERS:
        n = sum(c[1] for c in getattr(got, "counts", []) if c[0] == name)
        out["count." + name] = n / max(1, frames)
    return out


def judge(cc, rcfg, tem, frames, checked, progs, dev, rec=None) -> list:
    """The reference's numbers of each checked frame, float32, TF32 off."""
    per = []
    with tf32(False):
        sam, desc = sam2_judge.models(cc, rcfg, dev)
        bank = ism_judge.onboard(desc, tem, dev)
        for i in checked:
            if i not in progs:
                if rec is not None:
                    rec.check_errors.append(f"judged frame {i} was not "
                                            "served")
                continue
            per.append(sam2_judge.judge_frame(sam, desc, bank, rcfg,
                                              frames[i], progs[i]))
    return per


def hiera_calls(trunk, grid: int, es: int) -> list:
    """(BH, Nq, Nk, d, es) of each Hiera block's attention on a grid x
    grid token map: its windows (or the whole map) times its heads, the
    pooled queries of a pooling block, the head width."""
    calls = []
    for blk in trunk.blocks:
        w = blk.window_size or grid
        nw = (-(-grid // w)) ** 2
        nk = w * w
        nq = (w // 2) ** 2 if blk.q_pool else nk
        calls.append((nw * blk.num_heads, nq, nk,
                      blk.dim_out // blk.num_heads, es))
        if blk.q_pool:
            grid //= 2
    return calls


def kernel_calls(det, served) -> dict:
    """The shapes of the traced frames' K5 calls in Hiera
    (`hiera_calls`, every block a call) and K6 calls (each frame one over
    every grid prompt's keys)."""
    sam = det.segmentor.sam
    es = 2 if sam.dtype.itemsize == 2 else 4
    trunk = sam.image_encoder.trunk
    g = sam.input_size // 16
    per_frame = hiera_calls(trunk, sam.input_size // 4, es)
    P = det.cfg.segmentor.points_per_side ** 2
    return {"hiera_attn": [c for _ in served for c in per_frame],
            "decode_tail": [(P, g * g, es) for _ in served]}


def flops_per_frame(cc, rcfg, dev, frame, served) -> list:
    """The reference's operations for each traced frame: SAM 2's encoder
    and every grid prompt's decode (FlopCounterMode, once), and DINOv2-L
    for each proposal that reached the descriptor (once a crop, times the
    frame's proposals; padding rows not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with tf32(False):
        sam, desc = sam2_judge.models(cc, rcfg, dev)
        with FlopCounterMode(display=False) as fc:
            sam2_judge.segment(sam, rcfg.segmentor, frame[0])
        f_sam = float(fc.get_total_flops())
        S = rcfg.descriptor.image_size
        x = torch.zeros(1, S, S, 3, device=dev)
        m = torch.ones(1, S, S, dtype=torch.bool, device=dev)
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            desc.compute_cls_and_patch(x, m)
        f_crop = float(fc.get_total_flops())
    return [f_sam + f["proposals"] * f_crop for f in served]


def control(cell, seed: int, device: str = "cuda") -> dict:
    """The control in the program's place on the frames a run of this
    seed judges: the reference SAM 2 and DINOv2-L in bfloat16 with float8
    Dense products and TF32 geometry, driven by the port's own generator
    and detector (unfused decode: `fused_tail=False`, no kernel), judged
    as a run judges the program."""
    import torch

    from sam6d_tpu_torch.models.ism.detector import ISMDetector
    from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_serve.ism_configs(cc)
    cfg = dataclasses.replace(cfg, segmentor=dataclasses.replace(
        cfg.segmentor, fused_tail=False))
    tem = ism_traffic.templates(tr, cfg.descriptor.image_size,
                                cfg.pointcloud_sample_num)
    frames = ism_traffic.frames(tr, seed)
    checked = check_frames([{"n": 0}] * len(frames), tr["check_frames"],
                           among(tr, False), seed)
    progs = {}
    with tf32(True):
        csam, cdesc = sam2_judge.models(cc, rcfg, dev, control=True)
        driven = _Driven(csam, cfg.segmentor)
        det = ISMDetector(cfg, SamAutomaticMaskGenerator(
            driven, cfg.segmentor), cdesc, device=dev)
        det.onboard_templates(tem["images"], tem["masks"], tem["poses"],
                              tem["pointcloud"])
        for i in checked:
            d = ism_serve.dets_dict(det.detect(*frames[i]))
            progs[i] = {**{k: v.float() for k, v in driven.last.items()},
                        **{k: torch.cat(v) for k, v in driven.kept.items()},
                        "dets": d}
            driven.kept = {"tokens": [], "stability": [], "boxes": []}
        del det, driven, csam, cdesc
    return sam2_judge.worst(judge(cc, rcfg, tem, frames, checked, progs,
                                  dev))


class _Driven:
    """The reference SAM 2 behind the generator's interface (unfused
    decode only), keeping its last encoding, its decoder tokens and its
    candidates' statistics (`sam2_judge.stats` of its own logits, with
    the generator's settings `seg`)."""

    square_resize = True

    def __init__(self, sam, seg):
        self.sam, self.seg, self.last = sam, seg, {}
        self.kept = {"tokens": [], "stability": [], "boxes": []}
        self.device, self.input_size = sam.device, sam.input_size
        self.dtype = sam.dtype

    def preprocess(self, image):
        S = self.input_size
        H, W = image.shape[:2]
        return self.sam.preprocess(image), (S / W, S / H), (S, S)

    def encode(self, image):
        self.last = self.sam.encode(image)
        return self.last

    def decode_points(self, feats, points):
        logits, iou, hs = self.sam.decode_points(feats, points)
        stability, boxes = sam2_judge.stats(
            logits[:, 1:].reshape(-1, *logits.shape[-2:]), self.seg,
            self.input_size)
        for k, v in (("tokens", hs), ("stability", stability),
                     ("boxes", boxes)):
            self.kept[k].append(v.float())
        return logits, iou


def _k6_residuals_left_out():
    """K6's statistics computed without SAM 2's residuals (the kept
    candidates' logits keep them): a fault only `tail_stats` sees."""
    from sam6d_tpu_torch.models.ism.sam import amg

    tail = amg.decode_tail_stats

    def without(*a, res1=None, res0=None, **k):
        return tail(*a, **k)

    amg.decode_tail_stats = without
    return lambda: setattr(amg, "decode_tail_stats", tail)


FAULTS = {"k6_residuals_left_out": _k6_residuals_left_out}


def sweep(cell, seeds, device: str = "cuda", fault: str | None = None):
    """The program's numbers on the frames a run of each seed judges,
    with one program and one reference for every seed: the sound
    readings that set the limits' lower side, or with `fault` (FAULTS)
    a fault planted in the program.  Yields (seed, numbers)."""
    import torch

    dev = torch.device(device)
    cc, tr = cell.config, cell.traffic
    cfg, rcfg = ism_serve.ism_configs(cc)
    tem = ism_traffic.templates(tr, cfg.descriptor.image_size,
                                cfg.pointcloud_sample_num)
    det = build_program(cc, cfg, dev)
    det.onboard_templates(tem["images"], tem["masks"], tem["poses"],
                          tem["pointcloud"])
    with tf32(False):
        sam, desc = sam2_judge.models(cc, rcfg, dev)
        bank = ism_judge.onboard(desc, tem, dev)
    cap = Capture(det.segmentor.sam)
    undo = FAULTS[fault]() if fault else None
    try:
        for seed in seeds:
            frames = ism_traffic.frames(tr, seed)
            per = []
            for i in check_frames([{"n": 0}] * len(frames),
                                  tr["check_frames"], among(tr, False),
                                  seed):
                cap.on = i
                d = ism_serve.dets_dict(det.detect(*frames[i]))
                cap.on = None
                prog = cap.program(i, d)
                cap.taken.clear()
                with tf32(False):
                    per.append(sam2_judge.judge_frame(sam, desc, bank, rcfg,
                                                      frames[i], prog))
            yield seed, sam2_judge.worst(per)
    finally:
        if undo is not None:
            undo()
        cap.close()


if __name__ == "__main__":
    # python3 -m portbench.drivers.ism_sam2_serve --seeds 1 2 3 [--fault F]
    import argparse
    import json

    from portbench.harness import cells

    p = argparse.ArgumentParser(
        description="The program's judged numbers over many seeds (one "
                    "program built), one JSON line a seed.")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    c = cells.resolve("ism_sam2_l.frame")
    for s_, numbers in sweep(c, args.seeds, args.device, args.fault):
        print(json.dumps({"seed": s_, "fault": args.fault,
                          "numbers": numbers}), flush=True)
