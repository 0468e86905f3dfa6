"""FastSAM: the YOLOv8-seg proposal generator of the ISM.

Counterpart of `sam6d_tpu/models/ism/fastsam.py` (reference Instance_
Segmentation_Model/model/fast_sam.py CustomYOLO :18, FastSAM.generate_
masks :113): a CSP backbone with C2f blocks, a PAN-FPN neck, and a
decoupled detect head with 32 mask prototypes, whose detections become
class-agnostic mask proposals.  The network, the box decode and the
mask composition run on the module's device; score thresholding and
the NMS run on the host, as in the JAX package.

Module names and parameter layouts are those of the JAX variable tree,
so `params.flax_to_state_dict` maps it as it is: convolution kernels are
(kh, kw, C, O), and `proto_up`'s ConvTranspose kernel is flax's, which
is torch's ConvTranspose2d kernel spatially flipped
(`convert_weights.convert_fastsam`).  Activations are channel-last
(B, H, W, C); each convolution runs `F.conv2d` on the channel-first
view of the same memory.  Everything computes in float32, as the JAX
demo builds FastSAM.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.layers import BatchNorm
from sam6d_tpu_torch.ops.topk import top_k_indices
from sam6d_tpu_torch.utils.bbox import resize_matrix
from sam6d_tpu_torch.utils.detections import nms
from sam6d_tpu_torch.utils.resize import pil_resize
from sam6d_tpu_torch.utils.timer import count, stage

# Checkpoint module index -> module name (ultralytics yolov8-seg.yaml
# order; indices 10/11/13/14/17/20 are Upsample/Concat with no
# parameters, 22 is the Segment head, mapped field by field).
FASTSAM_LAYER_MAP = {
    0: "stem", 1: "down1", 2: "c2f_1", 3: "down2", 4: "c2f_2",
    5: "down3", 6: "c2f_3", 7: "down4", 8: "c2f_4", 9: "sppf",
    12: "neck_c2f_1", 15: "neck_c2f_2", 16: "neck_down1",
    18: "neck_c2f_3", 19: "neck_down2", 21: "neck_c2f_4",
}

# (depth, width, max_channels) per YOLOv8 scale: FastSAM-s is "s",
# FastSAM-x is "x".
FASTSAM_SCALES = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "x": (1.00, 1.25, 512),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax `nn.Conv`: a (kh, kw, C, O) kernel, stride, padding k // 2."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel, kernel, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride

    def forward(self, x):
        w = self.kernel.permute(3, 2, 0, 1)
        y = F.conv2d(_nchw(x), w, self.bias, stride=self.stride,
                     padding=self.kernel.shape[0] // 2)
        return _nhwc(y)


class ConvBNSiLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, bias=False)
        self.bn = BatchNorm(out_ch, eps=1e-3, momentum=0.97)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBNSiLU(in_ch, out_ch, 3)
        self.cv2 = ConvBNSiLU(out_ch, out_ch, 3)
        self.add = shortcut and in_ch == out_ch

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block: both halves of cv1 and every
    bottleneck's output are concatenated into cv2."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = False):
        super().__init__()
        hidden = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, 2 * hidden, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(hidden, hidden, shortcut))
        self.cv2 = ConvBNSiLU((2 + n) * hidden, out_ch, 1)
        self.n, self.hidden = n, hidden

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[..., :self.hidden], y[..., self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=-1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5 x 5 / 1 max-pools,
    padded with -inf."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        hidden = in_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, hidden, 1)
        self.cv2 = ConvBNSiLU(4 * hidden, out_ch, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(_nhwc(F.max_pool2d(_nchw(pools[-1]), 5, 1, 2)))
        return self.cv2(torch.cat(pools, dim=-1))


class ConvTranspose2x2(nn.Module):
    """flax `nn.ConvTranspose(kernel 2, stride 2, VALID)` as one matmul and
    a pixel shuffle: output pixel (2y + dy, 2x + dx) is x[y, x] @
    kernel[1 - dy, 1 - dx] + bias (flax's kernel is torch's flipped)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(2, 2, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x):
        B, H, W, C = x.shape
        O = self.kernel.shape[-1]
        k = self.kernel.flip(0, 1).permute(2, 0, 1, 3).reshape(C, 4 * O)
        y = (x @ k).reshape(B, H, W, 2, 2, O).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, 2 * H, 2 * W, O) + self.bias


def _upsample2(x):
    """Nearest-neighbour 2x upsampling of (B, H, W, C)."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)


class YOLOv8Seg(nn.Module):
    """Backbone, PAN neck and the decoupled detect / proto heads.
    width, depth and max_channels follow the YOLOv8 scale table
    (FASTSAM_SCALES); the default is FastSAM-s."""

    def __init__(self, width: float = 0.5, depth: float = 0.33,
                 max_channels: int = 1024, num_classes: int = 1,
                 num_masks: int = 32, reg_max: int = 16):
        super().__init__()

        def w(c):
            return make_divisible(min(c, max_channels) * width)

        def d(n):
            return max(1, int(round(n * depth)))

        self.stem = ConvBNSiLU(3, w(64), 3, 2)
        self.down1 = ConvBNSiLU(w(64), w(128), 3, 2)
        self.c2f_1 = C2f(w(128), w(128), d(3), True)
        self.down2 = ConvBNSiLU(w(128), w(256), 3, 2)
        self.c2f_2 = C2f(w(256), w(256), d(6), True)
        self.down3 = ConvBNSiLU(w(256), w(512), 3, 2)
        self.c2f_3 = C2f(w(512), w(512), d(6), True)
        self.down4 = ConvBNSiLU(w(512), w(1024), 3, 2)
        self.c2f_4 = C2f(w(1024), w(1024), d(3), True)
        self.sppf = SPPF(w(1024), w(1024))
        self.neck_c2f_1 = C2f(w(1024) + w(512), w(512), d(3))
        self.neck_c2f_2 = C2f(w(512) + w(256), w(256), d(3))
        self.neck_down1 = ConvBNSiLU(w(256), w(256), 3, 2)
        self.neck_c2f_3 = C2f(w(256) + w(512), w(512), d(3))
        self.neck_down2 = ConvBNSiLU(w(512), w(512), 3, 2)
        self.neck_c2f_4 = C2f(w(512) + w(1024), w(1024), d(3))

        npr = w(256)
        self.proto_cv1 = ConvBNSiLU(w(256), npr, 3)
        self.proto_up = ConvTranspose2x2(npr, npr)
        self.proto_cv2 = ConvBNSiLU(npr, npr, 3)
        self.proto_cv3 = ConvBNSiLU(npr, num_masks, 1)
        # Branch widths derive from the P3 channel count at every level
        # (ultralytics Detect / Segment).
        c2 = max(16, w(256) // 4, 4 * reg_max)
        c3 = max(w(256), min(num_classes, 100))
        c4 = max(w(256) // 4, num_masks)
        for i, ch in enumerate((w(256), w(512), w(1024))):
            for name, c, out in (("box", c2, 4 * reg_max),
                                 ("cls", c3, num_classes),
                                 ("mask", c4, num_masks)):
                self.add_module(f"head_{name}1_{i}", ConvBNSiLU(ch, c, 3))
                self.add_module(f"head_{name}2_{i}", ConvBNSiLU(c, c, 3))
                self.add_module(f"head_{name}3_{i}", Conv(c, out, 1))

    def forward(self, x):
        """x (B, S, S, 3) -> ([(box, cls, mask coefficients)] at strides
        8, 16, 32, each (B, h, w, channels); prototypes (B, S/4, S/4,
        num_masks))."""
        x = self.c2f_1(self.down1(self.stem(x)))
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))

        n4 = self.neck_c2f_1(torch.cat([_upsample2(p5), p4], dim=-1))
        n3 = self.neck_c2f_2(torch.cat([_upsample2(n4), p3], dim=-1))
        n4b = self.neck_c2f_3(torch.cat([self.neck_down1(n3), n4], dim=-1))
        n5 = self.neck_c2f_4(torch.cat([self.neck_down2(n4b), p5], dim=-1))

        proto = self.proto_up(self.proto_cv1(n3))
        proto = self.proto_cv3(self.proto_cv2(proto))
        outs = []
        for i, feat in enumerate((n3, n4b, n5)):
            branch = []
            for name in ("box", "cls", "mask"):
                y = feat
                for j in (1, 2, 3):
                    y = getattr(self, f"head_{name}{j}_{i}")(y)
                branch.append(y)
            outs.append(tuple(branch))
        return outs, proto


def decode_boxes(outs, img_size: int, reg_max: int = 16):
    """Anchor-free DFL decode: the head outputs -> (B, A, 4) xyxy boxes in
    input pixels, (B, A, classes) scores and (B, A, M) mask
    coefficients; each box side is the expectation of a softmax over
    `reg_max` bins."""
    boxes, scores, mcoefs = [], [], []
    for box, cls, mc in outs:
        B, H, W, _ = box.shape
        stride = img_size // H
        box = box.reshape(B, H * W, 4, reg_max)
        bins = torch.arange(reg_max, dtype=box.dtype, device=box.device)
        dist = (torch.softmax(box, dim=-1) * bins).sum(-1)
        cy = torch.arange(H, dtype=box.dtype, device=box.device) + 0.5
        cx = torch.arange(W, dtype=box.dtype, device=box.device) + 0.5
        cxy = torch.stack([cx[None, :].expand(H, W), cy[:, None].expand(H, W)],
                          dim=-1).reshape(1, H * W, 2)
        x1y1 = (cxy - dist[..., :2]) * stride
        x2y2 = (cxy + dist[..., 2:]) * stride
        boxes.append(torch.cat([x1y1, x2y2], dim=-1))
        scores.append(torch.sigmoid(cls.reshape(B, H * W, -1)))
        mcoefs.append(mc.reshape(B, H * W, -1))
    return (torch.cat(boxes, dim=1), torch.cat(scores, dim=1),
            torch.cat(mcoefs, dim=1))


def mask_probabilities(mcoef, proto, eh: int, ew: int, H: int, W: int,
                       img_size: int):
    """(N, M) coefficients and (ph, pw, M) prototypes -> (N, H, W) mask
    probabilities at the frame's size: the sigmoid of coef @ proto,
    resized to the input, cropped to the resized frame (eh, ew) and
    resized to (H, W).  Each step is linear per axis, so the chain is one
    (H, ph) x (N, ph, pw) x (pw, W) product."""
    ph, pw, M = proto.shape
    dev = proto.device
    S = img_size
    sig = torch.sigmoid(mcoef @ proto.reshape(ph * pw, M).T).reshape(
        -1, ph, pw)
    A = resize_matrix(eh, H, dev) @ resize_matrix(ph, S, dev)[:eh]
    Bm = resize_matrix(ew, W, dev) @ resize_matrix(pw, S, dev)[:ew]
    return torch.einsum("yh,khw,xw->kyx", A, sig, Bm)


def box_clip(boxes, H: int, W: int):
    """(N, 4) xyxy boxes in frame pixels -> (N, H, W) bool: the pixels
    from floor(x1, y1) to floor(x2, y2), both ends included."""
    b = torch.floor(boxes).long()
    iy = torch.arange(H, device=boxes.device)[None, :, None]
    ix = torch.arange(W, device=boxes.device)[None, None, :]
    return ((iy >= b[:, 1, None, None]) & (iy <= b[:, 3, None, None])
            & (ix >= b[:, 0, None, None]) & (ix <= b[:, 2, None, None]))


class FastSAM:
    """FastSAM with the ISM segmentor contract `generate_masks(image,
    timer=None)`.  The thresholds are the reference fast_sam.yaml's
    (iou 0.9, conf 0.05, max_det 200; model/fast_sam.py:33-45).  The
    network `net` is built on `device` (the card unless the caller asks
    for the CPU) with zero weights, until loaded or drawn."""

    def __init__(self, img_size: int = 640, conf: float = 0.05,
                 iou: float = 0.9, max_det: int = 200,
                 scale: str | None = None, width: float = 0.5,
                 depth: float = 0.33, max_channels: int = 1024,
                 device="cuda"):
        if scale is not None:
            depth, width, max_channels = FASTSAM_SCALES[scale]
        self.img_size = img_size
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.net = YOLOv8Seg(width, depth, max_channels).to(
            resolve_device(device)).eval()

    @property
    def device(self) -> torch.device:
        return self.net.proto_up.bias.device

    @torch.no_grad()
    def candidates(self, padded: torch.Tensor):
        """(1, S, S, 3) input -> the top 4 * max_det anchors by score:
        boxes (K, 4) in input pixels, scores (K,), mask coefficients
        (K, M), and the prototypes (ph, pw, M)."""
        outs, proto = self.net(padded)
        boxes, scores, mcoef = decode_boxes(outs, self.img_size)
        conf = scores.amax(-1)[0]
        keep = top_k_indices(conf, self.max_det * 4)
        return boxes[0][keep], conf[keep], mcoef[0][keep], proto[0]

    @torch.no_grad()
    def generate_masks(self, image: np.ndarray, timer=None) -> dict:
        """(H, W, 3) uint8 -> {"masks": (N, H, W) bool, "boxes": (N, 4)
        xyxy float32} at the frame's size, with "device_masks", the same
        masks as a bool tensor on the network's device, and "areas" (N,)
        int64, each mask's pixel count.  The frame is resized with PIL's
        BILINEAR (`utils/resize.py`) so its longer side is the input
        size, and zero-padded.  The masks, their counts and the empty
        masks' removal stay on the device; "masks" is one download of
        them into pinned memory from the caching host allocator (a view
        of "device_masks" on the CPU)."""
        H, W = image.shape[:2]
        S = self.img_size
        scale = S / max(H, W)
        eh, ew = int(round(H * scale)), int(round(W * scale))
        padded = np.zeros((S, S, 3), np.float32)
        padded[:eh, :ew] = pil_resize(image, eh, ew).astype(np.float32) / 255.0

        with stage(timer, "fastsam_forward"):
            boxes, conf, mcoef, proto = self.candidates(
                torch.from_numpy(padded).to(self.device)[None])
            boxes, conf = boxes.cpu().numpy(), conf.cpu().numpy()
        with stage(timer, "fastsam_nms"):
            keep = np.flatnonzero(conf > self.conf)
            count("fastsam.candidates", len(keep))
            if len(keep) == 0:
                return {"masks": np.zeros((0, H, W), bool),
                        "boxes": np.zeros((0, 4), np.float32),
                        "device_masks": torch.zeros(
                            (0, H, W), dtype=torch.bool, device=self.device),
                        "areas": np.zeros(0, np.int64)}
            keep = keep[nms(boxes[keep], conf[keep], self.iou)[:self.max_det]]
            count("fastsam.kept", len(keep))
            boxes_orig = boxes[keep] / scale
        with stage(timer, "fastsam_masks"):
            clip_boxes = torch.from_numpy(boxes_orig).to(self.device)
            probs = mask_probabilities(
                mcoef[torch.from_numpy(keep).to(self.device)], proto,
                eh, ew, H, W, S)
            masks = (probs > 0.5) & box_clip(clip_boxes, H, W)
            areas = masks.flatten(1).sum(1).cpu().numpy()
            nonempty = areas > 0
            if not nonempty.all():
                idx = np.flatnonzero(nonempty)
                masks = masks[torch.from_numpy(idx).to(self.device)]
                areas = areas[idx]
            # One download, into pinned memory from the caching host
            # allocator (reused once a frame's result is freed): 200
            # masks at 480 x 640 take 1.7 ms so on an H100, 29-40 ms
            # into pageable memory.
            host = masks if masks.device.type == "cpu" else torch.empty(
                masks.shape, dtype=torch.bool, pin_memory=True).copy_(masks)
        out_boxes = boxes_orig[nonempty].astype(np.float32)
        out_boxes[:, 0::2] = np.clip(out_boxes[:, 0::2], 0, W - 1)
        out_boxes[:, 1::2] = np.clip(out_boxes[:, 1::2], 0, H - 1)
        return {"masks": host.numpy(), "boxes": out_boxes,
                "device_masks": masks, "areas": areas}
