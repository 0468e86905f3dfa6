"""FastSAM, plain: YOLOv8-seg with one class, its decode and its masks.

Written from the published description (FastSAM, arXiv:2306.12156:
YOLOv8-seg trained for one class; Ultralytics' `nn/modules` Conv, C2f,
Bottleneck, SPPF, Proto, DFL, Detect and Segment, `yolov8-seg.yaml`;
`ops.process_mask_native`; SAM-6D `model/fast_sam.py` with
`retina_masks=True`), in plain float32 torch and in torch's own layouts:
NCHW activations, `F.conv2d` with (O, C, kh, kw) weights, each
BatchNorm written out (eps 1e-3, Ultralytics') and then SiLU, SPPF's
three 5 x 5 max-pools padded with -inf (`F.max_pool2d`'s padding),
nearest 2x upsampling (`F.interpolate`), the prototypes' 2 x 2 / 2
upsampling as `F.conv_transpose2d`.  It imports no kernel of the port.

The weights are the program's state dict (the JAX variable tree's
layout: (kh, kw, C, O) kernels, flax's ConvTranspose kernel, which is
torch's spatially flipped), mapped here by `load_flax`; `FlaxLayout`
names and shapes that state dict, in the program's order, so that the
benchmark draws one dict for both.  The module takes and returns
channel-last tensors, as the program's network does, so that either can
stand in the other's place.

Departures from the published description, each the program's (the JAX
package's) choice, so that both compute the same function:
* input: the frame resized with PIL's BILINEAR so that its longer side
  is the input size, zero-padded at the bottom and right (Ultralytics
  letterboxes to the centre with grey 114);
* selection: the 4 max_det best anchors by score, then the confidence
  threshold, a greedy NMS on the host and max_det (Ultralytics: the
  threshold, up to 30000 boxes, torchvision's NMS, max_det);
* masks: the sigmoid at the prototypes' resolution is resized to the
  input (jax.image.resize's bilinear, `bbox.resize_matrix`), cropped to
  the resized frame and resized to the frame (Ultralytics crops the
  padding at the prototypes' resolution and interpolates once,
  `F.interpolate` bilinear); a pixel lies in its box from floor(x1) to
  floor(x2), both ends included (Ultralytics: x1 <= x < x2); probability
  above 0.5;
* proposals with an empty mask are dropped, and the boxes are clipped to
  the frame, [0, W - 1] x [0, H - 1], after that.

The control's lower precision: a convolution whose `tf32` is set rounds
its input and its weight to TF32 (10 mantissa bits, to nearest) before
the product, as the tensor cores take float32 operands when TF32 is on
(`round_tf32`; on the CPU too, where PyTorch has no TF32).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.ism.bbox import pil_bilinear_resize, resize_matrix

NUM_MASKS = 32
REG_MAX = 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 explicit mantissa bits (to nearest,
    ties to even), still stored as float32."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class Conv(nn.Module):
    """A plain 2-D convolution, padding k // 2, with an optional bias."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.stride = s
        self.tf32 = False

    def forward(self, x):
        w = self.weight
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv2d(x, w, self.bias, self.stride, self.weight.shape[-1] // 2)


class BatchNorm(nn.Module):
    """Eval BatchNorm over channels: (x - mean) / sqrt(var + eps) * weight
    + bias."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x):
        def col(v):
            return v.view(1, -1, 1, 1)

        return ((x - col(self.running_mean))
                / torch.sqrt(col(self.running_var) + self.eps)
                * col(self.weight) + col(self.bias))


class ConvBNSiLU(nn.Module):
    """Ultralytics' `Conv`: convolution without bias, BatchNorm, SiLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = Conv(c_in, c_out, k, s, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, shortcut: bool):
        super().__init__()
        self.cv1 = ConvBNSiLU(c_in, c_out, 3)
        self.cv2 = ConvBNSiLU(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """cv1 to 2c channels, split in two; n bottlenecks chained on the
    second half; every part concatenated into cv2."""

    def __init__(self, c_in: int, c_out: int, n: int, shortcut: bool = False):
        super().__init__()
        self.c = c_out // 2
        self.cv1 = ConvBNSiLU(c_in, 2 * self.c, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut)
                               for _ in range(n))
        self.cv2 = ConvBNSiLU((2 + n) * self.c, c_out, 1)

    def forward(self, x):
        y = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, dim=1))


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBNSiLU(c_in, c, 1)
        self.cv2 = ConvBNSiLU(4 * c, c_out, 1)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))  # pads with -inf
        return self.cv2(torch.cat(y, dim=1))


class ConvTranspose(nn.Module):
    """2 x 2, stride 2, no padding: `F.conv_transpose2d` with a (C_in,
    C_out, 2, 2) weight."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, 2, 2))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.tf32 = False

    def forward(self, x):
        w = self.weight
        if self.tf32:
            x, w = round_tf32(x), round_tf32(w)
        return F.conv_transpose2d(x, w, self.bias, stride=2)


class Branch(nn.Module):
    """One head branch of Detect / Segment: two 3 x 3 Conv-BN-SiLU, then a
    1 x 1 convolution with a bias."""

    def __init__(self, c_in: int, c: int, c_out: int):
        super().__init__()
        self.b1 = ConvBNSiLU(c_in, c, 3)
        self.b2 = ConvBNSiLU(c, c, 3)
        self.b3 = Conv(c, c_out, 1)

    def forward(self, x):
        return self.b3(self.b2(self.b1(x)))


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class YOLOv8Seg(nn.Module):
    """YOLOv8-seg at a scale (depth, width, max_channels) with one class:
    backbone, PAN-FPN neck, the Segment head (box, class and mask
    coefficient branches at strides 8, 16, 32) and the Proto module."""

    def __init__(self, depth: float, width: float, max_channels: int,
                 num_classes: int = 1):
        super().__init__()

        def w(c):
            return int(math.ceil(min(c, max_channels) * width / 8) * 8)

        def d(n):
            return max(1, round(n * depth))

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
        self.proto_up = ConvTranspose(npr, npr)
        self.proto_cv2 = ConvBNSiLU(npr, npr, 3)
        self.proto_cv3 = ConvBNSiLU(npr, NUM_MASKS, 1)
        c2 = max(16, w(256) // 4, 4 * REG_MAX)
        c3 = max(w(256), min(num_classes, 100))
        c4 = max(w(256) // 4, NUM_MASKS)
        self.heads = nn.ModuleList(
            nn.ModuleList([Branch(ch, c2, 4 * REG_MAX),
                           Branch(ch, c3, num_classes),
                           Branch(ch, c4, NUM_MASKS)])
            for ch in (w(256), w(512), w(1024)))

    def forward(self, x):
        """x (B, S, S, 3) channel-last -> ([(box logits (B, h, w, 64),
        class logits (B, h, w, 1), mask coefficients (B, h, w, 32))] at
        strides 8, 16, 32, prototypes (B, S / 4, S / 4, 32)), channel-last."""
        x = _nchw(x)
        x = self.c2f_1(self.down1(self.stem(x)))
        p3 = self.c2f_2(self.down2(x))
        p4 = self.c2f_3(self.down3(p3))
        p5 = self.sppf(self.c2f_4(self.down4(p4)))

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        n4 = self.neck_c2f_1(torch.cat([up(p5), p4], 1))
        n3 = self.neck_c2f_2(torch.cat([up(n4), p3], 1))
        n4b = self.neck_c2f_3(torch.cat([self.neck_down1(n3), n4], 1))
        n5 = self.neck_c2f_4(torch.cat([self.neck_down2(n4b), p5], 1))
        proto = self.proto_cv3(self.proto_cv2(self.proto_up(
            self.proto_cv1(n3))))
        outs = [tuple(_nhwc(b(f)) for b in heads)
                for f, heads in zip((n3, n4b, n5), self.heads)]
        return outs, _nhwc(proto)


def use_tf32(net: nn.Module) -> nn.Module:
    """Set `tf32` on every convolution of `net`."""
    for m in net.modules():
        if hasattr(m, "tf32"):
            m.tf32 = True
    return net


# -- the program's state dict ------------------------------------------------

def _flax_name(name: str) -> str:
    """The program's name of the reference's parameter `name`: its
    modules are named as the reference's, but a C2f's bottlenecks are
    `m_i` and a head branch `head_{box,cls,mask}{1,2,3}_{level}`, and a
    convolution's weight is its `kernel`."""
    parts = name.split(".")
    if parts[0] == "heads":  # heads.<level>.<branch>.b<j>.<rest>
        lvl, br, j = parts[1], ("box", "cls", "mask")[int(parts[2])], parts[3]
        rest = parts[4:]
        if j == "b3":  # the 1 x 1 Conv itself: head_*3_i.kernel / .bias
            parts = [f"head_{br}3_{lvl}"] + rest
        else:
            parts = [f"head_{br}{j[1]}_{lvl}"] + rest
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "m" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"m_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if out[-1] == "weight" and out[-2] != "bn":
        out[-1] = "kernel"
    return ".".join(out)


class FlaxLayout:
    """The program's state dict as names and shapes on the meta device, in
    the program's order (`named_parameters`, `named_buffers`), for
    `harness/weights.draw_state_dict`."""

    def __init__(self, net: YOLOv8Seg):
        self._params, self._buffers = [], []
        for name, p in net.named_parameters():
            shape = tuple(p.shape)
            if len(shape) == 4:
                if name.startswith("proto_up."):  # (C_in, C_out, kh, kw)
                    shape = (shape[2], shape[3], shape[0], shape[1])
                else:  # (O, C, kh, kw)
                    shape = (shape[2], shape[3], shape[1], shape[0])
            self._params.append((_flax_name(name),
                                 torch.empty(shape, device="meta")))
        for name, b in net.named_buffers():
            self._buffers.append((_flax_name(name),
                                  torch.empty(b.shape, dtype=b.dtype,
                                              device="meta")))

    def named_parameters(self):
        return iter(self._params)

    def named_buffers(self):
        return iter(self._buffers)


def flax_state_dict(net: YOLOv8Seg, layout: FlaxLayout) -> dict:
    """`net`'s state as the program's state dict (the inverse of
    `load_flax`), keyed and ordered as `layout`."""
    out = {}
    for name, v in list(net.named_parameters()) + list(net.named_buffers()):
        v = v.detach()
        if v.dim() == 4:
            if name.startswith("proto_up."):
                v = v.permute(2, 3, 0, 1).flip(0, 1)
            else:
                v = v.permute(2, 3, 1, 0)
        out[_flax_name(name)] = v.contiguous()
    order = [n for n, _ in layout.named_parameters()] + \
        [n for n, _ in layout.named_buffers()]
    return {n: out[n] for n in order}


@torch.no_grad()
def load_flax(net: YOLOv8Seg, state: dict) -> YOLOv8Seg:
    """Load the program's state dict: (kh, kw, C, O) kernels become (O, C,
    kh, kw) weights, flax's ConvTranspose kernel (kh, kw, C_in, C_out)
    becomes torch's (C_in, C_out, kh, kw) flipped in both spatial axes
    (flax's transposed convolution does not flip its kernel; torch's
    does)."""
    mine = {}
    for name, _ in list(net.named_parameters()) + list(net.named_buffers()):
        v = state[_flax_name(name)]
        if v.dim() == 4:
            if name.startswith("proto_up."):
                v = v.flip(0, 1).permute(2, 3, 0, 1)
            else:
                v = v.permute(3, 2, 0, 1)
        mine[name] = v.contiguous()
    if len(mine) != len(state):
        raise KeyError(f"{len(state) - len(mine)} keys of the state dict "
                       "have no place in the reference")
    net.load_state_dict(mine)
    return net


# -- decode, selection and masks ----------------------------------------------

def decode(outs, img_size: int):
    """Head outputs -> boxes (B, A, 4) xyxy in input pixels, class scores
    (B, A, classes), mask coefficients (B, A, 32), anchors in level order
    and row-major.  Each box side is the expectation of a softmax over
    REG_MAX bins (DFL) times the level's stride, from the anchor's cell
    centre."""
    boxes, scores, coefs = [], [], []
    for box, cls, mc in outs:
        B, h, w, _ = box.shape
        stride = img_size / h
        p = torch.softmax(box.reshape(B, h * w, 4, REG_MAX), dim=-1)
        dist = p @ torch.arange(REG_MAX, dtype=p.dtype, device=p.device)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=p.dtype, device=p.device) + 0.5,
            torch.arange(w, dtype=p.dtype, device=p.device) + 0.5,
            indexing="ij")
        cx, cy = gx.reshape(1, -1), gy.reshape(1, -1)
        boxes.append(torch.stack([cx - dist[..., 0], cy - dist[..., 1],
                                  cx + dist[..., 2], cy + dist[..., 3]],
                                 -1) * stride)
        scores.append(torch.sigmoid(cls.reshape(B, h * w, -1)))
        coefs.append(mc.reshape(B, h * w, -1))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(coefs, 1)


def prepare(image: np.ndarray, img_size: int, device):
    """The network's input (1, S, S, 3) in [0, 1] and the scale from the
    frame to it."""
    H, W = image.shape[:2]
    scale = img_size / max(H, W)
    eh, ew = int(round(H * scale)), int(round(W * scale))
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    if (eh, ew) != (H, W):
        img = pil_bilinear_resize(img, eh, ew)
    x = torch.zeros(1, img_size, img_size, 3, device=device)
    x[0, :eh, :ew] = img.float() / 255.0
    return x, scale, (eh, ew)


def top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k best anchors, best first, equal scores lowest index first."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    inter = (np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                     - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
             * np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                       - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None))
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None] - inter + 1e-9)


def greedy_nms(boxes: np.ndarray, scores: np.ndarray, iou: float):
    """Indices kept by greedy NMS on the host, best score first; equal
    scores in the order of numpy's default sort, as the program's NMS
    takes them (scores of 1.0 tie wherever the sigmoid saturates)."""
    order = np.argsort(-scores)
    m = iou_matrix(boxes, boxes)
    keep, gone = [], np.zeros(len(boxes), bool)
    for i in order:
        if not gone[i]:
            keep.append(i)
            gone |= m[i] > iou
    return np.asarray(keep, np.int64)


def mask_probabilities(coefs, proto, eh: int, ew: int, H: int, W: int):
    """(N, 32) coefficients and (ph, pw, 32) prototypes -> (N, H, W): the
    sigmoid of coef . proto, resized to the input size, cropped to the
    resized frame (eh, ew) and resized to the frame, one step after the
    other."""
    ph, pw, _ = proto.shape
    dev = proto.device
    S = 4 * ph
    sig = torch.sigmoid(torch.einsum("nm,hwm->nhw", coefs, proto))
    full = torch.einsum("yh,nhw,xw->nyx", resize_matrix(ph, S, dev), sig,
                        resize_matrix(pw, S, dev))
    crop = full[:, :eh, :ew]
    return torch.einsum("yh,nhw,xw->nyx", resize_matrix(eh, H, dev), crop,
                        resize_matrix(ew, W, dev))


def inside_boxes(boxes, H: int, W: int):
    """(N, 4) xyxy frame pixels -> (N, H, W) bool: rows floor(y1) to
    floor(y2) and columns floor(x1) to floor(x2), both ends included."""
    b = torch.floor(boxes)
    ys = torch.arange(H, device=boxes.device, dtype=b.dtype).view(1, H, 1)
    xs = torch.arange(W, device=boxes.device, dtype=b.dtype).view(1, 1, W)
    return ((ys >= b[:, 1, None, None]) & (ys <= b[:, 3, None, None])
            & (xs >= b[:, 0, None, None]) & (xs <= b[:, 2, None, None]))


@torch.no_grad()
def generate_masks(net: YOLOv8Seg, image: np.ndarray, img_size: int,
                   conf: float, iou: float, max_det: int) -> dict:
    """The whole segmentor on one (H, W, 3) uint8 frame: {"masks" (N, H,
    W) bool, "boxes" (N, 4) float32 xyxy in frame pixels, "anchors" (N,)
    the anchor of each proposal}."""
    H, W = image.shape[:2]
    dev = next(net.parameters()).device
    x, scale, (eh, ew) = prepare(image, img_size, dev)
    outs, proto = net(x)
    boxes, scores, coefs = decode(outs, img_size)
    best = top_k(scores[0].amax(-1), 4 * max_det)
    s = scores[0].amax(-1)[best].cpu().numpy()
    b = boxes[0][best].cpu().numpy()
    above = np.flatnonzero(s > conf)
    keep = above[greedy_nms(b[above], s[above], iou)[:max_det]]
    anchors = best.cpu().numpy()[keep]
    fb = torch.from_numpy(b[keep] / scale).to(dev)
    idx = torch.from_numpy(anchors).to(dev)
    prob = mask_probabilities(coefs[0][idx], proto[0], eh, ew, H, W)
    masks = ((prob > 0.5) & inside_boxes(fb, H, W)).cpu().numpy()
    full = masks.reshape(len(masks), -1).any(1)
    out_boxes = (b[keep] / scale)[full].astype(np.float32)
    out_boxes[:, 0::2] = np.clip(out_boxes[:, 0::2], 0, W - 1)
    out_boxes[:, 1::2] = np.clip(out_boxes[:, 1::2], 0, H - 1)
    return {"masks": masks[full], "boxes": out_boxes,
            "anchors": anchors[full]}
