"""The ISM detector's two mask routes give the same detections, on the CPU.

FastSAM returns its proposal masks twice: on the host ("masks") and as
the tensor they were composed in ("device_masks"), with each mask's
pixel count ("areas").  The detector then sizes the proposals from the
counts and crops from the device masks; a segmentor that returns host
masks alone (SAM's AMG) has them counted on the host and uploaded.  Each
frame here is one FastSAM result, served both ways: the detections
(masks, boxes, scores, object ids, extras) and the proposal counts must
be equal bit for bit, and the counters say which route ran.

FastSAM at the "n" scale, 128 px, on 96 x 120 frames, with seeded
weights and non-trivial BatchNorm statistics; DINOv2 at 28 x 28 crops,
embed 32, depth 2, 2 heads, with `params.init_random_` weights.
"""

import numpy as np
import pytest
import torch

import sam6d_tpu_torch.config as tc
from sam6d_tpu_torch.models.ism import fastsam
from sam6d_tpu_torch.models.ism.detector import ISMDetector
from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel
from sam6d_tpu_torch.params import init_random_
from sam6d_tpu_torch.utils import timer
from sam6d_tpu_torch.utils.detections import sized_indices

torch.set_num_threads(2)

TINY_DESC = dict(image_size=28, patch_size=14, embed_dim=32, depth=2,
                 num_heads=2)
HW = (96, 120)


def fastsam_n(seed=0):
    """FastSAM-n at 128 px on the CPU: LeCun-normal kernels, scales
    1 + N(0, 0.1^2), biases and means N(0, 0.1^2), variances
    U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    seg = fastsam.FastSAM(img_size=128, conf=0.3, max_det=24, width=0.25,
                          depth=0.33, device="cpu")
    sd = seg.net.state_dict()
    for name, t in sd.items():
        if name.endswith("kernel"):
            fan_in = int(np.prod(t.shape[:-1]))
            t.copy_(torch.randn(t.shape, generator=g) / fan_in ** 0.5)
        elif name.endswith("running_var"):
            t.copy_(0.5 + torch.rand(t.shape, generator=g))
        elif name.endswith("weight"):
            t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
        else:
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return seg


class Fixed:
    """A segmentor that returns one result."""

    def __init__(self, proposals):
        self.proposals = proposals

    def generate_masks(self, image, timer=None):
        return self.proposals


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(5)
    image = (rng.rand(*HW, 3) * 255).astype(np.uint8)
    desc = DescriptorModel(tc.DescriptorConfig(**TINY_DESC))
    init_random_(desc, torch.Generator().manual_seed(1))
    seg = fastsam_n()
    return dict(
        image=image, depth=(1.0 + 0.5 * rng.rand(*HW)).astype(np.float32),
        K=np.array([[90.0, 0, 60], [0, 90.0, 48], [0, 0, 1]], np.float32),
        desc=desc.eval(), seg=seg, plain=seg.generate_masks(image),
        tem=dict(template_images=rng.rand(2, 3, 28, 28, 3).astype(np.float32),
                 template_masks=rng.rand(2, 3, 28, 28) > 0.3,
                 template_poses=np.broadcast_to(
                     np.eye(4, dtype=np.float32), (3, 4, 4)).copy(),
                 pointcloud=(rng.randn(2, 64, 3) * 0.05).astype(np.float32)))


def detector(scene, **cfg):
    d = ISMDetector(tc.ISMConfig(descriptor=tc.DescriptorConfig(**TINY_DESC),
                                 **{"confidence_thresh": -1.0, **cfg}),
                    None, scene["desc"], device="cpu")
    d.onboard_templates(**scene["tem"])
    return d


def serve(det, proposals, scene):
    """detect over one segmentor result: the detections, the proposal
    counts and the counters."""
    det.segmentor = Fixed(proposals)
    with timer.recording() as rec:
        out = det.detect(scene["image"], scene["depth"], scene["K"])
    counters = {}
    for name, n, _, _ in rec.counts:
        counters[name] = counters.get(name, 0) + n
    return out, dict(det.last_counts), counters


def assert_same(got, want):
    for k in ("masks", "boxes", "scores", "object_ids"):
        g, w = getattr(got, k), getattr(want, k)
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert list(got.extras) == list(want.extras)
    for k, w in want.extras.items():
        assert got.extras[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got.extras[k], w, err_msg=k)


def drawn(seed=3, n=16):
    """A FastSAM-shaped result drawn by hand: rectangles of 8-40 px spread
    over the frame, so that several survive the per-object NMS, and one
    of 3 pixels in a box the box size keeps."""
    rng = np.random.RandomState(seed)
    H, W = HW
    masks = np.zeros((n, H, W), bool)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        h, w = rng.randint(8, 40, 2)
        y, x = rng.randint(0, H - h), rng.randint(0, W - w)
        masks[i, y:y + h, x:x + w] = True
        boxes[i] = x, y, x + w - 1, y + h - 1
    masks[5] = False
    masks[5, int(boxes[5, 1]), int(boxes[5, 0]):int(boxes[5, 0]) + 3] = True
    return {"masks": masks, "boxes": boxes,
            "device_masks": torch.from_numpy(masks.copy()),
            "areas": masks.reshape(n, -1).sum(1)}


CASES = ["as_composed", "one_composes_empty", "one_under_min_mask_size",
         "some_below_confidence", "no_proposals", "drawn"]


@pytest.mark.parametrize("case", CASES)
def test_device_and_host_masks_give_the_same_detections(scene, monkeypatch,
                                                        case):
    seg, plain = scene["seg"], scene["plain"]
    if case == "one_composes_empty":
        compose = fastsam.mask_probabilities

        def emptied(*a):
            probs = compose(*a)
            probs[1] = 0.0
            return probs

        monkeypatch.setattr(fastsam, "mask_probabilities", emptied)
    if case == "no_proposals":
        monkeypatch.setattr(seg, "conf", 1.1)
    proposals = (drawn() if case == "drawn"
                 else seg.generate_masks(scene["image"]))
    n, cfg = len(proposals["masks"]), {}
    if case == "one_under_min_mask_size":
        # Between the two smallest areas of the proposals the box size
        # keeps: the smallest alone falls under it.
        boxed = sized_indices(proposals["boxes"], proposals["areas"], HW,
                              min_mask_size=0.0)
        a = np.sort(proposals["areas"][boxed])
        assert a[0] < a[1]
        cfg["min_mask_size"] = float(a[0] + a[1]) / 2 / (HW[0] * HW[1])
    if case == "some_below_confidence":
        first = serve(detector(scene), proposals, scene)[0]
        cfg["confidence_thresh"] = float(
            np.median(first.extras["semantic_score"]))
    det = detector(scene, **cfg)
    got, got_counts, got_counters = serve(det, proposals, scene)
    host = {"masks": proposals["masks"], "boxes": proposals["boxes"]}
    want, want_counts, want_counters = serve(det, host, scene)

    assert_same(got, want)
    assert got_counts == want_counts
    sized = want_counts["sized"]
    assert got_counters.get("ism.mask_rows_on_device", 0) == sized
    assert want_counters.get("ism.mask_rows_uploaded", 0) == sized
    assert "ism.mask_rows_uploaded" not in got_counters
    assert "ism.mask_rows_on_device" not in want_counters
    # Each case holds what it is named for.
    if case == "no_proposals":
        assert n == 0 and len(want) == 0 and want_counts == {
            "proposals": 0, "sized": 0}
        return
    assert n > 3 and len(want) > 0
    if case == "one_composes_empty":
        assert n == len(plain["masks"]) - 1
    if case == "one_under_min_mask_size":
        assert sized == len(boxed) - 1
    if case == "some_below_confidence":
        assert 0 < want_counts["confident"] < sized
    if case == "drawn":
        assert sized == n - 1 and len(want) > 1
