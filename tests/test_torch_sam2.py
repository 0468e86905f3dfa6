"""SAM 2.1 (`models/ism/sam2/`) against the benchmark's plain reference
(`portbench/reference/ism/sam2.py`) on the CPU, at a tiny Hiera (embed 16,
one head, stages 1-2-2-1 with one global block in stage 3, windows 4, 2,
4, 2) at 128 px, on the benchmark's seeded weights
(`portbench/harness/sam2_judge.draw`) loaded into both from one state
dict.

Tolerances, float32 throughout:
* preprocessing, the trunk's four stages, the neck's levels, feat_s0,
  feat_s1 and the embedding: 1e-5 relative (Frobenius).  The port cuts
  windows after qkv and pools q on the whole map where the reference
  cuts before and pools in each window: the same operations on the same
  numbers, so only the products' blocking may differ (0 seen);
* the decoder (object-score token, sigmoid IoU, the residual tail):
  logits and tokens 1e-5 relative, IoUs 1e-6 (0 to 6e-7 seen);
* the plain K5 at d = 72 with Nq < Nk against the attention written out
  in float64: 1e-5;
* the plain K6 with the residuals against `MaskDecoder.tail` with the
  same sigmoid-form GELU: the stabilities and boxes from the same logits
  up to the contractions' order (1e-6 of a logit), so the counts may
  move by a pixel or two near a threshold (atol 3 of ~300) and a box
  edge by one logit pixel (4 input pixels);
* the generator end to end on a 4 x 4 grid: the port's model and the
  reference's behind the same generator keep the same proposals (masks
  equal, boxes within 1e-3 px).
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.drivers import ism_sam2_serve as serve
from portbench.harness import sam2_judge
from portbench.reference.ism import sam2 as ref
from sam6d_tpu_torch.config import SegmentorConfig
from sam6d_tpu_torch.models.ism.sam import amg
from sam6d_tpu_torch.models.ism.sam2.model import SAM2, SAM2_VARIANTS
from sam6d_tpu_torch.ops import decode_tail as dt
from sam6d_tpu_torch.ops.flash_rpe import flash_attention
from sam6d_tpu_torch.utils import timer

torch.set_num_threads(2)

TINY = dict(embed_dim=16, num_heads=1, stages=(1, 2, 2, 1),
            global_att_blocks=(4,), window_spec=(4, 2, 4, 2))
SIZE = 128


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def pair():
    """The port's tiny SAM 2 and the reference's, on one state dict."""
    r = ref.SAM2(img_size=SIZE, trunk_kwargs=TINY, device="cpu")
    p = SAM2(img_size=SIZE, trunk_kwargs=TINY, device="cpu")
    sd = sam2_judge.draw(r, 11, "cpu")
    r.load_state_dict(sd)
    p.load_state_dict(sd)
    return p.eval(), r.eval()


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(2)
    return (rng.random((96, 128, 3)) * 255).astype(np.uint8)


def test_the_variant_is_hiera_l_as_published():
    assert SAM2_VARIANTS["sam2.1_hiera_l"] == ref.HIERA_L
    # The benchmark's configuration file states the same sizes.
    with open(pathlib.Path(__file__).resolve().parents[1] / "portbench"
              / "configs" / "ism_sam2_l.json") as f:
        trunk = json.load(f)["sam2"]["image_encoder"]["trunk"]
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in trunk.items() if k in ref.HIERA_L} == ref.HIERA_L
    with torch.device("meta"):
        r = ref.SAM2(device="meta")
    blocks = r.image_encoder.trunk.blocks
    assert len(blocks) == 48
    pooled = [i for i, b in enumerate(blocks) if b.q_pool]
    glob = [i for i, b in enumerate(blocks) if b.window_size == 0]
    assert pooled == [2, 8, 44] and glob == [23, 33, 43]
    # The first block of a stage keeps the previous stage's window.
    assert [blocks[i].window_size for i in (0, 2, 3, 8, 9, 44, 45)] == [
        8, 8, 4, 4, 16, 16, 8]
    assert r.image_encoder.trunk.channel_list == [1152, 576, 288, 144]


def test_hieras_attention_calls_at_1024():
    # Every block's K5 call at 1024 px (256 x 256 tokens after the
    # patch embedding): the shapes the cell's roofline counts.
    with torch.device("meta"):
        trunk = ref.SAM2(device="meta").image_encoder.trunk
    calls = serve.hiera_calls(trunk, 256, 2)
    assert len(calls) == 48 and {c[3] for c in calls} == {72}
    shapes = {tuple(c[:3]) for c in calls}
    assert shapes == {(2048, 64, 64), (4096, 16, 16), (128, 256, 256),
                      (8, 4096, 4096), (256, 64, 64), (4096, 16, 64),
                      (8192, 4, 16), (256, 64, 256)}
    rows = {"window": 0, "pooled": 0, "global": 0}
    for blk, (BH, Nq, _, _, _) in zip(trunk.blocks, calls):
        kind = ("pooled" if blk.q_pool else
                "global" if blk.window_size == 0 else "window")
        rows[kind] += BH * Nq
    assert rows == {"window": 1687552, "pooled": 114688, "global": 98304}


def test_preprocess_trunk_neck_and_features_match(pair, image):
    p, r = pair
    x = torch.from_numpy(image)
    xp, scale, eff = p.preprocess(x)
    xr = r.preprocess(x)
    assert scale == (SIZE / 128, SIZE / 96) and eff == (SIZE, SIZE)
    assert _rel(xp, xr) < 1e-6
    with torch.no_grad():
        tp = p.image_encoder.trunk(xp[None])
        tr = r.image_encoder.trunk(xr[None])
        assert [t.shape[1:] for t in tp] == [
            (32, 32, 16), (16, 16, 32), (8, 8, 64), (4, 4, 128)]
        for a, b in zip(tp, tr):
            assert _rel(a, b) < 1e-5
        fp, fr_ = p.encode(xp[None]), r.encode(xr[None])
    for k in ("embedding", "feat_s1", "feat_s0"):
        assert _rel(getattr(fp, k), fr_[k]) < 1e-5, k
    # The key rows' layout: pixel (2y + a, 2x + d) of feat_s1 and
    # (4y + 2a + e, 4x + 2d + f) of feat_s0, token n = 8 y + x.
    y, x_, a, d, e, f = 3, 5, 1, 0, 1, 1
    n = 8 * y + x_
    assert torch.equal(fp.res1[n, (2 * a + d) * 64:(2 * a + d + 1) * 64],
                       fp.feat_s1[0, 2 * y + a, 2 * x_ + d])
    assert torch.equal(
        fp.res0[n, 2 * a + d, (2 * e + f) * 32:(2 * e + f + 1) * 32],
        fp.feat_s0[0, 4 * y + 2 * a + e, 4 * x_ + 2 * d + f])


def test_the_decoder_matches_with_its_three_options(pair, image):
    p, r = pair
    x = torch.from_numpy(image)
    pts = ref.grid_points(4, SIZE, "cpu")[0][:, None, :]
    with torch.no_grad():
        fp, fr_ = p.encode(p.preprocess(x)[0][None]), r.encode(
            r.preprocess(x)[None])
        tokens = []
        hook = p.sam_mask_decoder.transformer.register_forward_hook(
            lambda m, i, o: tokens.append(o[0]))
        lp, ip = p.decode_points(fp, pts)
        hook.remove()
        lr, ir, hr = r.decode_points(fr_, pts)
    assert tokens[0].shape == (16, 8, 256)  # 6 output tokens, 2 prompt
    assert _rel(tokens[0], hr) < 1e-5
    assert _rel(lp, lr) < 1e-5
    assert ((ip > 0) & (ip < 1)).all()  # the sigmoid
    torch.testing.assert_close(ip, ir, atol=1e-6, rtol=0)
    # The fused route's transformer part returns the same IoUs, and the
    # tail on its keys the same logits.
    with torch.no_grad():
        keys, hyper, iou = p.decode_points_pre(fp, pts)
        tail = p.decode_tail(keys, hyper, 8, 8, fp)
    torch.testing.assert_close(iou, ip, atol=0, rtol=0)
    assert _rel(tail, lp) < 1e-6


def test_the_object_score_token_and_the_residuals_are_read(pair, image):
    p, _ = pair
    pts = ref.grid_points(4, SIZE, "cpu")[0][:4, None, :]
    with torch.no_grad():
        fp = p.encode(p.preprocess(torch.from_numpy(image))[0][None])
        base, _ = p.decode_points(fp, pts)
        dec = p.sam_mask_decoder
        saved = dec.obj_score_token.clone()
        dec.obj_score_token.mul_(2.0)
        moved, _ = p.decode_points(fp, pts)
        dec.obj_score_token.copy_(saved)
        zero = fp._replace(res0=torch.zeros_like(fp.res0))
        keys, hyper, _ = p.decode_points_pre(fp, pts)
        no_s0 = p.decode_tail(keys, hyper, 8, 8, zero)
    assert _rel(moved, base) > 1e-3
    assert _rel(no_s0, base) > 1e-2


def test_plain_k5_at_width_72_with_fewer_queries():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(6, 16, 72, generator=g)
    k = torch.randn(6, 64, 72, generator=g)
    v = torch.randn(6, 64, 72, generator=g)
    got = flash_attention(q, k, v)
    qd, kd, vd = q.double(), k.double(), v.double()
    want = torch.softmax(qd @ kd.transpose(1, 2) / math.sqrt(72), -1) @ vd
    assert got.shape == (6, 16, 72)
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)


def test_plain_k6_with_residuals_matches_the_tail(pair, image, monkeypatch):
    p, _ = pair
    pts = ref.grid_points(4, SIZE, "cpu")[0][:6, None, :]
    with torch.no_grad():
        fp = p.encode(p.preprocess(torch.from_numpy(image))[0][None])
        keys, hyper, _ = p.decode_points_pre(fp, pts)
        hyper3 = hyper[:, 1:].contiguous()
        stats = dt.decode_tail_stats(keys, hyper3,
                                     **p.decoder_tail_params(fp),
                                     mask_threshold=0.0,
                                     stability_offset=1.0)
        monkeypatch.setattr(F, "gelu", lambda x: x * torch.sigmoid(1.702 * x))
        logits = p.decode_tail(keys, hyper3, 8, 8, fp)
    stab, boxes, n_pos = dt.fold_stats(stats, SIZE / 32)
    want_stab = amg.calculate_stability_score(logits, 0.0, 1.0)
    want_pos = (logits > 0).sum((-2, -1)).float()
    want_boxes = amg.mask_to_box(logits > 0) * (SIZE / 32)
    assert (want_pos > 50).all()
    torch.testing.assert_close(n_pos, want_pos, atol=3, rtol=0)
    torch.testing.assert_close(stab, want_stab, atol=1e-2, rtol=0)
    torch.testing.assert_close(boxes, want_boxes, atol=4, rtol=0)


class _Ref(serve._Driven):
    """The reference behind the generator, in float32, no fp8."""


@pytest.mark.parametrize("fused", [False, True])
def test_the_generator_end_to_end_on_a_4_x_4_grid(pair, image, fused):
    p, r = pair
    seg = SegmentorConfig(model_type="sam2.1_hiera_l", points_per_side=4,
                          points_per_batch=8, pred_iou_thresh=-1e9,
                          stability_score_thresh=-1e9,
                          segmentor_width_size=0)
    with timer.recording() as rec:
        mine = amg.SamAutomaticMaskGenerator(
            p, dataclasses.replace(seg, fused_tail=fused)).generate_masks(
            image)
    theirs = amg.SamAutomaticMaskGenerator(
        _Ref(r, seg),
        dataclasses.replace(seg, fused_tail=False)).generate_masks(image)
    n = len(theirs["masks"])
    assert n > 0 and mine["masks"].shape == (n, 96, 128)
    if fused:  # K6's sigmoid GELU orders the candidates; compare as sets
        order = np.lexsort(mine["boxes"].T[::-1])
        ref_order = np.lexsort(theirs["boxes"].T[::-1])
        mine = {k: v[order] for k, v in mine.items()}
        theirs = {k: v[ref_order] for k, v in theirs.items()}
    np.testing.assert_array_equal(mine["masks"], theirs["masks"])
    np.testing.assert_allclose(mine["boxes"], theirs["boxes"], atol=1e-3)
    names = {s[0] for s in rec.spans}
    assert {"encoder", "amg_decode", "amg_select", "hiera.stage1",
            "hiera.stage4", "sam2.neck"} <= names
    rows = sum(n for name, n, _, _ in rec.counts
               if name == "hiera.attn_rows_plain")
    calls = serve.hiera_calls(p.image_encoder.trunk, SIZE // 4, 4)
    assert rows == sum(BH * Nq for BH, Nq, _, _, _ in calls)
