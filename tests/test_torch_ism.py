"""The ISM serving slice of the port against the JAX package on the CPU.

Same weights on both sides (the JAX variables carried across by
`sam6d_tpu_torch.params`, with non-zero rel-pos tables, biases and norm
scales so that every parameter path is exercised), same numpy inputs.
The sizes are the tiny configurations of the JAX package's own tests:
SAM in the vit_b layout at img 64, embed 32, depth 2, window 2, global
block 1 (tests/test_ism.py:tiny_sam), and DINOv2 at 28 x 28 crops,
embed 32, depth 2, 2 heads.

Tolerances, float32 throughout:
* modules (encoder, prompt encoder, decoder, DINOv2, scores): atol 1e-5
  against outputs of order 1-10 -- float32 rounding in another
  summation order;
* resampling weights: 1e-6 (the same formula in float32);
* the PIL resize: one grey level (PIL rounds fixed-point weights);
* the slice (generate_masks, onboard_templates + detect): the same number
  of proposals, masks agreeing on more than 99.9% of pixels after
  aligning by score, boxes within 3 px, scores within 1e-4 and the same
  object ids.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from sam6d_tpu.models.ism import scoring as jscore
from sam6d_tpu.models.ism.detector import ISMDetector as JDetector
from sam6d_tpu.models.ism.dinov2 import DescriptorModel as JDesc
from sam6d_tpu.models.ism.sam.amg import SamAutomaticMaskGenerator as JAMG
from sam6d_tpu.models.ism.sam.amg import _resize_matrix
from sam6d_tpu.models.ism.sam.decoder import MaskDecoder as JDecoder
from sam6d_tpu.models.ism.sam.encoder import ImageEncoderViT as JEncoder
from sam6d_tpu.models.ism.sam.model import SAM as JSAM
from sam6d_tpu.models.ism.sam.prompt import PromptEncoder as JPrompt
from sam6d_tpu.utils import bbox as jbbox
from sam6d_tpu.utils.detections import Detections as JDetections
from sam6d_tpu_torch.models.ism import scoring as tscore
from sam6d_tpu_torch.models.ism.detector import ISMDetector as TDetector
from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel as TDesc
from sam6d_tpu_torch.models.ism.sam.amg import SamAutomaticMaskGenerator as TAMG
from sam6d_tpu_torch.models.ism.sam.encoder import ImageEncoderViT as TEncoder
from sam6d_tpu_torch.models.ism.sam.model import SAM as TSAM
from sam6d_tpu_torch.models.layers import cast_dense_weights
from sam6d_tpu_torch.params import (
    flax_to_state_dict,
    init_random_,
    sam_state_dict,
)
from sam6d_tpu_torch.utils import bbox as tbbox
from sam6d_tpu_torch.utils.detections import Detections as TDetections

torch.set_num_threads(2)

ATOL = 1e-5
TINY_ENCODER = dict(embed_dim=32, depth=2, num_heads=2,
                    global_attn_indexes=(1,), window_size=2)
TINY_DESC = dict(image_size=28, patch_size=14, embed_dim=32, depth=2,
                 num_heads=2)


def random_variables(shapes, seed):
    """Seeded numpy variables of the given shapes, without running the
    (slow, eager) flax init: LeCun-normal kernels, N(0, 1) tokens and
    Fourier features, N(0, 0.02) position embeddings, and non-zero
    rel-pos tables, biases, norm scales and LayerScale gammas so that
    every parameter path is exercised."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        r = rng.randn(*s.shape).astype(np.float32)
        if leaf == "kernel":
            return r / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if leaf == "pos_embed":
            return r * np.float32(0.02)
        if leaf in ("scale", "weight", "gamma"):
            return 1.0 + np.float32(0.05) * r
        if leaf.startswith("rel_pos"):
            return np.float32(0.1) * r
        if leaf == "bias":
            return np.float32(0.05) * r
        return r

    return jax.tree_util.tree_map_with_path(fill, shapes)


def sam_variables(jsam, seed):
    key = jax.random.PRNGKey(0)
    s = jsam.input_size
    eh, ew = jsam.prompt_encoder.image_embedding_size
    grid = jnp.zeros((1, eh, ew, 256))
    shapes = {
        "encoder": jax.eval_shape(jsam.encoder.init, key,
                                  jnp.zeros((1, s, s, 3))),
        "prompt": jax.eval_shape(
            lambda k: jsam.prompt_encoder.init(
                k, jnp.zeros((1, 1, 2)), jnp.zeros((1, 1), jnp.int32),
                jnp.zeros((1, 4)), jnp.zeros((1, 4 * eh, 4 * ew, 1)),
                method=JPrompt.__call__), key),
        "decoder": jax.eval_shape(jsam.decoder.init, key, grid, grid,
                                  jnp.zeros((1, 2, 256)), grid),
    }
    return random_variables(shapes, seed)


@pytest.fixture(scope="module")
def tiny():
    jsam = JSAM(model_type="vit_b", img_size=64, encoder_kwargs=TINY_ENCODER)
    jsam.variables = sam_variables(jsam, 0)
    tsam = TSAM("vit_b", 64, encoder_kwargs=TINY_ENCODER, device="cpu")
    tsam.load_state_dict(sam_state_dict(jsam.variables))
    jdesc = JDesc(jc.DescriptorConfig(**TINY_DESC))
    desc_vars = random_variables(
        jax.eval_shape(jdesc.init, jax.random.PRNGKey(1)), 1)
    tdesc = TDesc(tc.DescriptorConfig(**TINY_DESC))
    tdesc.vit.load_state_dict(flax_to_state_dict(desc_vars))
    return dict(jsam=jsam, tsam=tsam.eval(), jdesc=jdesc,
                desc_vars=desc_vars, tdesc=tdesc.eval())


def test_weight_bridge_is_complete_and_keeps_layouts(tiny):
    # The loads in the fixture are strict: every JAX leaf has a port
    # parameter except the mask-prompt path's, which is not ported.
    v = tiny["jsam"].variables
    sd = sam_state_dict(v)
    skipped = [k for k in flax_to_state_dict(v["prompt"])
               if k.startswith("mask_downscaling")]
    assert len(skipped) == 10  # 3 convs and 2 norms: weight and bias
    assert set(sd) == set(tiny["tsam"].state_dict())
    p = v["encoder"]["params"]
    np.testing.assert_array_equal(sd["encoder.neck_2.kernel"].numpy(),
                                  p["neck_2"]["kernel"])
    np.testing.assert_array_equal(
        sd["encoder.blocks_0.attn.rel_pos_h"].numpy(),
        p["blocks_0"]["attn"]["rel_pos_h"])
    np.testing.assert_array_equal(
        sd["decoder.output_upscaling_0.kernel"].numpy(),
        v["decoder"]["params"]["output_upscaling_0"]["kernel"])
    np.testing.assert_array_equal(
        sd["encoder.blocks_1.attn.qkv.weight"].numpy(),
        p["blocks_1"]["attn"]["qkv"]["kernel"].T)


def test_random_init_follows_the_jax_scheme():
    gen = torch.Generator().manual_seed(0)
    sam = init_random_(TSAM("vit_b", 64, encoder_kwargs=TINY_ENCODER,
                            device="cpu"), gen).requires_grad_(False)
    desc = init_random_(TDesc(tc.DescriptorConfig(**TINY_DESC)), gen)
    assert float(sam.prompt.point_embed_1.std()) > 0.5  # N(0, 1)
    assert float(sam.decoder.mask_tokens.std()) > 0.5
    assert float(sam.encoder.blocks_0.attn.rel_pos_h.abs().max()) == 0.0
    assert float(sam.encoder.neck_0.kernel.std()) > 0.0
    assert torch.equal(desc.vit.blocks_0.ls1.gamma,
                       torch.ones_like(desc.vit.blocks_0.ls1.gamma))


@pytest.mark.parametrize("img,patch,window", [
    (32, 8, 2),   # 4 x 4 grid, windows tile it
    (48, 8, 4),   # 6 x 6 grid, windows pad it to 8 x 8
])
def test_image_encoder_matches(rng, img, patch, window):
    kw = dict(img_size=img, patch_size=patch, embed_dim=32, depth=2,
              num_heads=2, window_size=window, global_attn_indexes=(1,))
    x = rng.randn(2, img, img, 3).astype(np.float32)
    jenc = JEncoder(**kw)
    variables = random_variables(
        jax.eval_shape(jenc.init, jax.random.PRNGKey(2), jnp.asarray(x)), 2)
    want = np.asarray(jax.jit(jenc.apply)(variables, jnp.asarray(x)))
    tenc = TEncoder(**kw)
    tenc.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        got = tenc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, img // patch, img // patch, 256)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cast_dense_weights_stores_the_rel_pos_tables_in_bf16(rng):
    # K4 takes the tables in the compute dtype; stored so once, the
    # encoder's forward casts nothing and computes the same bits.
    kw = dict(img_size=48, patch_size=8, embed_dim=32, depth=2, num_heads=2,
              window_size=4, global_attn_indexes=(1,), dtype=torch.bfloat16)
    x = torch.from_numpy(rng.randn(1, 48, 48, 3).astype(np.float32))
    enc = init_random_(TEncoder(**kw), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            if "rel_pos" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        want = enc(x)
        cast_dense_weights(enc)
        got = enc(x)
    for b in range(2):
        attn = getattr(enc, f"blocks_{b}").attn
        assert attn.rel_pos_h.dtype == attn.rel_pos_w.dtype == torch.bfloat16
        assert attn.qkv.weight.dtype == torch.bfloat16
    assert enc.pos_embed.dtype == torch.float32  # cast at use, not stored
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_prompt_encoder_points_match(tiny, rng):
    jsam, tsam = tiny["jsam"], tiny["tsam"]
    pts = (rng.rand(5, 1, 2) * 64).astype(np.float32)
    labels = np.array([[1], [0], [1], [-1], [1]], np.int32)
    pv = jsam.variables["prompt"]
    want = np.asarray(jsam.prompt_encoder.apply(
        pv, jnp.asarray(pts), jnp.asarray(labels),
        method=JPrompt.encode_points))
    pe = np.asarray(jsam.prompt_encoder.apply(pv, method=JPrompt.dense_pe))
    dense = np.asarray(jsam.prompt_encoder.apply(
        pv, 3, method=JPrompt.no_mask_dense))
    with torch.no_grad():
        got = tsam.prompt.encode_points(torch.from_numpy(pts),
                                        torch.from_numpy(labels).long())
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        np.testing.assert_allclose(tsam.prompt.dense_pe().numpy(), pe,
                                   atol=ATOL)
        np.testing.assert_allclose(tsam.prompt.no_mask_dense(3).numpy(),
                                   dense, atol=0)


def test_mask_decoder_matches(tiny, rng):
    jsam, tsam = tiny["jsam"], tiny["tsam"]
    dv = jsam.variables["decoder"]
    h = 4
    emb = (rng.randn(1, h, h, 256) * 0.5).astype(np.float32)
    pe = (rng.randn(1, h, h, 256) * 0.5).astype(np.float32)
    sparse = (rng.randn(5, 2, 256) * 0.5).astype(np.float32)
    dense = (rng.randn(1, h, h, 256) * 0.5).astype(np.float32)
    args = tuple(map(jnp.asarray, (emb, pe, sparse, dense)))
    targs = tuple(map(torch.from_numpy, (emb, pe, sparse, dense)))
    masks, iou = jax.jit(jsam.decoder.apply)(dv, *args)
    keys, hyper, iou2 = jax.jit(lambda *a: jsam.decoder.apply(
        dv, *a, method=JDecoder.transformer_forward))(*args)
    with torch.no_grad():
        tmasks, tiou = tsam.decoder(*targs)
        tkeys, thyper, tiou2 = tsam.decoder.transformer_forward(*targs)
        params = tsam.decoder_tail_params()
    assert tmasks.shape == (5, 4, 16, 16)
    for got, want in ((tmasks, masks), (tiou, iou), (tkeys, keys),
                      (thyper, hyper), (tiou2, iou2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want_params = jsam.decoder.apply(dv, method=JDecoder.tail_kernel_params)
    for k, v in want_params.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v))


def test_dinov2_descriptors_match(tiny, rng):
    jdesc, tdesc, dv = tiny["jdesc"], tiny["tdesc"], tiny["desc_vars"]
    imgs = rng.randn(3, 28, 28, 3).astype(np.float32)
    masks = rng.rand(3, 28, 28) > 0.4
    cls, patch = jax.jit(jdesc.compute_cls_and_patch)(
        dv, jnp.asarray(imgs), jnp.asarray(masks))
    jcls, jpatch = jax.jit(jdesc.vit.apply)(dv, jnp.asarray(imgs))
    with torch.no_grad():
        tcls, tpatch = tdesc.compute_cls_and_patch(torch.from_numpy(imgs),
                                                   torch.from_numpy(masks))
        vcls, vpatch = tdesc.vit(torch.from_numpy(imgs))
    for got, want in ((tcls, cls), (tpatch, patch), (vcls, jcls),
                      (vpatch, jpatch)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("aggregation", ["avg_5", "mean", "max", "median"])
def test_scores_match(rng, aggregation):
    q = rng.randn(6, 16).astype(np.float32)
    ref = rng.randn(2, 7, 16).astype(np.float32)
    want = jscore.semantic_score(jnp.asarray(q), jnp.asarray(ref),
                                 aggregation)
    got = tscore.semantic_score(torch.from_numpy(q), torch.from_numpy(ref),
                                aggregation)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    qp = rng.randn(6, 4, 16).astype(np.float32)
    qp /= np.linalg.norm(qp, axis=-1, keepdims=True)
    qp[:, 2:] *= rng.rand(6, 2, 1) > 0.5  # some invalid patches
    rp = rng.randn(6, 4, 16).astype(np.float32)
    rp /= np.linalg.norm(rp, axis=-1, keepdims=True)
    for jf, tf in ((jscore.appearance_score, tscore.appearance_score),
                   (jscore.visible_ratio, tscore.visible_ratio)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(qp), torch.from_numpy(rp)).numpy(),
            np.asarray(jf(jnp.asarray(qp), jnp.asarray(rp))), atol=ATOL)
    uv = (rng.rand(6, 20, 2) * 60).astype(np.float32)
    boxes = np.sort(rng.rand(6, 2, 2) * 60, axis=1).reshape(6, 4)
    boxes = boxes[:, [0, 2, 1, 3]].astype(np.float32)
    np.testing.assert_allclose(
        tscore.geometric_score(torch.from_numpy(uv),
                               torch.from_numpy(boxes)).numpy(),
        np.asarray(jscore.geometric_score(jnp.asarray(uv),
                                          jnp.asarray(boxes))), atol=ATOL)
    s = [rng.rand(6).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        tscore.final_score(*map(torch.from_numpy, s)).numpy(),
        np.asarray(jscore.final_score(*map(jnp.asarray, s))), atol=1e-7)


@pytest.mark.parametrize("src,dst", [(256, 1024), (768, 480), (1024, 768),
                                     (7, 3), (5, 5)])
def test_resize_matrix_matches_jax_image_resize(src, dst):
    np.testing.assert_allclose(tbbox.resize_matrix(src, dst).numpy(),
                               np.asarray(_resize_matrix(src, dst)),
                               atol=1e-6)


def test_crop_resize_pad_matches_scale_and_translate(rng):
    img = rng.rand(240, 320, 3).astype(np.float32)
    boxes = np.array([[10, 5, 300, 235],           # larger than 224: down
                      [100.5, 50.2, 130.7, 90.1],  # smaller: up
                      [0, 0, 319, 239],
                      [0, 0, 2, 2]], np.float32)
    # Eager JAX: jitted, XLA re-associates the weights' float32
    # arithmetic and moves the crops by ~3e-5.
    def crop(i, b):
        return jbbox.crop_resize_pad(i, b, 224)

    want = np.asarray(crop(jnp.asarray(img), jnp.asarray(boxes)))
    got = tbbox.crop_resize_pad(torch.from_numpy(img),
                                torch.from_numpy(boxes), 224).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # Masks as the detector crops them: each by its own box.
    masks = rng.rand(4, 240, 320) > 0.5
    want_m = np.stack([np.asarray(crop(
        jnp.asarray(m[..., None], jnp.float32), jnp.asarray(b[None])))[0, ..., 0]
        for m, b in zip(masks, boxes)])
    got_m = tbbox.crop_resize_pad_masks(torch.from_numpy(masks),
                                        torch.from_numpy(boxes), 224).numpy()
    np.testing.assert_allclose(got_m, want_m, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(768, 1024), (300, 640), (240, 320),
                                    (480, 1024)])
def test_pil_bilinear_resize_within_one_grey_level(rng, out_hw):
    img = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    h, w = out_hw
    want = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    got = tbbox.pil_bilinear_resize(torch.from_numpy(img), h, w).numpy()
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_geometry_and_square_bbox_match(rng):
    from sam6d_tpu.ops import geometry as jgeo
    from sam6d_tpu_torch.ops import geometry as tgeo

    pts = (rng.randn(3, 20, 3) * 0.1 + [0, 0, 1]).astype(np.float32)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
    np.testing.assert_allclose(
        tgeo.project_points(torch.from_numpy(pts), torch.from_numpy(K)),
        np.asarray(jgeo.project_points(jnp.asarray(pts), jnp.asarray(K))),
        rtol=1e-6)
    x = rng.randn(3, 20).astype(np.float32)
    m = rng.rand(3, 20) > 0.5
    np.testing.assert_allclose(
        tgeo.masked_mean(torch.from_numpy(x), torch.from_numpy(m), 1),
        np.asarray(jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m), 1)),
        atol=1e-6)
    for box in ((10, 30, 50, 90), (0, 5, 180, 200), (90, 100, 0, 3)):
        mask = np.zeros((100, 200), bool)
        mask[box[0]:box[1], box[2]:box[3]] = True
        assert tbbox.square_bbox(mask) == jbbox.square_bbox(mask)


def test_small_region_removal_matches(rng):
    from sam6d_tpu.models.ism.sam import amg as jamg
    from sam6d_tpu_torch.models.ism.sam import amg as tamg

    masks = rng.rand(3, 40, 50) > 0.45
    masks[2] = False
    want, wchanged = jamg.remove_small_regions_batch(masks, 12)
    got, gchanged = tamg.remove_small_regions_batch(masks, 12)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gchanged, wchanged)
    np.testing.assert_array_equal(tamg.masks_to_boxes(got),
                                  jamg.masks_to_boxes(want))


def test_detections_utilities_match(rng):
    masks = rng.rand(4, 20, 30) > 0.5
    boxes = np.array([[1, 2, 11, 12], [2, 3, 12, 13], [15, 4, 25, 14],
                      [0, 0, 3, 3]], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6], np.float32)
    ids = np.array([0, 0, 1, 2])
    jd = JDetections(masks=masks, boxes=boxes, scores=scores,
                     object_ids=ids).apply_nms_per_object_id(0.25)
    td = TDetections(masks=masks, boxes=boxes, scores=scores,
                     object_ids=ids).apply_nms_per_object_id(0.25)
    np.testing.assert_array_equal(td.boxes, jd.boxes)
    assert td.to_bop23(1, 2) == jd.to_bop23(1, 2)
    np.testing.assert_array_equal(
        TDetections(masks=masks, boxes=boxes).remove_very_small_detections(),
        JDetections(masks=masks, boxes=boxes).remove_very_small_detections())


def seg_kwargs(fused):
    # Thresholds opened so that proposals survive random weights; frames
    # at img_size with no width pre-resize, so both resizes are identities.
    return dict(points_per_side=4, points_per_batch=8,
                pred_iou_thresh=-1e9, stability_score_thresh=-1e9,
                box_nms_thresh=0.95, segmentor_width_size=0,
                fused_tail=fused)


def by_score(masks, boxes, key):
    order = np.argsort(-key, kind="stable")
    return masks[order], boxes[order], order


@pytest.mark.parametrize("fused", [False, True])
def test_generate_masks_matches(tiny, rng, fused):
    img = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    want = JAMG(tiny["jsam"], jc.SegmentorConfig(**seg_kwargs(fused))) \
        .generate_masks(img)
    got = TAMG(tiny["tsam"], tc.SegmentorConfig(**seg_kwargs(fused))) \
        .generate_masks(img)
    assert len(want["masks"]) > 1
    assert got["masks"].shape == want["masks"].shape
    # Both are in NMS order (by predicted IoU); areas break no ties here.
    assert (got["masks"] == want["masks"]).mean() > 0.999
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=3.0)


def test_onboard_and_detect_match(tiny, rng, tmp_path):
    seg = seg_kwargs(None)
    jcfg = jc.ISMConfig(segmentor=jc.SegmentorConfig(**seg),
                        descriptor=jc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    tcfg = tc.ISMConfig(segmentor=tc.SegmentorConfig(**seg),
                        descriptor=tc.DescriptorConfig(**TINY_DESC),
                        confidence_thresh=-1.0)
    jdet = JDetector(jcfg, JAMG(tiny["jsam"], jcfg.segmentor), tiny["jdesc"],
                     tiny["desc_vars"])
    tdet = TDetector(tcfg, TAMG(tiny["tsam"], tcfg.segmentor), tiny["tdesc"],
                     device="cpu")
    tem = dict(template_images=rng.rand(1, 3, 28, 28, 3).astype(np.float32),
               template_masks=rng.rand(1, 3, 28, 28) > 0.3,
               template_poses=np.broadcast_to(np.eye(4, dtype=np.float32),
                                              (3, 4, 4)).copy(),
               pointcloud=(rng.randn(1, 64, 3) * 0.05).astype(np.float32))
    jref = jdet.onboard_templates(**tem)
    cache = str(tmp_path / "ref.npz")
    tref = tdet.onboard_templates(**tem, cache_path=cache)
    np.testing.assert_allclose(tref.descriptors, jref.descriptors, atol=ATOL)
    np.testing.assert_allclose(tref.appe_descriptors, jref.appe_descriptors,
                               atol=ATOL)
    # A second onboarding reads the cache instead of computing.
    cached = TDetector(tcfg, None, tiny["tdesc"], device="cpu") \
        .onboard_templates(**tem, cache_path=cache)
    for k in ("descriptors", "appe_descriptors", "poses", "pointcloud"):
        np.testing.assert_array_equal(getattr(cached, k), getattr(tref, k))

    image = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
    depth = np.full((64, 64), 1.5, np.float32)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    want = jdet.detect(image, depth, K)
    got = tdet.detect(image, depth, K)
    assert len(want) > 0 and len(got) == len(want)
    wm, wb, wo = by_score(want.masks, want.boxes, want.scores)
    gm, gb, go = by_score(got.masks, got.boxes, got.scores)
    assert (gm == wm).mean() > 0.999
    np.testing.assert_allclose(gb, wb, atol=3.0)
    np.testing.assert_allclose(got.scores[go], want.scores[wo], atol=1e-4)
    np.testing.assert_array_equal(got.object_ids[go], want.object_ids[wo])
    for k in ("semantic_score", "appe_score", "geometric_score",
              "visible_ratio"):
        np.testing.assert_allclose(got.extras[k][go],
                                   np.asarray(want.extras[k])[wo],
                                   atol=1e-4, err_msg=k)
