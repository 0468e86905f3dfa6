"""The port's BOP providers, PBR onboarding crops, image-header reader and
`render_bop_templates` against the JAX package and PIL.

Trees: the JAX tests' own writers (`tests/test_bop_eval.py:mini_bop`,
`tests/test_bop_pbr.py:_make_pbr_dataset`, both PNG) and
`tests/helpers/bop_tree.py` at 96 x 128 (two objects; PNG test frames,
JPEG train_pbr frames).  Tolerance: none -- every array is equal
(`load_objects`' samples, diameter and symmetry flag; `load_frame`;
every array of `get_frame_instances`; the PBR scan, the views selected
and the crops and masks of `load_pbr_onboarding_templates`; the
rendered template PNGs and xyz).  `image_width` equals PIL's
`Image.open(p).size[0]`.  The JAX renderer takes the C++ rasterizer when
it is built, and so does the port's; here `sam6d_tpu.utils.native.
rasterize` and `sam6d_tpu_torch.utils.native.rasterize` return None, so
both packages render with their numpy rasterizers.
"""

import dataclasses
import io
import json
import os
import pathlib
import shutil
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import sam6d_tpu.config as jc
import sam6d_tpu.utils.native
import sam6d_tpu_torch.config as tc
import sam6d_tpu_torch.utils.native
from sam6d_tpu.pipeline import renderer as j_render
from sam6d_tpu.provider import bop as j_bop
from sam6d_tpu.provider import bop_pbr as j_pbr
from sam6d_tpu_torch.pipeline import renderer as t_render
from sam6d_tpu_torch.provider import bop as t_bop
from sam6d_tpu_torch.provider import bop_pbr as t_pbr
from sam6d_tpu_torch.utils.image_header import image_width
from sam6d_tpu_torch.utils.png import read_png, write_png
from tests.test_bop_eval import mini_bop  # noqa: F401  (the fixture)
from tests.test_bop_pbr import _make_pbr_dataset
from tests.test_torch_pem import tiny_config

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import bop_tree  # noqa: E402
from jpeg_writer import encode_jpeg, write_jpeg  # noqa: E402


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop_tree") / "lmo"
    bop_tree.write_bop_tree(root, height=96, width=128, n_test=2, n_pbr=4)
    det_path = str(root.parent / "gt_detections.json")
    bop_tree.save_json(det_path, bop_tree.gt_detections(root))
    return {"dataset_dir": str(root), "det_path": det_path}


@pytest.fixture(scope="module")
def pbr_png(tmp_path_factory):
    return _make_pbr_dataset(str(tmp_path_factory.mktemp("pbr")))


def assert_tree_equal(got, want):
    """Nested dicts / lists / arrays / scalars equal, types aside."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def objects_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = dataclasses.asdict(got[k]), dataclasses.asdict(want[k])
        assert_tree_equal(g, w)


# -- provider/bop.py ---------------------------------------------------------

@pytest.mark.parametrize("which", ["mini_bop", "tree"])
def test_load_objects_and_listings_match(which, request):
    ds = request.getfixturevalue(which)["dataset_dir"]
    models = os.path.join(ds, "models")
    for kw in ({"n_sample": 32}, {"n_sample": 64, "template_root": "/t",
                                  "seed": 3}):
        objects_equal(t_bop.load_objects(models, **kw),
                      j_bop.load_objects(models, **kw))
    assert t_bop.list_scenes(ds) == j_bop.list_scenes(ds)
    for scene in j_bop.list_scenes(ds):
        assert t_bop.list_frames(scene) == j_bop.list_frames(scene)
    assert t_bop.LMO_OBJECT_IDS == j_bop.LMO_OBJECT_IDS


def test_load_objects_default_diameter_and_symmetry(tree, tmp_path):
    """No models_info.json: the reference's 2000 * radius / 2 default and
    no symmetry; with it, the symmetry flag of each listing kind."""
    for oid in bop_tree.OBJ_IDS:
        shutil.copy(os.path.join(tree["dataset_dir"], "models",
                                 f"obj_{oid:06d}.ply"), tmp_path)
    got = t_bop.load_objects(str(tmp_path), n_sample=16)
    objects_equal(got, j_bop.load_objects(str(tmp_path), n_sample=16))
    assert not any(o.symmetry for o in got.values())
    with_info = t_bop.load_objects(
        os.path.join(tree["dataset_dir"], "models"), n_sample=16)
    assert all(o.symmetry for o in with_info.values())


def test_load_frame_matches_on_png_jpeg_and_grey(tree, tmp_path):
    scene = pathlib.Path(tree["dataset_dir"]) / "test" / "000001"
    for im in t_bop.list_frames(str(scene)):
        assert_tree_equal(t_bop.load_frame(str(scene), im),
                          j_bop.load_frame(str(scene), im))
    # Frame 0 as a JPEG, frame 1 as a grey PNG.
    copy = tmp_path / "000001"
    shutil.copytree(scene, copy)
    rgb0 = read_png(str(copy / "rgb" / "000000.png"))
    os.remove(copy / "rgb" / "000000.png")
    write_jpeg(str(copy / "rgb" / "000000.jpg"), rgb0, 90, "4:2:0")
    rgb1 = read_png(str(copy / "rgb" / "000001.png"))
    write_png(str(copy / "rgb" / "000001.png"), rgb1[..., 1])
    assert t_bop.list_frames(str(copy)) == [0, 1]
    for im in (0, 1):
        got = t_bop.load_frame(str(copy), im)
        assert_tree_equal(got, j_bop.load_frame(str(copy), im))
        assert got[0].shape == rgb0.shape


@pytest.mark.parametrize("which", ["mini_bop", "tree"])
def test_frame_instances_match(which, request):
    fx = request.getfixturevalue(which)
    ds = fx["dataset_dir"]
    sets = []
    for c, bop in ((jc, j_bop), (tc, t_bop)):
        cfg = tiny_config(c)
        objs = bop.load_objects(os.path.join(ds, "models"),
                                n_sample=cfg.n_sample_model_point)
        sets.append(bop.BOPTestset(cfg, ds, objs).load_detections(
            fx["det_path"]))
    jset, tset = sets
    assert tset.frames() == jset.frames() and tset.frames()
    assert tset.cfg_min_points() == jset.cfg_min_points() == 8
    assert tset.seg_filter_score == jset.seg_filter_score == 0.25
    n = 0
    for key in jset.frames():
        # Twice: each frame draws from a new RandomState(seed).
        for _ in range(2):
            got, want = tset.get_frame_instances(*key), \
                jset.get_frame_instances(*key)
            assert_tree_equal(got, want)
        n += len(want[0]["pts"])
    assert n == len(jset.detections)


def test_low_scores_and_unknown_objects_are_dropped(tree, tmp_path):
    dets = json.load(open(tree["det_path"]))
    dets[0]["score"] = 0.25  # not above seg_filter_score
    dets[1]["category_id"] = 99  # no such object
    path = str(tmp_path / "dets.json")
    bop_tree.save_json(path, dets)
    ds = tree["dataset_dir"]
    out = []
    for c, bop in ((jc, j_bop), (tc, t_bop)):
        cfg = tiny_config(c)
        objs = bop.load_objects(os.path.join(ds, "models"), n_sample=32)
        ts = bop.BOPTestset(cfg, ds, objs).load_detections(path)
        out.append([ts.get_frame_instances(*k) for k in ts.frames()])
    assert_tree_equal(out[1], out[0])
    assert out[1][0][0] is None  # frame 0 kept only the unknown object
    assert len(out[1][1][0]["pts"]) == 2


# -- provider/bop_pbr.py -----------------------------------------------------

def pbr_root(which, request):
    fx = request.getfixturevalue(which)
    return fx if isinstance(fx, str) else fx["dataset_dir"]


def instances_equal(got, want):
    assert sorted(got) == sorted(want)
    for oid in want:
        assert len(got[oid]) == len(want[oid])
        for g, w in zip(got[oid], want[oid]):
            assert_tree_equal(dataclasses.asdict(g), dataclasses.asdict(w))


@pytest.mark.parametrize("which", ["pbr_png", "tree"])
def test_pbr_scan_and_selection_match(which, request):
    root = pbr_root(which, request)
    for kw in ({}, {"max_scenes": 1}, {"max_frames": 1},
               {"min_visib_fract": 0.0}):
        instances_equal(t_pbr.scan_pbr_instances(root, **kw),
                        j_pbr.scan_pbr_instances(root, **kw))
    t_per, j_per = (p.scan_pbr_instances(root) for p in (t_pbr, j_pbr))
    instances_equal({oid: t_pbr.select_views_per_template(v)
                     for oid, v in t_per.items()},
                    {oid: j_pbr.select_views_per_template(v)
                     for oid, v in j_per.items()})


@pytest.mark.parametrize("which", ["pbr_png", "tree"])
def test_pbr_onboarding_crops_match(which, request):
    """Crops and masks equal, the float32 round trip's truncation
    included (on the JPEG tree the frames decode through utils/jpeg)."""
    root = pbr_root(which, request)
    per_obj = j_pbr.scan_pbr_instances(root)
    for oid in sorted(per_obj):
        for size in (28, 64):
            got = t_pbr.load_pbr_onboarding_templates(
                root, oid, image_size=size)
            want = j_pbr.load_pbr_onboarding_templates(
                root, oid, image_size=size, per_obj=per_obj)
            assert_tree_equal(got, want)
            assert got[1].reshape(len(got[1]), -1).any(axis=1).all()
    with pytest.raises(ValueError, match="no train_pbr instances"):
        t_pbr.load_pbr_onboarding_templates(root, 99)


def test_pbr_crop_of_an_empty_mask_is_zero(tree):
    inst = t_pbr.scan_pbr_instances(tree["dataset_dir"])[1][0]
    scene = pathlib.Path(inst.scene_dir)
    path = scene / "mask_visib" / f"{inst.frame_id:06d}_{inst.idx_obj:06d}.png"
    keep = path.read_bytes()
    try:
        write_png(str(path), np.zeros((96, 128), np.uint8))
        got = t_pbr._load_instance_crop(inst, 32)
        want = j_pbr._load_instance_crop(
            j_pbr.PBRInstance(**dataclasses.asdict(inst)), 32)
    finally:
        path.write_bytes(keep)
    assert_tree_equal(got, want)
    assert not got[1].any() and not got[0].any()


def _pil_png(img, mode=None):
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "jpeg-L",
                                  "jpeg-RGB"])
def test_read_rgb_is_pils_convert_rgb(mode, tmp_path):
    rng = np.random.RandomState(0)
    if mode.startswith("jpeg"):
        shape = (21, 30) if mode == "jpeg-L" else (21, 30, 3)
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        path = tmp_path / "f.jpg"
        Image.fromarray(img).save(path, quality=90)
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        img = (rng.rand(21, 30, c) * 255).astype(np.uint8)
        path = tmp_path / "f.png"
        path.write_bytes(_pil_png(img[..., 0] if c == 1 else img, mode))
    want = np.asarray(Image.open(path).convert("RGB"))
    got = t_pbr.read_rgb(str(path))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == want.shape


def test_read_rgb_refuses_what_it_cannot_convert(tmp_path):
    p16 = tmp_path / "d.png"
    write_png(str(p16), np.arange(12, dtype=np.uint16).reshape(3, 4))
    with pytest.raises(ValueError, match="uint16"):
        t_pbr.read_rgb(str(p16))
    pal = tmp_path / "p.png"
    Image.fromarray(np.zeros((3, 4), np.uint8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="palette"):
        t_pbr.read_rgb(str(pal))


# -- utils/image_header.py ---------------------------------------------------

def _tiff(order: str, kind: int, W: int = 37, H: int = 5) -> bytes:
    """A one-strip 8-bit grey TIFF whose ImageWidth is of field type
    `kind` (3 SHORT, 4 LONG) in byte order `order` ('<' II, '>' MM); the
    IFD after the pixels, so its offset is taken, not assumed."""
    pixels = bytes(W * H)
    ifd_at = 8 + len(pixels) + (len(pixels) & 1)

    def entry(tag, typ, value):
        if typ == 3:
            v = struct.pack(order + "HH", value, 0)
        else:
            v = struct.pack(order + "I", value)
        return struct.pack(order + "HHI", tag, typ, 1) + v

    entries = [entry(256, kind, W), entry(257, 3, H), entry(258, 3, 8),
               entry(259, 3, 1), entry(262, 3, 1), entry(273, 4, 8),
               entry(277, 3, 1), entry(278, 3, H), entry(279, 4, W * H)]
    head = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "HI", 42, ifd_at)
    body = pixels + b"\0" * (ifd_at - 8 - len(pixels))
    ifd = (struct.pack(order + "H", len(entries)) + b"".join(entries)
           + struct.pack(order + "I", 0))
    return head + body + ifd


def test_image_width_equals_pils(tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(19, 45, 3) * 255).astype(np.uint8)
    files = {
        "pil.png": _pil_png(img),
        "port16.png": None,
        "pil.jpg": None, "pil_progressive.jpg": None, "pil_exif.jpg": None,
        "writer.jpg": encode_jpeg(img, 95, "4:2:0"),
        "ii_short.tif": _tiff("<", 3), "ii_long.tif": _tiff("<", 4),
        "mm_short.tif": _tiff(">", 3, W=70000 % 65536),
        "mm_long.tif": _tiff(">", 4, W=301),
    }
    for name, data in files.items():
        if data is not None:
            (tmp_path / name).write_bytes(data)
    write_png(str(tmp_path / "port16.png"),
              np.zeros((7, 1234), np.uint16))
    Image.fromarray(img).save(tmp_path / "pil.jpg", quality=80)
    Image.fromarray(img).save(tmp_path / "pil_progressive.jpg",
                              progressive=True)
    exif = Image.Exif()
    exif[0x010F] = "maker" * 200  # a long APP1 before the frame
    Image.fromarray(img).save(tmp_path / "pil_exif.jpg", exif=exif)
    Image.fromarray(img).save(tmp_path / "pil.tif")
    for p in sorted(tmp_path.iterdir()):
        with Image.open(p) as im:
            assert image_width(str(p)) == im.size[0], p.name
    (tmp_path / "x.bmp").write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="not a PNG, JPEG or TIFF"):
        image_width(str(tmp_path / "x.bmp"))


# -- render_bop_templates ----------------------------------------------------

def test_render_bop_templates_matches(tree, tmp_path, monkeypatch):
    """Both meshes of the tree, 42 views at 48 px: the PNGs' pixels and
    the xyz arrays equal (the numpy rasterizer on both sides)."""
    monkeypatch.setattr(sam6d_tpu.utils.native, "rasterize",
                        lambda *a, **k: None)
    monkeypatch.setattr(sam6d_tpu_torch.utils.native, "rasterize",
                        lambda *a, **k: None)
    models = os.path.join(tree["dataset_dir"], "models")
    j_render.render_bop_templates(models, str(tmp_path / "j"), 48)
    t_render.render_bop_templates(models, str(tmp_path / "t"), 48)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        f"obj_{oid:06d}" for oid in bop_tree.OBJ_IDS]
    for obj in names:
        files = sorted(os.listdir(tmp_path / "j" / obj))
        assert files == sorted(os.listdir(tmp_path / "t" / obj))
        assert len(files) == 3 * 42
        for f in files:
            jp, tp = tmp_path / "j" / obj / f, tmp_path / "t" / obj / f
            if f.endswith(".png"):
                want, got = np.asarray(Image.open(jp)), read_png(str(tp))
            else:
                want, got = np.load(jp), np.load(tp)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        mask = read_png(str(tmp_path / "t" / obj / "mask_0.png"))
        assert mask.any()
