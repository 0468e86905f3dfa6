"""The host end of the port's file demo against PIL and the JAX package.

The card's machine has no PIL and no JAX, so the port reads and writes
PNGs (`utils/png.py`) and resizes (`utils/resize.py`) itself; here both
are held to PIL bit for bit, every PNG filter type through files built
with zlib.  The numpy copies of JAX modules (mesh IO, template poses, RLE
decoding, bbox helpers, the numpy rasterizer), the renderer, the example
scene and the loaders of the PEM and the ISM are held to the JAX
package's functions on the same files: equal arrays, no tolerance.  The
JAX renderer and example scene take the C++ rasterizer when it is built,
and so do the port's; here both are sent through their numpy
rasterizers, which the port copies.
"""

import ast
import io
import json
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from sam6d_tpu.models.ism import onboarding as j_onb
from sam6d_tpu.pipeline import make_example as j_example
from sam6d_tpu.pipeline import pem_data as j_data
from sam6d_tpu.pipeline import renderer as j_render
from sam6d_tpu.utils import bbox as j_bbox
from sam6d_tpu.utils import mesh as j_mesh
from sam6d_tpu.utils import rle as j_rle
from sam6d_tpu.utils import template_poses as j_poses
from sam6d_tpu_torch.models.ism import onboarding as t_onb
from sam6d_tpu_torch.pipeline import make_example as t_example
from sam6d_tpu_torch.pipeline import pem_data as t_data
from sam6d_tpu_torch.pipeline import renderer as t_render
from sam6d_tpu_torch.utils import bbox as t_bbox
from sam6d_tpu_torch.utils import mesh as t_mesh
from sam6d_tpu_torch.utils import native as t_native
from sam6d_tpu_torch.utils import rle as t_rle
from sam6d_tpu_torch.utils import template_poses as t_poses
from sam6d_tpu_torch.utils.png import decode_png, encode_png, read_png
from sam6d_tpu_torch.utils.resize import pil_resize
from chip_smoke import write_gt_detection
from tests.test_pipeline import make_cube_ply
from tests.test_torch_pem import tiny_config

ROOT = Path(__file__).resolve().parent.parent


def pil_png(image, mode=None) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image, mode=mode).save(buf, format="PNG")
    return buf.getvalue()


def pil_array(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def sample_image(rng, shape, dtype=np.uint8):
    """Noise on the left half, a smooth ramp on the right: PIL's adaptive
    filtering then picks different filters on different rows."""
    hi = np.iinfo(dtype).max
    img = (rng.rand(*shape) * hi).astype(dtype)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ramp = ((3 * xx + 5 * yy) % (hi + 1)).astype(dtype)
    if len(shape) == 3:
        ramp = np.repeat(ramp[..., None], shape[2], axis=2)
    half = shape[1] // 2
    img[:, half:] = ramp[:, half:]
    return img


# -- the PNG codec -----------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((37, 53), np.uint8),        # L
    ((41, 67, 3), np.uint8),     # RGB
    ((23, 31, 4), np.uint8),     # RGBA
    ((29, 45), np.uint16),       # 16-bit L (depth)
])
def test_png_decode_matches_pil(rng, shape, dtype):
    data = pil_png(sample_image(rng, shape, dtype))
    want = pil_array(data)
    got = decode_png(data)
    assert got.shape == want.shape
    # PIL gives 16-bit PNGs as I;16 or I by version: compare values.
    np.testing.assert_array_equal(got.astype(np.int64),
                                  want.astype(np.int64))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(image: np.ndarray, ftypes) -> bytes:
    """A PNG of `image` (uint8 RGB or uint16 L) whose row y carries filter
    ftypes[y], filtered from the original bytes as the PNG spec defines."""
    if image.dtype == np.uint16:
        ctype, depth, raw = 0, 16, image.astype(">u2").view(np.uint8)
    else:
        ctype, depth, raw = 2, 8, image
    H, W = image.shape[:2]
    bpp = raw.size // (H * W)
    x = raw.reshape(H, W * bpp).astype(np.int64)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    rows = [np.concatenate([[f], (x[y] - preds[f][y]) & 0xFF])
            for y, f in enumerate(ftypes)]
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    body = np.stack(rows).astype(np.uint8).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_png_decode_every_filter_type(rng, kind, ftype):
    shape, dtype = {"rgb8": ((19, 27, 3), np.uint8),
                    "gray16": ((17, 23), np.uint16)}[kind]
    image = sample_image(rng, shape, dtype)
    ftypes = ([ftype] * shape[0] if ftype != "mixed"
              else [y % 5 for y in range(shape[0])][::-1])
    data = filtered_png(image, ftypes)
    np.testing.assert_array_equal(pil_array(data).astype(np.int64),
                                  image.astype(np.int64))  # the file is valid
    got = decode_png(data)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("shape,dtype,mode", [
    ((33, 47), np.uint8, "L"),
    ((33, 47, 3), np.uint8, "RGB"),
    ((31, 45), np.uint16, None),
])
def test_png_written_reads_back_in_pil_bit_for_bit(rng, shape, dtype, mode):
    image = sample_image(rng, shape, dtype)
    data = encode_png(image)
    im = Image.open(io.BytesIO(data))
    if mode:
        assert im.mode == mode
    np.testing.assert_array_equal(np.asarray(im).astype(np.int64),
                                  image.astype(np.int64))
    np.testing.assert_array_equal(decode_png(data), image)


def test_png_refuses_adam7_palette_and_corrupt_files(rng):
    img = sample_image(rng, (8, 8, 3))
    adam7 = filtered_png(img, [0] * 8).replace(
        _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0)),
        _chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 1)))
    with pytest.raises(ValueError, match="Adam7"):
        decode_png(adam7)
    buf = io.BytesIO()
    Image.fromarray(img).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="palette"):
        decode_png(buf.getvalue())
    broken = bytearray(pil_png(img))
    broken[40] ^= 0xFF  # inside IHDR or IDAT: the CRC no longer holds
    with pytest.raises(ValueError):
        decode_png(bytes(broken))
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


# -- PIL's resize in numpy ---------------------------------------------------

# Square crops resized to the descriptor's and the PEM's 224 (down, up,
# by one pixel either way), then random down- and upscales.
_CROPS = [(s, s, 224, 224) for s in (97, 137, 223, 225, 311, 420)] + [
    (96, 96, 32, 32), (57, 57, 28, 28)]
_r = np.random.RandomState(0)
_RANDOM = [tuple(int(v) for v in _r.randint(3, 300, 4)) for _ in range(8)]


@pytest.mark.parametrize("resample", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w,oh,ow", _CROPS + _RANDOM)
def test_resize_equals_pil(rng, h, w, oh, ow, resample):
    pil = {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[resample]
    for shape in ((h, w), (h, w, 3)):
        img = (rng.rand(*shape) * 255).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), pil))
        got = pil_resize(img, oh, ow, resample)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


# -- numpy copies of the JAX modules ------------------------------------------

def write_binary_ply(path, verts, colors, faces):
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        for v, c in zip(verts, colors):
            f.write(struct.pack("<fffBBB", *v, *c))
        for face in faces:
            f.write(struct.pack("<B" + "i" * len(face), len(face), *face))


def test_mesh_io_and_sampling_match(rng, tmp_path):
    ascii_ply = str(tmp_path / "cube.ply")
    make_cube_ply(ascii_ply, size=60.0)
    bin_ply = str(tmp_path / "quads.ply")
    verts = rng.randn(6, 3).astype(np.float32) * 30
    colors = (rng.rand(6, 3) * 255).astype(np.uint8)
    write_binary_ply(bin_ply, verts, colors, [[0, 1, 2, 3], [2, 3, 4],
                                              [1, 4, 5, 0]])
    obj = str(tmp_path / "m.obj")
    with open(obj, "w") as f:
        f.writelines(f"v {v[0]} {v[1]} {v[2]}\n" for v in verts)
        f.write("f 1/1 2/2 3/3 4/4\nf 3 4 5\n")
    for path in (ascii_ply, bin_ply, obj):
        want, got = j_mesh.load_mesh(path), t_mesh.load_mesh(path)
        np.testing.assert_array_equal(got.vertices, want.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)
        if want.vertex_colors is None:
            assert got.vertex_colors is None
        else:
            np.testing.assert_array_equal(got.vertex_colors,
                                          want.vertex_colors)
        assert got.radius == want.radius
        for seed in (0, 1):
            np.testing.assert_array_equal(got.sample(500, seed=seed),
                                          want.sample(500, seed=seed))


def test_template_poses_match(rng):
    for level in (0, 1):
        np.testing.assert_array_equal(
            t_poses.get_camera_poses(level, radius=2.5),
            j_poses.get_camera_poses(level, radius=2.5))
        for dist in ("all", "upper"):
            gi, gp = t_poses.get_obj_poses_from_template_level(
                level, dist, return_index=True)
            wi, wp = j_poses.get_obj_poses_from_template_level(
                level, dist, return_index=True)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gp, wp)
    R = np.linalg.qr(rng.randn(20, 3, 3))[0]
    np.testing.assert_array_equal(
        t_poses.NearestTemplateFinder(level=1).find(R),
        j_poses.NearestTemplateFinder(level=1).find(R))


@pytest.mark.parametrize("form", ["list", "compressed"])
def test_rle_to_mask_matches(rng, form):
    for shape, p in (((17, 23), 0.5), ((48, 64), 0.9), ((5, 7), 0.0)):
        mask = rng.rand(*shape) < p
        rle = t_rle.mask_to_rle(mask)
        assert rle == j_rle.mask_to_rle(mask)
        if form == "compressed":
            rle = {"size": rle["size"],
                   "counts": j_rle._encode_compressed_counts(rle["counts"])}
            assert (t_rle._decode_compressed_counts(rle["counts"])
                    == j_rle._decode_compressed_counts(rle["counts"]))
        got = t_rle.rle_to_mask(rle)
        np.testing.assert_array_equal(got, j_rle.rle_to_mask(rle))
        np.testing.assert_array_equal(got, mask)


def test_bbox_helpers_match(rng):
    boxes = (rng.rand(5, 4) * 100).astype(np.float32)
    np.testing.assert_array_equal(t_bbox.xywh_to_xyxy(boxes),
                                  j_bbox.xywh_to_xyxy(boxes))
    for bbox, S in (((3, 140, 10, 147), 224), ((0, 33, 5, 38), 32),
                    ((100, 101, 7, 8), 28)):
        h, w = bbox[1] - bbox[0], bbox[3] - bbox[2]
        choose = rng.randint(0, h * w, 300)
        got = t_bbox.get_resize_rgb_choose(choose, bbox, S)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(
            got, j_bbox.get_resize_rgb_choose(choose, bbox, S))


def test_rasterize_numpy_matches(rng):
    verts = (rng.randn(40, 3) * 0.3 + [0, 0, 2.0]).astype(np.float32)
    verts[0, 2] = -0.5  # a triangle behind the camera is culled
    faces = rng.randint(0, 40, (60, 3))
    K = np.array([[80.0, 0, 40], [0, 80.0, 30], [0, 0, 1]], np.float32)
    attrs = rng.rand(40, 4).astype(np.float32)
    got = t_render.rasterize_numpy(verts, faces, K, (60, 80), attrs)
    want = j_render.rasterize_numpy(verts, faces, K, (60, 80), attrs)
    assert got[1].any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the renderer, the example scene and the loaders --------------------------

@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The 96-px cube templates of tests/test_pipeline.py, rendered by
    both packages, and the example scene written by both."""
    tmp = tmp_path_factory.mktemp("render")
    cad = str(tmp / "cube.ply")
    make_cube_ply(cad, size=60.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_render, "rasterize", j_render.rasterize_numpy)
        mp.setattr(j_example, "rasterize", j_render.rasterize_numpy)
        mp.setattr(t_native, "rasterize", lambda *a, **k: None)
        jdir = j_render.render_templates(cad, str(tmp / "jax"), 96)
        j_example.make_example(str(tmp / "jax_scene"))
        tdir = t_render.render_templates(cad, str(tmp / "port"), 96)
        t_example.make_example(str(tmp / "port_scene"))
    return dict(cad=cad, jdir=jdir, tdir=tdir, tmp=tmp)


def test_render_templates_match(rendered):
    jdir, tdir = rendered["jdir"], rendered["tdir"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for i in range(42):
        for name in (f"rgb_{i}.png", f"mask_{i}.png"):
            want = pil_array(Path(jdir, name).read_bytes())
            np.testing.assert_array_equal(read_png(os.path.join(tdir, name)),
                                          want, err_msg=name)
            # and PIL reads the port's file the same
            np.testing.assert_array_equal(
                pil_array(Path(tdir, name).read_bytes()), want)
        got = np.load(os.path.join(tdir, f"xyz_{i}.npy"))
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got,
                                      np.load(os.path.join(jdir,
                                                           f"xyz_{i}.npy")))
    mask = read_png(os.path.join(tdir, "mask_0.png")) == 255
    assert mask.sum() > 50
    xyz = np.load(os.path.join(tdir, "xyz_0.npy")).astype(np.float32)
    np.testing.assert_allclose(np.abs(xyz[mask]).max(axis=1), 30.0, atol=2.0)


def test_make_example_matches(rendered):
    jdir, tdir = rendered["tmp"] / "jax_scene", rendered["tmp"] / "port_scene"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert (tdir / "obj_example.ply").read_text() == \
        (jdir / "obj_example.ply").read_text()
    for name in ("camera.json", "gt_pose.json"):
        assert json.loads((tdir / name).read_text()) == \
            json.loads((jdir / name).read_text())
    for name, shape in (("rgb.png", (480, 640, 3)), ("depth.png", (480, 640))):
        got = read_png(str(tdir / name))
        want = pil_array((jdir / name).read_bytes())
        assert got.shape == shape
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64))
    depth = read_png(str(tdir / "depth.png"))
    assert depth.dtype == np.uint16 and 500 < depth.min() < 700
    assert (depth == 1200).mean() > 0.9


def test_load_all_templates_matches(rendered):
    jcfg, tcfg = tiny_config(jc), tiny_config(tc)
    want = j_data.load_all_templates(rendered["jdir"], jcfg)
    got = t_data.load_all_templates(rendered["tdir"], tcfg)
    S, Np = tcfg.feature_extraction.img_size, tcfg.n_sample_template_point
    for g, w, shape in zip(got, want, ((42, S, S, 3), (42, Np), (42, Np, 3))):
        assert g.shape == shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_prepare_test_data_matches(rendered):
    scene = rendered["tmp"] / "port_scene"
    seg = str(rendered["tmp"] / "gt_detection.json")
    write_gt_detection(str(scene), seg)
    with open(seg) as f:
        rows = json.load(f)
    rows.append(dict(rows[0], score=0.1))  # under the threshold: dropped
    rows.append(dict(rows[0], score=0.9))  # a second instance
    with open(seg, "w") as f:
        json.dump(rows, f)
    args = [str(scene / n) for n in ("rgb.png", "depth.png", "camera.json",
                                     "obj_example.ply")] + [seg]
    want = j_data.prepare_test_data(*args, tiny_config(jc))
    got = t_data.prepare_test_data(*args, tiny_config(tc))
    assert len(got[4]) == len(want[4]) == 2
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        assert got[0][k].dtype == want[0][k].dtype, k
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4]


def test_load_template_crops_matches(rendered):
    for size in (224, 28):
        gi, gm = t_onb.load_template_crops(rendered["tdir"], 42, size)
        wi, wm = j_onb.load_template_crops(rendered["jdir"], 42, size)
        assert gi.shape == (42, size, size, 3) and gm.dtype == bool
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


# -- the package boundary ------------------------------------------------------

def test_port_imports_no_jax_flax_pil_or_the_jax_package():
    banned = {"jax", "flax", "PIL", "sam6d_tpu"}
    # The port, chip_smoke.py and the helpers it loads by path on the
    # card's machine.
    files = sorted((ROOT / "sam6d_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + [
        ROOT / "tests" / "helpers" / f"{name}.py" for name in (
            "ball_query_clouds", "bop_tree", "fps_clouds", "jpeg_writer",
            "megapose_tree", "reference_checkpoints", "torch_parallel_worker")]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if n.split(".")[0] in banned]
    assert len(files) > 40 and not found, found


def test_pem_runner_imports_nothing_of_the_parallel_package():
    # One-card serving stays free of the mesh: `MeshPEMRunner`
    # (`parallel/pem_serving.py`) adds it on top.
    path = ROOT / "sam6d_tpu_torch" / "pipeline" / "pem_runner.py"
    found = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            found += [f"{node.module}.{a.name}" for a in node.names]
    assert found and not [n for n in found
                          if n.startswith("sam6d_tpu_torch.parallel")], found
