"""The port's native host library (`utils/native.py`) on the CPU.

The port builds `native/src/*.cpp` itself, with the JAX loader's
compiler and flags, into a directory of its own (here a temporary one).
Its rasterizer's output is bit-equal to the JAX package's native
library's (same sources, same flags, same compiler); against the port's
numpy rasterizer it holds `tests/test_native.py`'s tolerances (masks
disagree on under 2e-3 of the pixels, depth 1e-4 and attributes 1e-3
where both cover).  The port's RLE stays numpy; its counts and masks
equal the JAX package's native codec's.  The renderer and the scorer
take the native library unless $SAM6D_NO_NATIVE is set; a failed build
warns and keeps the compiler's output.  Skips only where there is no
g++.
"""

import shutil

import numpy as np
import pytest

from sam6d_tpu.utils import native as j_native
from sam6d_tpu_torch.pipeline import bop_score, renderer
from sam6d_tpu_torch.utils import native, rle
from tests.test_native import _sphere_mesh


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native library cannot be "
                    "built")
    lib = native.NativeLibrary(tmp_path_factory.mktemp("native"))
    assert lib.load() is not None, lib.build_error
    return lib


def sphere_scene(n=24, hw=(128, 128)):
    verts, faces = _sphere_mesh(n)
    verts_cam = verts + np.array([0, 0, 3.0], np.float32)
    K = np.array([[120, 0, 64], [0, 120, 64], [0, 0, 1]], np.float32)
    attrs = np.concatenate([verts, np.ones((len(verts), 1), np.float32)], 1)
    return verts_cam, faces, K, hw, attrs


def test_loader_builds_into_its_own_directory(lib):
    assert lib.path.exists() and lib.path.parent.name.startswith("native")
    assert lib.build_s is not None and lib.build_error is None
    assert native.BUILD_DIR == native.REPO_ROOT / "build" / "native"


def test_rasterizer_is_bit_equal_to_the_jax_native_library(lib):
    if j_native.load_library() is None:
        pytest.skip("the JAX package's native library did not build")
    scene = sphere_scene()
    got = lib.rasterize(*scene)
    want = j_native.rasterize(*scene)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert lib.calls["rasterize"] >= 1


def test_rasterizer_holds_the_numpy_tolerances(lib):
    scene = sphere_scene()
    img, mask, depth = lib.rasterize(*scene)
    ref_img, ref_mask, ref_depth = renderer.rasterize_numpy(*scene)
    assert (mask != ref_mask).mean() < 2e-3
    both = mask & ref_mask
    assert both.sum() > 1000
    np.testing.assert_allclose(depth[both], ref_depth[both], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(img[both], ref_img[both], rtol=1e-3, atol=1e-3)
    assert np.isinf(depth[~mask]).all() and (img[~mask] == 0).all()


def test_rle_counts_equal_numpy_and_jax():
    """The port's numpy codec against the JAX package's native one (its
    numpy one where that library did not build)."""
    from sam6d_tpu.utils import rle as j_rle

    rng = np.random.RandomState(0)
    masks = [rng.rand(48, 64) > 0.5, np.zeros((30, 20), bool),
             np.ones((30, 20), bool), rng.rand(480, 640) > 0.995]
    for m in masks:
        counts = rle.mask_to_rle(m)["counts"]
        assert counts == j_rle.mask_to_rle(m)["counts"]
        np.testing.assert_array_equal(
            rle.rle_to_mask({"counts": counts, "size": list(m.shape)}), m)
        np.testing.assert_array_equal(
            j_rle.rle_to_mask({"counts": counts, "size": list(m.shape)}), m)


def test_dispatch_follows_sam6d_no_native(lib, monkeypatch):
    monkeypatch.setattr(native, "LIBRARY", lib)
    scene = sphere_scene(8, (64, 64))
    mesh = type("Mesh", (), {})()
    mesh.vertices, mesh.faces = scene[0] - [0, 0, 3.0], scene[1]

    def run():
        before = lib.calls["rasterize"]
        out = renderer.rasterize(*scene)
        bop_score._render_depth(mesh, np.eye(3), np.array([0, 0, 3.0]),
                                scene[2], (64, 64))
        return out, lib.calls["rasterize"] - before

    out, calls = run()
    assert calls == 2
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    out_np, calls = run()
    assert calls == 0
    for g, w in zip(out_np, renderer.rasterize_numpy(*scene)):
        np.testing.assert_array_equal(g, w)


def test_prebuilt_library_and_failed_build(lib, tmp_path, monkeypatch):
    monkeypatch.setenv(native.LIB_ENV, str(lib.path))
    pre = native.NativeLibrary(tmp_path / "never_built")
    assert pre.load() is not None and not pre.path.exists()
    monkeypatch.delenv(native.LIB_ENV)

    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "bad.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", broken)
    failed = native.NativeLibrary(tmp_path / "build")
    with pytest.warns(RuntimeWarning, match="build failed"):
        assert failed.load() is None
    assert "bad.cpp" in failed.build_error
    assert failed.rasterize(*sphere_scene(8, (16, 16))) is None
