"""The port's training data against the JAX package: `MegaPoseDataset` on a
MegaPose-layout tree, `make_procedural_mesh`, `RenderedPoseDataset`.

The tree comes from `tests/helpers/megapose_tree.py` (the writer that
`chip_smoke.py` also uses: its JPEGs from `tests/helpers/jpeg_writer.py`,
its PNGs from the port's codec); the JAX loader reads it through PIL, the
port through `utils/jpeg.py` and `utils/png.py`.  Both draw from
generators seeded alike, in the same order, so every array of every
sample is compared exactly: pts, rgb, rgb_choose, tem_rgb, tem_choose,
tem_pts, gt_r, gt_t and K equal bit for bit (the decoder, the resize and
the augmentation reproduce PIL's integers, so no grey-level bound is
needed), and the generator ends in the same state.  Both renderers are
sent through their numpy rasterizers (each takes the C++ rasterizer when
it is built, whose boundary pixels differ).  Also both packages on
`tests/test_megapose_fixture.py`'s PIL-written fixture and its
geometric check.
"""

import pathlib
import sys

import numpy as np
import pytest

import sam6d_tpu.pipeline.renderer as j_render
from sam6d_tpu.config import TrainConfig as JTrain
from sam6d_tpu.provider import training_dataset as jds
from sam6d_tpu_torch.config import TrainConfig as TTrain
from sam6d_tpu_torch.provider import training_dataset as tds
from sam6d_tpu_torch.utils import native as t_native
from tests.test_megapose_fixture import megapose_root  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
import megapose_tree  # noqa: E402

SIZES = dict(batch_size=2, img_size=32, n_sample_observed_point=128,
             n_sample_template_point=96)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("megapose_tree")
    info = megapose_tree.write_megapose_tree(root, n_keys=6, seed=1)
    return str(root), info


@pytest.fixture
def numpy_rasterizer(monkeypatch):
    monkeypatch.setattr(j_render, "rasterize", j_render.rasterize_numpy)
    monkeypatch.setattr(t_native, "rasterize", lambda *a, **k: None)


def assert_samples_equal(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(y, x, err_msg=f"{what}: {k}")


def assert_same_state(r_jax, r_port):
    s_jax, s_port = r_jax.get_state(), r_port.get_state()
    np.testing.assert_array_equal(s_port[1], s_jax[1])
    assert s_port[2:] == s_jax[2:]


def test_tree_layout(tree):
    root, info = tree
    web = pathlib.Path(root) / "MegaPose-GSO" / "train_pbr_web"
    assert (web / "key_to_shard.json").exists()
    assert (web / "gso_models.json").exists()
    for key in info["keys"]:
        for suffix in (".rgb.jpg", ".depth.png", ".camera.json", ".gt.json",
                       ".gt_info.json", ".mask_visib.json"):
            assert (web / "shard-000000" / (key + suffix)).exists()
    xyz = np.load(pathlib.Path(root) / "MegaPose-GSO" / "templates"
                  / "obj_000" / "xyz_0.npy")
    assert xyz.dtype == np.float16 and 0.2 < np.abs(xyz).max() < 0.8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_megapose_samples_equal_jax(tree, seed):
    """Eight samples after `reset` (an epoch of 8 drawn with replacement
    from 6 keys), mask dilation on (its coin is drawn per sample)."""
    root, _ = tree
    j = jds.MegaPoseDataset(JTrain(**SIZES), root, num_img_per_epoch=8,
                            seed=seed)
    t = tds.MegaPoseDataset(TTrain(**SIZES), root, num_img_per_epoch=8,
                            seed=seed)
    assert len(t) == len(j) == 8
    j.reset()
    t.reset()
    np.testing.assert_array_equal(t.img_idx, j.img_idx)
    for i in range(8):
        assert_samples_equal(j[i], t[i], f"seed {seed} sample {i}")
    assert_same_state(j.rng, t.rng)


def test_megapose_without_reset_and_dilation_equals_jax(tree):
    root, _ = tree
    j = jds.MegaPoseDataset(JTrain(**SIZES), root, seed=5, dilate_mask=False)
    t = tds.MegaPoseDataset(TTrain(**SIZES), root, seed=5, dilate_mask=False)
    for i in (0, 3, 7, 11):  # 7 and 11 wrap around the 6 keys
        assert_samples_equal(j[i], t[i], f"sample {i}")
    assert_same_state(j.rng, t.rng)


def test_megapose_skips_a_key_with_missing_files(tree, tmp_path):
    """A key whose frame is missing is retried with a random one, as in
    the JAX package (the same draws)."""
    import shutil

    root, info = tree
    copy = tmp_path / "tree"
    shutil.copytree(root, copy)
    web = copy / "MegaPose-GSO" / "train_pbr_web" / "shard-000000"
    (web / (info["keys"][0] + ".rgb.jpg")).unlink()
    j = jds.MegaPoseDataset(JTrain(**SIZES), str(copy), seed=2)
    t = tds.MegaPoseDataset(TTrain(**SIZES), str(copy), seed=2)
    assert t.read_data(0) is None
    assert_samples_equal(j[0], t[0], "retried sample")


def test_megapose_fixture_geometry_in_both_packages(megapose_root):  # noqa: F811
    """tests/test_megapose_fixture.py's check on its PIL-written fixture:
    the observed points, taken to the augmented object frame, land on the
    template cloud, in metres; and the two packages agree."""
    cfg = dict(batch_size=2, img_size=32, n_sample_observed_point=128,
               n_sample_template_point=128)
    for seed in range(3):
        j = jds.MegaPoseDataset(JTrain(**cfg), megapose_root, seed=seed)
        t = tds.MegaPoseDataset(TTrain(**cfg), megapose_root, seed=seed)
        a, s = j[0], t[0]
        assert_samples_equal(a, s, f"fixture seed {seed}")
        obj = (s["pts"] - s["gt_t"]) @ s["gt_r"]
        tem = s["tem_pts"].reshape(-1, 3)
        d = np.sqrt(((obj[:, None] - tem[None]) ** 2).sum(-1)).min(1)
        assert np.median(d) < 0.012, np.median(d)
        assert 0.02 < np.abs(tem).max() < 0.08


def test_procedural_mesh_equals_jax():
    for seed in range(3):
        a = jds.make_procedural_mesh(np.random.RandomState(seed))
        b = tds.make_procedural_mesh(np.random.RandomState(seed))
        np.testing.assert_array_equal(b.vertices, a.vertices)
        np.testing.assert_array_equal(b.faces, a.faces)
        np.testing.assert_array_equal(b.vertex_colors, a.vertex_colors)


@pytest.mark.parametrize("uint8_rgb", [False, True])
def test_rendered_samples_and_templates_equal_jax(numpy_rasterizer,
                                                  uint8_rgb):
    cfg = dict(batch_size=2, img_size=32, n_sample_observed_point=64,
               n_sample_template_point=64)
    kw = dict(n_objects=2, n_template_views=3, seed=3, frame_size=64,
              color_aug_prob=0.5, uint8_rgb=uint8_rgb)
    j = jds.RenderedPoseDataset(JTrain(**cfg), **kw)
    t = tds.RenderedPoseDataset(TTrain(**cfg), **kw)
    assert len(t) == len(j)
    for i in range(5):
        for aug in (True, False):
            assert_samples_equal(j.sample(i, aug), t.sample(i, aug),
                                 f"sample {i} aug {aug}")
    assert_samples_equal(j[9], t[9], "__getitem__")
    if uint8_rgb:
        assert t[0]["rgb"].dtype == np.uint8
    for obj in range(2):
        for a, b in zip(j.template_arrays(obj, seed=4),
                        t.template_arrays(obj, seed=4)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_tree_writers_import_no_pil_jax_or_the_jax_package():
    """chip_smoke.py loads the tree writers on the card's machine, which
    has no PIL and no JAX."""
    import ast

    banned = {"jax", "flax", "PIL", "sam6d_tpu"}
    helpers = pathlib.Path(__file__).resolve().parent / "helpers"
    found = []
    for name in ("megapose_tree.py", "jpeg_writer.py"):
        for node in ast.walk(ast.parse((helpers / name).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{name}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in banned]
    assert not found, found
