"""The port's FastSAM against the JAX package on the CPU.

Same weights on both sides (the JAX variable tree, `params` and
`batch_stats`, carried across by `params.flax_to_state_dict`, with
non-trivial BatchNorm statistics, biases and scales), same numpy inputs.
FastSAM at the "n" scale (width 0.25, depth 0.33), 128 and 160 px.

Tolerances, float32 throughout:
* the head outputs and prototypes (of order 0.5): 1e-5 -- convolutions
  through another library (XLA against oneDNN), summed in another order,
  over 64 layers (2.1e-7 seen);
* decode_boxes on the same head outputs: 1e-4 px (boxes reach 160) and
  1e-6 on the scores and coefficients;
* generate_masks: the same proposals in the same order, boxes within
  1e-3 px; masks equal except at pixels whose resampled sigmoid lies
  within 1e-5 of 0.5 (the threshold), where float32 rounding of the two
  resize products decides; the test counts them: none at these seeds,
  whose nearest probability lies 4e-3 from 0.5 (boxes 1.5e-5 px apart).
* top-k: index for index equal to `jax.lax.top_k` on tied scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam6d_tpu.models.ism.fastsam import FastSAM as JFastSAM
from sam6d_tpu.models.ism.fastsam import YOLOv8Seg as JYOLO
from sam6d_tpu.models.ism.fastsam import decode_boxes as j_decode
from sam6d_tpu_torch.models.ism import fastsam
from sam6d_tpu_torch.models.ism.fastsam import FastSAM as TFastSAM
from sam6d_tpu_torch.models.ism.fastsam import YOLOv8Seg as TYOLO
from sam6d_tpu_torch.models.ism.fastsam import decode_boxes as t_decode
from sam6d_tpu_torch.ops.topk import top_k_indices
from sam6d_tpu_torch.params import flax_to_state_dict

torch.set_num_threads(2)

WIDTH, DEPTH = 0.25, 0.33
HEAD_ATOL = 1e-5


def fastsam_variables(size, seed=0):
    """Seeded variables of YOLOv8Seg at the "n" scale: LeCun-normal
    kernels, scales 1 + N(0, 0.1^2), biases and means N(0, 0.1^2),
    variances U(0.5, 1.5)."""
    net = JYOLO(width=WIDTH, depth=DEPTH)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "'var'" in name:
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if "'scale'" in name:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def nets():
    out = {}
    for size in (128, 160):
        variables = fastsam_variables(size)
        tnet = TYOLO(WIDTH, DEPTH).eval()
        tnet.load_state_dict(flax_to_state_dict(variables))  # strict
        out[size] = (variables, tnet)
    return out


def head_outputs(nets, size, x):
    variables, tnet = nets[size]
    want = jax.jit(JYOLO(width=WIDTH, depth=DEPTH).apply)(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    return got, want


@pytest.mark.parametrize("size", [128, 160])
def test_yolov8seg_matches(nets, size):
    x = np.random.RandomState(size).rand(1, size, size, 3).astype(np.float32)
    (t_outs, t_proto), (j_outs, j_proto) = head_outputs(nets, size, x)
    np.testing.assert_allclose(t_proto.numpy(), np.asarray(j_proto),
                               atol=HEAD_ATOL)
    assert t_proto.shape == (1, size // 4, size // 4, 32)
    for t_level, j_level in zip(t_outs, j_outs):
        for t, j in zip(t_level, j_level):
            assert t.shape == j.shape
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       atol=HEAD_ATOL)


def test_decode_boxes_matches(nets):
    x = np.random.RandomState(3).rand(1, 128, 128, 3).astype(np.float32)
    (t_outs, _), (j_outs, _) = head_outputs(nets, 128, x)
    # Both decode the JAX head outputs, so only the decode is compared.
    j_outs = [tuple(np.asarray(a) for a in level) for level in j_outs]
    want = j_decode([tuple(map(jnp.asarray, lv)) for lv in j_outs], 128)
    got = t_decode([tuple(torch.tensor(a) for a in lv) for lv in j_outs],
                   128)
    A = 16 * 16 + 8 * 8 + 4 * 4
    assert got[0].shape == (1, A, 4) and got[1].shape == (1, A, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def pipelines(nets, size, **kw):
    variables, tnet = nets[size]
    jfs = JFastSAM(img_size=size, width=WIDTH, depth=DEPTH, **kw)
    jfs.load(variables)
    tfs = TFastSAM(img_size=size, width=WIDTH, depth=DEPTH, device="cpu", **kw)
    tfs.net.load_state_dict(tnet.state_dict())
    return jfs, tfs


@pytest.mark.parametrize("size,hw", [(128, (96, 120)), (160, (120, 160))])
def test_generate_masks_matches(nets, size, hw, monkeypatch):
    probs = []
    record = fastsam.mask_probabilities
    monkeypatch.setattr(fastsam, "mask_probabilities",
                        lambda *a: probs.append(record(*a)) or probs[-1])
    image = (np.random.RandomState(7).rand(*hw, 3) * 255).astype(np.uint8)
    jfs, tfs = pipelines(nets, size, conf=0.3, max_det=24)
    want = jfs.generate_masks(image)
    got = tfs.generate_masks(image)
    assert len(want["masks"]) > 3
    assert got["masks"].shape == want["masks"].shape == (
        len(want["masks"]), *hw)
    assert got["boxes"].dtype == np.float32
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3)
    # No proposal composed empty here, so the port's probabilities align
    # with its masks; a pixel may differ only on the threshold.
    assert len(probs[0]) == len(got["masks"])
    differ = got["masks"] != want["masks"]
    assert (np.abs(probs[0].numpy()[differ] - 0.5) < 1e-5).all()
    assert differ.sum() == 0  # the count at these seeds


def test_generate_masks_empty_when_nothing_passes_conf(nets):
    image = (np.random.RandomState(8).rand(96, 120, 3) * 255).astype(np.uint8)
    jfs, tfs = pipelines(nets, 128, conf=1.1, max_det=8)
    for out in (jfs.generate_masks(image), tfs.generate_masks(image)):
        assert out["masks"].shape == (0, 96, 120)
        assert out["masks"].dtype == bool
        assert out["boxes"].shape == (0, 4)


@pytest.mark.parametrize("n", [64, 1024, 3072, 8400])
def test_top_k_orders_ties_as_jax(n):
    # Integer-valued float32 scores: many exact ties.  torch.topk orders
    # them otherwise on the CPU; jax.lax.top_k puts the lowest index first.
    s = np.random.RandomState(n).randint(0, 20, n).astype(np.float32)
    k = min(800, n)
    want = np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1])
    got = top_k_indices(torch.from_numpy(s), k).numpy()
    np.testing.assert_array_equal(got, want)
