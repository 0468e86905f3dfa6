"""The ISM half of the port's accuracy loop against the JAX tools, on the
CPU: `train_ism_descriptor`, `train_tiny_sam` and `ism_accuracy_eval`.

Same seeds (numpy `RandomState`s as the JAX tools seed them), the same
weights (the JAX variables carried across by `sam6d_tpu_torch.params`),
both rasterizers pinned to numpy (the native one differs from it on
boundary pixels).  Tolerances:
* the rendered views, crops, masks, scenes, prompts and targets: equal
  bit for bit (PIL's resizes are `utils/resize.pil_resize`);
* the NT-Xent loss against the JAX tool's `loss_fn`: 1e-5 relative; two
  Adam steps of `torch.optim.Adam` under the tool's `LambdaLR` against
  optax's `adam` given the same gradients: 1e-5 (float32 rounding of
  one update of size lr); each gradient leaf against JAX's 1e-4 relative
  (Frobenius), the leaves whose gradient is zero in exact arithmetic (k's
  bias: it adds one logit to a whole softmax row) excepted at 1e-7
  absolute;
* `sam_loss` and each gradient leaf of the tiny SAM built with
  `flash=False`: 1e-4 relative; the leaves the point-prompt loss never
  reaches (prompt embeddings of other labels, the mask-prompt
  downscaling, the hypernetworks of masks no minimum picked) have a zero
  gradient in JAX and a zero one or none in the port, and the leaves
  whose gradient is zero in exact arithmetic hold float noise within
  1e-7;
* the depth connected-components proposals: equal; `viewing_angle_deg`:
  1e-6.
"""

import dataclasses

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tools.ism_accuracy_eval as j_eval
import tools.train_ism_descriptor as j_desc
import tools.train_tiny_sam as j_sam
from sam6d_tpu.models.ism.detector import normalize_rgb as j_normalize
from sam6d_tpu.ops.geometry import l2_normalize as j_l2
from sam6d_tpu.provider.training_dataset import make_procedural_mesh as j_mesh
from sam6d_tpu_torch.params import flax_to_state_dict, sam_state_dict
from sam6d_tpu_torch.provider.training_dataset import make_procedural_mesh
from sam6d_tpu_torch.tools import ism_accuracy_eval as t_eval
from sam6d_tpu_torch.tools import train_ism_descriptor as t_desc
from sam6d_tpu_torch.tools import train_tiny_sam as t_sam
from tests.test_torch_ism import random_variables, sam_variables

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
from tool_parity import numpy_rasterizers, rel  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.mark.parametrize("jitter", [True, False])
def test_render_object_views_matches_jax(numpy_rasterizers, jitter):
    mesh = make_procedural_mesh(np.random.RandomState(3))
    jm = j_mesh(np.random.RandomState(3))
    np.testing.assert_array_equal(mesh.vertices, jm.vertices)
    got = t_desc.render_object_views(mesh, 5, 64, np.random.RandomState(4),
                                     jitter=jitter)
    want = j_desc.render_object_views(jm, 5, 64, np.random.RandomState(4),
                                      jitter=jitter)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_make_training_batch_matches_jax(numpy_rasterizers):
    meshes = [make_procedural_mesh(np.random.RandomState(i)) for i in (1, 2)]
    jmeshes = [j_mesh(np.random.RandomState(i)) for i in (1, 2)]
    jsam = j_sam.make_tiny_sam()  # preprocess_numpy needs no weights
    rng_t, rng_j = np.random.RandomState(11), np.random.RandomState(11)
    got = t_sam.make_training_batch(meshes, rng_t, B=2, P=4)
    want = j_sam.make_training_batch(jmeshes, rng_j, jsam, B=2, P=4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert rng_t.randint(1 << 30) == rng_j.randint(1 << 30)
    for g, w in zip(t_sam.render_scene(meshes, rng_t),
                    j_sam.render_scene(jmeshes, rng_j)):
        np.testing.assert_array_equal(g, w)


def jax_nt_xent(model, B, tau):
    """The JAX tool's loss_fn (inline in its main), unchanged."""
    def loss_fn(params, batch):
        cls, _ = model.vit.apply({"params": params}, batch)
        z = j_l2(cls.astype(jnp.float32))
        sim = z @ z.T / tau
        sim = sim - 1e9 * jnp.eye(2 * B)
        targets = jnp.concatenate([jnp.arange(B) + B, jnp.arange(B)])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            sim, targets).mean()
        acc = (jnp.argmax(sim, axis=1) == targets).mean()
        return loss, acc
    return loss_fn


def test_nt_xent_and_two_adam_steps_match_optax(numpy_rasterizers):
    """Two steps of the tool's loop: each step's loss and gradients against
    the JAX tool's at the weights each side has reached (the JAX side
    steps with optax on its own gradients), and the port's Adam against
    optax's update of the port's own gradients."""
    from sam6d_tpu.models.ism.dinov2 import DescriptorModel as JDesc
    from sam6d_tpu_torch.models.ism.detector import normalize_rgb

    cfg = t_desc.tiny_descriptor_config()
    jcfg = j_desc.tiny_descriptor_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    B, tau, lr = 3, 0.1, 3e-4
    pools = t_desc.render_pools(4, 3, cfg.image_size,
                                np.random.RandomState(0))
    rng = np.random.RandomState(5)
    batches = [t_desc.make_batch(pools, rng, B) for _ in range(2)]
    jmodel = JDesc(jcfg)
    variables = random_variables(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)), 7)
    jparams = variables["params"]
    tx = optax.adam(lr)
    jopt = tx.init(jparams)
    grad_fn = jax.jit(jax.value_and_grad(jax_nt_xent(jmodel, B, tau),
                                         has_aux=True))

    model = t_desc.make_descriptor(cfg, "cpu", use_flash=False)
    model.vit.load_state_dict(flax_to_state_dict(variables))
    opt, sched = t_desc.make_optimizer(model.parameters(), lr)
    names = [n for n, _ in model.vit.named_parameters()]
    ref = {n: jnp.asarray(p.detach().numpy())
           for n, p in model.vit.named_parameters()}
    ref_opt = tx.init(ref)
    for batch in batches:
        (jloss, jacc), jgrads = grad_fn(jparams,
                                        j_normalize(jnp.asarray(batch)))
        model.zero_grad(set_to_none=True)
        cls, _ = model.vit(normalize_rgb(torch.as_tensor(batch)))
        loss, acc = t_desc.nt_xent(cls, tau)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        assert float(acc) == pytest.approx(float(jacc))
        want = flax_to_state_dict({"params": jgrads})
        grads = {n: p.grad.clone() for n, p in model.vit.named_parameters()}
        for n in names:
            g, w = grads[n].numpy(), want[n].numpy()
            if n.endswith("attn.qkv.bias"):  # k's third: zero exactly
                d = g.shape[0] // 3
                np.testing.assert_allclose(g[d:2 * d], 0, atol=1e-7)
                g = np.delete(g, np.s_[d:2 * d])
                w = np.delete(w, np.s_[d:2 * d])
            assert rel(g, w) <= 1e-4, n
        upd, jopt = tx.update(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        upd, ref_opt = tx.update({n: jnp.asarray(grads[n].numpy())
                                  for n in names}, ref_opt, ref)
        ref = optax.apply_updates(ref, upd)
        opt.step()
        sched.step()
        for n, p in model.vit.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref[n]),
                                       atol=1e-5, rtol=0, err_msg=n)
    assert sched.get_last_lr() == [lr]


def test_cosine_decay_matches_optax():
    want = optax.cosine_decay_schedule(3e-4, 50)
    got = t_sam.cosine_decay(3e-4, 50)
    for c in (0, 1, 7, 25, 49, 50, 80):
        assert got(c) == pytest.approx(float(want(c)), rel=1e-6, abs=1e-12)


@pytest.fixture(scope="module")
def tiny_sam_pair():
    jsam = j_sam.make_tiny_sam()
    jsam.variables = sam_variables(jsam, 3)
    tsam = t_sam.make_tiny_sam(device="cpu", flash=False)
    tsam.load_state_dict(sam_state_dict(jsam.variables))
    return jsam, tsam


def test_sam_loss_and_every_gradient_match_jax(tiny_sam_pair,
                                               numpy_rasterizers):
    """The tiny SAM built with flash=False: loss, its parts and every
    gradient leaf; every encoder parameter (each qkv and rel-pos table
    among them) has a gradient."""
    jsam, tsam = tiny_sam_pair
    meshes = [make_procedural_mesh(np.random.RandomState(i)) for i in (1, 2)]
    imgs, pts, gts = t_sam.make_training_batch(
        meshes, np.random.RandomState(11), B=1, P=3)
    f = jax.jit(jax.value_and_grad(
        lambda v: j_sam.sam_loss(jsam, v, imgs, pts, gts), has_aux=True))
    (jloss, jaux), jgrads = f(jsam.variables)
    tsam.zero_grad(set_to_none=True)
    loss, aux = t_sam.sam_loss(tsam, *(torch.from_numpy(x)
                                       for x in (imgs, pts, gts)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4, atol=1e-7)
    want = sam_state_dict(jgrads)
    unreached = []
    for n, p in tsam.named_parameters():
        w = want[n].numpy()
        if not w.any():
            unreached.append(n)
            assert p.grad is None or not p.grad.any(), n
            continue
        assert p.grad is not None, n
        g = p.grad.numpy()
        assert (rel(g, w) <= 1e-4 or np.abs(g - w).max() <= 1e-7), \
            (n, rel(g, w), np.abs(g).max())
    # Unreached: prompt embeddings of other labels and the mask-prompt
    # path, and the hypernetwork MLPs of masks that no prompt's minimum
    # picked.  Never an encoder parameter.
    assert not any(n.startswith("encoder.") for n in unreached)
    assert all(n.startswith(("prompt.", "decoder.output_hypernetworks"))
               for n in unreached), unreached


def test_tiny_descriptor_gives_every_parameter_a_gradient():
    model = t_desc.make_descriptor(t_desc.tiny_descriptor_config(), "cpu",
                                   use_flash=False)
    x = torch.randn(6, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    cls, _ = model.vit(x)
    t_desc.nt_xent(cls, 0.1)[0].backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
        assert p.grad.abs().max() > 0, n


def test_depth_cc_proposals_match_jax():
    rng = np.random.RandomState(0)
    depth = np.full((48, 64), 900.0, np.float32)
    depth[5:20, 8:30] = 500.0
    depth[30:44, 40:60] = 450.0
    depth[25:27, 2:4] = 480.0  # 4 pixels: below the 32-pixel floor
    depth += rng.uniform(-3, 3, depth.shape).astype(np.float32)
    got_seg, want_seg = t_eval.DepthCCSegmentor(), j_eval.DepthCCSegmentor()
    for _ in range(2):  # the distractors' draws go on across frames
        got_seg.depth = want_seg.depth = depth
        got = got_seg.generate_masks(np.zeros((48, 64, 3), np.uint8))
        want = want_seg.generate_masks(np.zeros((48, 64, 3), np.uint8))
        assert len(got["masks"]) == 2 + 4
        for k in ("masks", "boxes"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_viewing_angle_matches_jax():
    from sam6d_tpu_torch.provider.training_dataset import random_rotation

    rng = np.random.RandomState(2)
    for _ in range(8):
        a, b = random_rotation(rng), random_rotation(rng)
        np.testing.assert_allclose(t_eval.viewing_angle_deg(a, b),
                                   j_eval.viewing_angle_deg(a, b), atol=1e-6)
    assert t_eval.viewing_angle_deg(a, a) == pytest.approx(0.0, abs=1e-3)


def test_template_poses_are_the_jax_tools():
    from sam6d_tpu.utils.template_poses import get_camera_poses

    cam = get_camera_poses(0, radius=1.0)[:42]
    got = t_eval.template_object_poses()
    np.testing.assert_allclose(got[:, :3, :3],
                               np.transpose(cam[:, :3, :3], (0, 2, 1)),
                               atol=1e-7)


def test_ism_tools_run_on_the_cpu(tmp_path):
    """The three entry points end to end at a few steps: the descriptor
    and the tiny SAM trained and saved, then the evaluation with both
    segmentors on their weights and a small PEM's train state."""
    from sam6d_tpu_torch.tools import smoke_train_eval

    desc, sam, pem = (str(tmp_path / n) for n in ("desc", "sam", "pem"))
    rec = t_desc.main(["--steps", "2", "--objects", "4",
                       "--views_per_object", "3", "--batch_objects", "3",
                       "--ckpt_dir", desc, "--device", "cpu"])
    assert rec["steps"] == 2
    rec = t_sam.main(["--steps", "1", "--batch", "1", "--prompts", "2",
                      "--objects", "3", "--ckpt", sam, "--recall_scenes", "1",
                      "--device", "cpu"])
    assert 0.0 <= rec["amg_recall_at_0.5"] <= 1.0
    smoke_train_eval.main(["--steps", "1", "--eval", "1", "--batch_size", "2",
                           "--objects", "2", "--eval_objects", "1",
                           "--ckpt_dir", pem, "--device", "cpu"])
    rec = t_eval.main(["--desc_ckpt", desc, "--pem_ckpt", pem, "--frames",
                       "2", "--bank_objects", "2", "--segmentor",
                       "depth_cc,tiny_sam", "--sam_ckpt", sam, "--out",
                       str(tmp_path / "ism"), "--device", "cpu"])
    dcc = rec["per_segmentor"]["depth_cc"]
    assert dcc["frames"] == 2 and 0.0 <= dcc["object_selection_acc"] <= 1.0
    assert 0.0 <= dcc["e2e_ar_no_gt_masks"] <= 1.0
    assert rec["pem_step"] == 1
