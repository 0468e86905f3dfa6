"""The PEM serving slice of the port against the JAX package on the CPU.

Same weights on both sides (JAX variables carried across by
`sam6d_tpu_torch.params`), same inputs (numpy, seeded), and the same
hypothesis uniforms: the test recomputes the JAX draws from the JAX key
path (forward_with_bank splits the key; the coarse half is split again
for the row and column uniforms) and hands them to the port.

JAX runs op by op (`jax.disable_jit`).  Under jit XLA fuses and
re-associates float32 arithmetic, which moves the coarse attention by
~1e-5 -- enough to move a float16 CDF step of the hypothesis sampler,
so jitted JAX and eager JAX may already sample different hypotheses.
Eager JAX and the port agree to float32 rounding, and their sampled
hypotheses coincide.

Tolerances, float32 throughout:
* indices (FPS, ball query) are exact;
* init_R / init_t: 1e-4 -- the coarse pose is one Procrustes solve on
  the same sampled triplets, float32 rounding only;
* pred_R / pred_t (normalised by the radius before the check): 2e-3 --
  the fine solve integrates the attention of all 64 x 64 pairs, and the
  bg token's distance embedding carries the float32 sin/cos difference
  of arguments near 500 rad (see test_torch_geo_embed.py);
* pose_score: 1e-6 -- an inlier fraction, so an inlier flip would show
  as a full 1/N step.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
from sam6d_tpu.models.pem.model import PEM as JPEM
from sam6d_tpu.pipeline.pem_runner import PEMRunner as JRunner
from sam6d_tpu_torch.models.pem.model import PEM as TPEM
from sam6d_tpu_torch.params import flax_to_state_dict, load_npz, save_npz
from sam6d_tpu_torch.pipeline.pem_runner import PEMRunner as TRunner

torch.set_num_threads(2)

ROT_ATOL, FINE_ATOL = 1e-4, 2e-3


def tiny_config(c):
    """The tiny PEMConfig of __graft_entry__.dryrun_multichip."""
    return c.PEMConfig(
        coarse_npoint=16, fine_npoint=64,
        feature_extraction=c.ViTConfig(embed_dim=48, out_dim=32, img_size=32,
                                       patch_size=8),
        geo_embedding=c.GeoEmbeddingConfig(hidden_dim=32),
        coarse_point_matching=c.CoarseMatchingConfig(
            input_dim=32, hidden_dim=32, out_dim=32, nproposal1=64,
            nproposal2=8),
        fine_point_matching=c.FineMatchingConfig(
            input_dim=32, hidden_dim=32, out_dim=32, pe_nsample1=8,
            pe_nsample2=16),
    )


def random_variables(model, example, seed=3):
    """Seeded JAX variables of `model`'s shapes, without running its init
    (LeCun-normal kernels; non-trivial biases, norms and BN statistics so
    that every parameter path is exercised)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), **example, key=jax.random.PRNGKey(1)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "'var'" in name:
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if "'scale'" in name and len(s.shape) == 1:
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def coarse_uniforms(key, B, nproposal1):
    """The uniforms forward_with_bank draws from `key` for a batch of B."""
    k_coarse, _ = jax.random.split(key)
    k1, k2 = jax.random.split(k_coarse)
    shape = (B, 3 * nproposal1, 1)
    return (np.array(jax.random.uniform(k1, shape)),
            np.array(jax.random.uniform(k2, shape)))


def make_inputs(rng, B, N, M, S, C):
    inst = {
        "pts": (rng.randn(B, N, 3) * 0.05).astype(np.float32),
        "rgb": rng.rand(B, S, S, 3).astype(np.float32),
        "rgb_choose": rng.randint(0, S * S, (B, N)).astype(np.int32),
        "model_pts": (rng.randn(B, M, 3) * 0.05).astype(np.float32),
        "score": rng.rand(B).astype(np.float32),
    }
    tem_pts = (rng.randn(1, N, 3) * 0.05).astype(np.float32)
    tem_feat = rng.randn(1, N, C).astype(np.float32)
    return inst, tem_pts, tem_feat


def build_tiny():
    """JAX and port runners over the same seeded weights and template
    bank, and four seeded instances."""
    jcfg, tcfg = tiny_config(jc), tiny_config(tc)
    rng = np.random.RandomState(0)
    N, S = jcfg.fine_npoint, jcfg.feature_extraction.img_size
    C = jcfg.feature_extraction.out_dim
    inst, tem_pts, tem_feat = make_inputs(rng, 4, N, 32, S, C)
    model = JPEM(jcfg)
    example = {k: jnp.asarray(v[:1]) for k, v in inst.items() if k != "score"}
    example.update(dense_po=jnp.asarray(tem_pts), dense_fo=jnp.asarray(tem_feat))
    variables = random_variables(model, example)
    jrun = JRunner(jcfg, variables=variables)
    with jax.disable_jit():
        jrun.template_bank = jrun._make_bank(variables, tem_pts, tem_feat)
    state = flax_to_state_dict(variables)
    trun = TRunner(tcfg, state_dict=state, device="cpu")
    trun.make_template_bank(torch.from_numpy(tem_pts),
                            torch.from_numpy(tem_feat))
    return dict(jcfg=jcfg, tcfg=tcfg, model=model, variables=variables,
                state=state, jrun=jrun, trun=trun, inst=inst,
                tem_pts=tem_pts, tem_feat=tem_feat)


@pytest.fixture(scope="module")
def tiny():
    return build_tiny()


def close_poses(got, want, radius, score_key="pose_score"):
    np.testing.assert_allclose(got["pred_R"], want["pred_R"], atol=FINE_ATOL)
    np.testing.assert_allclose(got["pred_t"] / radius, want["pred_t"] / radius,
                               atol=FINE_ATOL)
    np.testing.assert_allclose(got[score_key], want[score_key], atol=1e-6)
    np.testing.assert_allclose(np.linalg.det(got["pred_R"]), 1.0, atol=1e-4)


def check_runner(tiny, max_bucket, bucket):
    """Port PEMRunner.infer against the JAX PEMRunner.infer on the first
    3 instances, with the port given the uniforms of the JAX runner's
    key (each chunk reuses it)."""
    inst = {k: v[:3] for k, v in tiny["inst"].items()}
    jrun, trun = tiny["jrun"], tiny["trun"]
    jrun.max_bucket = trun.max_bucket = max_bucket
    try:
        assert trun.bucket_for(3) == bucket
        with jax.disable_jit():
            want = jrun.infer(dict(inst))
        uniforms = coarse_uniforms(jax.random.PRNGKey(0), bucket,
                                   tiny["tcfg"].coarse_point_matching
                                   .nproposal1)
        got = trun.infer(dict(inst), uniforms=uniforms)
    finally:
        jrun.max_bucket = trun.max_bucket = None
    radius = np.asarray(jrun.template_bank["radius"])
    close_poses(got, want, radius)
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-6)


def test_weight_bridge_is_complete_and_round_trips(tiny, tmp_path):
    # load_state_dict is strict: every JAX leaf has a port parameter or
    # buffer and none is left over.
    model = TPEM(tiny["tcfg"], device="cpu")
    model.load_state_dict(tiny["state"])
    path = tmp_path / "pem.npz"
    save_npz(model.state_dict(), str(path))
    back = load_npz(str(path))
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())
    # Dense kernels are transposed into nn.Linear's (out, in) layout.
    k = np.asarray(tiny["variables"]["params"]["geo_embedding"]["proj_d"]
                   ["kernel"])
    np.testing.assert_array_equal(
        model.geo_embedding.proj_d.weight.detach().numpy(), k.T)


def test_template_bank_matches(tiny):
    # FPS indices and everything they gather are exact; the geometric
    # embedding holds 1e-5 away from the bg sentinel row/col (3e-3 there,
    # see test_torch_geo_embed.py); the rest is float32 rounding (1e-5,
    # the distance field 2e-5 as a difference of O(1) squares).
    jb = {k: np.asarray(v) for k, v in tiny["jrun"].template_bank.items()}
    tb = {k: v.float().numpy() for k, v in tiny["trun"].template_bank.items()}
    assert jb.keys() == tb.keys()
    for k in ("fps_idx_o", "sparse_po", "sparse_fo", "dense_po_n", "radius",
              "dense_fo"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    for k, atol in (("pe_o", 1e-5), ("fine_f2", 1e-5), ("dist_field", 2e-5)):
        np.testing.assert_allclose(tb[k], jb[k], atol=atol, err_msg=k)
    np.testing.assert_allclose(tb["geo_o"][:, 1:, 1:], jb["geo_o"][:, 1:, 1:],
                               atol=1e-5)
    np.testing.assert_allclose(tb["geo_o"], jb["geo_o"], atol=3e-3)


def test_forward_with_bank_matches(tiny):
    inst = tiny["inst"]
    B = len(inst["pts"])
    key = jax.random.PRNGKey(5)
    batch = {k: jnp.asarray(v) for k, v in inst.items() if k != "score"}
    model = tiny["model"]
    with jax.disable_jit():
        want = model.apply(
            tiny["variables"], batch["pts"], batch["rgb"], batch["rgb_choose"],
            batch["model_pts"], tiny["jrun"].template_bank, key,
            method=JPEM.forward_with_bank,
        )
    want = {k: np.asarray(v) for k, v in want.items()}
    u1, u2 = coarse_uniforms(key, B, tiny["tcfg"].coarse_point_matching
                             .nproposal1)
    tm = tiny["trun"].model
    got = tm.forward_with_bank(
        torch.from_numpy(inst["pts"]), torch.from_numpy(inst["rgb"]),
        torch.from_numpy(inst["rgb_choose"]).long(),
        torch.from_numpy(inst["model_pts"]), tiny["trun"].template_bank,
        uniforms=(torch.from_numpy(u1), torch.from_numpy(u2)),
    )
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["init_R"], want["init_R"], atol=ROT_ATOL)
    np.testing.assert_allclose(got["init_t"], want["init_t"], atol=ROT_ATOL)
    np.testing.assert_array_equal(got["radius"], want["radius"])
    close_poses(got, want, want["radius"][:, None],
                 score_key="pred_pose_score")


def test_onboarding_matches_and_caches(tiny, tmp_path):
    # Template onboarding: features of 2 views, FPS of their union to
    # fine_npoint.  The FPS runs on the raw template points, so its
    # indices and points are exact; features are float32 rounding.
    jcfg = tiny["jcfg"]
    S, C = jcfg.feature_extraction.img_size, jcfg.feature_extraction.out_dim
    rng = np.random.RandomState(8)
    T, Np = 2, 48
    rgb = rng.rand(T, S, S, 3).astype(np.float32)
    pts = (rng.randn(T, Np, 3) * 0.05).astype(np.float32)
    choose = rng.randint(0, S * S, (T, Np)).astype(np.int32)
    model = tiny["model"]
    with jax.disable_jit():
        jp, jf = model.apply(tiny["variables"], rgb, pts, choose,
                             method=JPEM.get_obj_feats)
    trun = TRunner(tiny["tcfg"], state_dict=tiny["state"], device="cpu")
    cache = str(tmp_path / "obj.npz")
    trun.onboard_arrays(rgb, pts, choose, cache_path=cache)
    np.testing.assert_array_equal(trun.tem_pts.numpy(), np.asarray(jp))
    np.testing.assert_allclose(trun.tem_feat.numpy(), np.asarray(jf),
                               atol=1e-5)
    # A second runner onboards from the cache alone and builds the same
    # bank.
    again = TRunner(tiny["tcfg"], state_dict=tiny["state"], device="cpu")
    again.onboard_arrays(None, None, None, cache_path=cache)
    for k, v in trun.template_bank.items():
        np.testing.assert_array_equal(again.template_bank[k].numpy(),
                                      v.numpy(), err_msg=k)


@pytest.mark.slow
def test_full_width_forward_with_bank_matches():
    """default_pem_config() in float32: ViT-B/16 at 224^2, 2048 points,
    6000 hypotheses, 196 coarse points; one instance."""
    jcfg, tcfg = jc.default_pem_config(), tc.default_pem_config()
    rng = np.random.RandomState(1)
    N, S = jcfg.fine_npoint, jcfg.feature_extraction.img_size
    C = jcfg.feature_extraction.out_dim
    inst, tem_pts, tem_feat = make_inputs(rng, 1, N, jcfg.n_sample_model_point,
                                          S, C)
    model = JPEM(jcfg)
    example = {k: jnp.asarray(v) for k, v in inst.items() if k != "score"}
    example.update(dense_po=jnp.asarray(tem_pts), dense_fo=jnp.asarray(tem_feat))
    variables = random_variables(model, example)
    key = jax.random.PRNGKey(2)
    with jax.disable_jit():
        jbank = model.apply(variables, tem_pts, tem_feat,
                            method=JPEM.make_template_bank)
        want = model.apply(
            variables, example["pts"], example["rgb"], example["rgb_choose"],
            example["model_pts"], jbank, key, method=JPEM.forward_with_bank,
        )
    want = {k: np.asarray(v) for k, v in want.items()}
    tm = TPEM(tcfg, device="cpu").eval()
    tm.load_state_dict(flax_to_state_dict(variables))
    tb = tm.make_template_bank(torch.from_numpy(tem_pts),
                               torch.from_numpy(tem_feat))
    np.testing.assert_array_equal(tb["fps_idx_o"].numpy(),
                                  np.asarray(jbank["fps_idx_o"]))
    u = coarse_uniforms(key, 1, tcfg.coarse_point_matching.nproposal1)
    got = tm.forward_with_bank(
        torch.from_numpy(inst["pts"]), torch.from_numpy(inst["rgb"]),
        torch.from_numpy(inst["rgb_choose"]).long(),
        torch.from_numpy(inst["model_pts"]), tb,
        uniforms=tuple(map(torch.from_numpy, u)),
    )
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_allclose(got["init_R"], want["init_R"], atol=ROT_ATOL)
    np.testing.assert_allclose(got["init_t"], want["init_t"], atol=ROT_ATOL)
    close_poses(got, want, want["radius"][:, None],
                 score_key="pred_pose_score")
