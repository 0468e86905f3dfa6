"""The port's weight converter (`sam6d_tpu_torch.convert_weights`) against
the JAX package's (`tools/convert_weights.py`) on the CPU.

For each kind (mae, pem with either upscaling head, dinov2, sam,
fastsam), a checkpoint in the released file's layout is synthesized from
a numpy seed at a tiny width (`tests/helpers/reference_checkpoints.py`)
and saved with `torch.save` as the released file stores it.  Then:
* the port's CLI output equals, bit for bit and key for key, the JAX
  converter's output on the same file mapped through the port's bridge
  (`params.flax_to_state_dict` / `sam_state_dict`), and loads into the
  port's module with `strict=True`;
* the port's module on the converted weights agrees with the JAX module
  on the JAX-converted weights, within 1e-5 (float32 rounding in another
  summation order, outputs of order 1-10);
* where a torch mirror of the reference module exists
  (tests/test_convert_weights.py, tests/test_fastsam_convert.py), it
  loads the synthetic checkpoint under its own names, and the port's
  module agrees with it within the mirror tests' 2e-4;
* a checkpoint that pickles a whole module object of a package that is
  not importable (as ultralytics' FastSAM files do) loads through the
  stub unpickler, in half precision as ultralytics stores it.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam6d_tpu.config as jc
import sam6d_tpu_torch.config as tc
import tools.convert_weights as jconv
from sam6d_tpu.models.ism.dinov2 import DescriptorModel as JDesc
from sam6d_tpu.models.ism.fastsam import YOLOv8Seg as JYOLO
from sam6d_tpu.models.ism.sam.model import SAM as JSAM
from sam6d_tpu.models.pem.feature_extraction import ViTAE as JViTAE
from sam6d_tpu.models.vit import ViT as JViT
from sam6d_tpu_torch import convert_weights as tconv
from sam6d_tpu_torch.models.ism.dinov2 import DescriptorModel as TDesc
from sam6d_tpu_torch.models.ism.fastsam import YOLOv8Seg as TYOLO
from sam6d_tpu_torch.models.ism.sam.model import SAM as TSAM
from sam6d_tpu_torch.models.pem.model import PEM as TPEM
from sam6d_tpu_torch.models.vit import ViT as TViT
from sam6d_tpu_torch.params import flax_to_state_dict, load_npz, sam_state_dict
from tests.test_convert_weights import TorchMaskDecoder, TorchViT
from tests.test_fastsam_convert import TYOLOv8Seg
from tests.test_torch_ism import TINY_DESC, TINY_ENCODER
from tests.test_torch_pem import tiny_config

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "helpers"))
from reference_checkpoints import checkpoint, reference_state_dict  # noqa: E402

torch.set_num_threads(2)

ATOL, MIRROR_ATOL = 1e-5, 2e-4
VIT = dict(patch=8, dim=32, depth=4, heads=4, img=32)


def deconv_config(c):
    cfg = tiny_config(c)
    return dataclasses.replace(cfg, feature_extraction=dataclasses.replace(
        cfg.feature_extraction, up_type="deconv"))


def port_module(kind):
    """The port module a converted file of `kind` loads into, on the CPU."""
    if kind == "mae":
        return TViT(VIT["patch"], VIT["dim"], VIT["depth"], VIT["heads"],
                    4.0, VIT["img"])
    if kind == "dinov2":
        return TDesc(tc.DescriptorConfig(**TINY_DESC)).vit
    if kind == "pem":
        return TPEM(tiny_config(tc), device="cpu")
    if kind == "pem_deconv":
        return TPEM(deconv_config(tc), device="cpu")
    if kind == "sam":
        return TSAM("vit_b", 64, encoder_kwargs=TINY_ENCODER, device="cpu")
    return TYOLO(0.25, 0.33)


def jax_convert(kind, sd):
    """tools/convert_weights.py's output at the tiny depths, through the
    port's bridge."""
    if kind == "mae":
        return flax_to_state_dict(
            {"params": jconv.convert_mae_vit(sd, VIT["depth"])})
    if kind == "dinov2":
        return flax_to_state_dict(
            {"params": jconv.convert_dino_vit(sd, TINY_DESC["depth"])})
    if kind.startswith("pem"):
        return flax_to_state_dict(jconv.convert_pem(sd))
    if kind == "sam":
        return sam_state_dict(jconv.convert_sam(sd, TINY_ENCODER["depth"]))
    return flax_to_state_dict(jconv.convert_fastsam(sd))


def converted(kind, tmp_path, seed=0):
    """(reference state dict, port module with the CLI's output loaded
    strictly, the CLI's output, the JAX converter's on the same file)."""
    module = port_module(kind)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    cli_kind = "pem" if kind.startswith("pem") else kind
    ref = reference_state_dict(cli_kind, shapes, seed)
    ckpt, out = tmp_path / f"{kind}.pth", tmp_path / f"{kind}.npz"
    torch.save(checkpoint(cli_kind, {k: torch.from_numpy(v)
                                     for k, v in ref.items()}), ckpt)
    tconv.main(["--kind", cli_kind, "--ckpt", str(ckpt), "--out", str(out)])
    got = load_npz(str(out))
    module.load_state_dict(got)  # strict
    want = jax_convert(kind, jconv.load_torch_state_dict(str(ckpt)))
    return ref, module.eval(), got, want


KINDS = ["mae", "pem", "pem_deconv", "dinov2", "sam", "fastsam"]


@pytest.mark.parametrize("kind", KINDS)
def test_cli_output_equals_the_jax_converters_bit_for_bit(kind, tmp_path):
    _, module, got, want = converted(kind, tmp_path)
    assert list(got) and got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert got.keys() == module.state_dict().keys()
    if kind == "sam":
        assert sum(k.startswith("prompt.mask_downscaling") for k in got) == 10


def test_mae_matches_jax_and_the_torch_mirror(tmp_path, rng):
    ref, tvit, _, _ = converted("mae", tmp_path)
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    jvit = JViT(patch_size=VIT["patch"], embed_dim=VIT["dim"],
                depth=VIT["depth"], num_heads=VIT["heads"], img_size=32)
    want = jvit.apply({"params": jconv.convert_mae_vit(ref, VIT["depth"])},
                      jnp.asarray(x))
    mirror = TorchViT(**VIT).eval()
    mirror.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()
                            if not k.startswith("head")})
    with torch.no_grad():
        got = tvit(torch.from_numpy(x))
        mirrored = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(want) == len(mirrored) == 4
    for g, w, m in zip(got, want, mirrored):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), m.numpy(), atol=MIRROR_ATOL)


def test_dinov2_matches_jax(tmp_path, rng):
    ref, tvit, _, _ = converted("dinov2", tmp_path)
    jdesc = JDesc(jc.DescriptorConfig(**TINY_DESC))
    params = jconv.convert_dino_vit(ref, TINY_DESC["depth"])
    x = rng.randn(3, 28, 28, 3).astype(np.float32)
    want = jdesc.vit.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tvit(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("kind", ["pem", "pem_deconv"])
def test_pem_feature_extraction_matches_jax(kind, tmp_path, rng):
    ref, pem, _, _ = converted(kind, tmp_path)
    cfg = (deconv_config if kind == "pem_deconv" else tiny_config)(jc)
    params = jconv.convert_pem(ref)["params"]
    x = rng.rand(2, 32, 32, 3).astype(np.float32)
    want_map, want_cls = JViTAE(cfg.feature_extraction).apply(
        {"params": params["feature_extraction"]["rgb_net"]}, jnp.asarray(x),
        lowres=True)
    with torch.no_grad():
        got_map, got_cls = pem.feature_extraction.rgb_net(torch.from_numpy(x))
    assert got_map.shape == (2, 16, 16, 32)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                               atol=ATOL)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               atol=ATOL)


def test_sam_matches_jax_and_the_decoder_mirror(tmp_path, rng):
    ref, tsam, _, _ = converted("sam", tmp_path)
    jsam = JSAM(model_type="vit_b", img_size=64, encoder_kwargs=TINY_ENCODER)
    jsam.variables = jax.tree.map(
        jnp.asarray, jconv.convert_sam(ref, TINY_ENCODER["depth"]))
    img = rng.randn(1, 64, 64, 3).astype(np.float32)
    pts = (rng.rand(2, 2, 2) * 64).astype(np.float32)
    labels = np.array([[1, 0], [1, 1]], np.int32)
    boxes = np.array([[4.0, 6.0, 40.0, 50.0], [10.0, 3.0, 60.0, 33.0]],
                     np.float32)
    masks = rng.randn(2, 16, 16, 1).astype(np.float32)
    emb = jsam.encode(jnp.asarray(img))
    want = jsam.decode_prompts(emb, jnp.asarray(pts), jnp.asarray(labels),
                               jnp.asarray(boxes), jnp.asarray(masks))
    with torch.no_grad():
        temb = tsam.encode(torch.from_numpy(img))
        got = tsam.decode_prompts(temb, torch.from_numpy(pts),
                                  torch.from_numpy(labels).long(),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(masks))
    np.testing.assert_allclose(temb.numpy(), np.asarray(emb), atol=ATOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)

    # The reference decoder (mask_decoder.py, checkpoint names) on the
    # same prompts through the port's prompt encoder.
    mirror = TorchMaskDecoder().eval()
    n = len("mask_decoder.")
    mirror.load_state_dict({k[n:]: torch.from_numpy(v) for k, v in ref.items()
                            if k.startswith("mask_decoder.")})
    with torch.no_grad():
        sparse, dense, pe = tsam.prompt(
            torch.from_numpy(pts), torch.from_numpy(labels).long(),
            torch.from_numpy(boxes), torch.from_numpy(masks))
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        m_masks, m_iou = mirror(nchw(temb).expand(2, -1, -1, -1), nchw(pe),
                                sparse, nchw(dense))
    np.testing.assert_allclose(got[0].numpy(), m_masks.numpy(),
                               atol=MIRROR_ATOL, rtol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), m_iou.numpy(),
                               atol=MIRROR_ATOL, rtol=1e-3)


def test_fastsam_matches_jax_and_the_torch_mirror(tmp_path, rng):
    ref, tnet, _, _ = converted("fastsam", tmp_path)
    x = rng.rand(1, 128, 128, 3).astype(np.float32)
    want_outs, want_proto = JYOLO(width=0.25, depth=0.33).apply(
        jconv.convert_fastsam(ref), jnp.asarray(x))
    mirror = TYOLOv8Seg(width=0.25, depth=0.33).eval()
    missing, unexpected = mirror.load_state_dict(
        {k[len("model."):]: torch.from_numpy(v) for k, v in ref.items()},
        strict=False)
    assert all(k.endswith("num_batches_tracked") for k in missing)
    assert unexpected == ["model.22.dfl.conv.weight"]
    with torch.no_grad():
        got_outs, got_proto = tnet(torch.from_numpy(x))
        m_outs, m_proto = mirror(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    pairs = [(got_proto, want_proto, m_proto)] + [
        t for g, w, m in zip(got_outs, want_outs, m_outs)
        for t in zip(g, w, m)]
    for g, w, m in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), m.permute(0, 2, 3, 1).numpy(),
                                   atol=MIRROR_ATOL, rtol=1e-3)


MODEL_SOURCE = '''
import torch


class SegmentationModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.model = torch.nn.ModuleList([
            torch.nn.Conv2d(3, 8, 3), torch.nn.BatchNorm2d(8)])
'''


def test_pickled_module_of_a_missing_package_loads_through_stubs(tmp_path):
    pkg = tmp_path / "fake_ultralytics"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(MODEL_SOURCE)
    sys.path.insert(0, str(tmp_path))
    try:
        import fake_ultralytics

        model = fake_ultralytics.SegmentationModel()
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape))
        model.half()
        torch.save({"model": model, "epoch": 3}, tmp_path / "fastsam.pt")
    finally:
        sys.path.remove(str(tmp_path))
        del sys.modules["fake_ultralytics"]
    with pytest.raises(ModuleNotFoundError):
        torch.load(tmp_path / "fastsam.pt", weights_only=False)
    want = {k: v.float().numpy() for k, v in model.state_dict().items()}
    for load in (tconv.load_torch_state_dict, jconv.load_torch_state_dict):
        got = load(str(tmp_path / "fastsam.pt"))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
