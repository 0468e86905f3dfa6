"""Convert released torch checkpoints into the port's `.npz` state dicts.

Counterpart of `tools/convert_weights.py`.  Each converter relays the
checkpoint out into the JAX package's variable tree (numpy, the same
relayout as the JAX converter), which `params.flax_to_state_dict` /
`params.sam_state_dict` map onto the port's modules (they carry the flax
names), and `params.save_npz` writes it.  The output is the file that
`pipeline/demo.py --*_params`, `PEMRunner.load_params` and
`load_state_dict(params.load_npz(path))` read.

Kinds and the module each output loads into:
  * mae     MAE ViT (mae_pretrain_vit_base.pth)  -> `models.vit.ViT`
            (the PEM's `feature_extraction.rgb_net.vit`)
  * pem     SAM-6D PEM (sam-6d-pem-base.pth)     -> `models.pem.model.PEM`,
            either upscaling head (ViTConfig.up_type "linear" / "deconv")
  * dinov2  DINOv2 (dinov2_vitl14_pretrain.pth)  -> `DescriptorModel.vit`
  * sam     SAM (sam_vit_h_4b8939.pth)           -> `models.ism.sam.model.SAM`
  * fastsam FastSAM (FastSAM-x.pt, ultralytics)  -> `FastSAM.net`

Block counts are read from the checkpoint's keys (the JAX CLI fixes the
MAE's at 12, DINOv2's at 24 and the PEM's at 3 + 3 over a 12-block ViT,
and picks SAM's among 32, 24 and 12; the released files give the same).
Layout rules: torch Linear (out, in) -> Dense kernel (in, out), which the
bridge transposes back; Conv2d (out, in, kh, kw) -> (kh, kw, in, out);
LayerNorm / BatchNorm weight, bias and running statistics by name.

Usage:
  python -m sam6d_tpu_torch.convert_weights --kind sam \\
      --ckpt sam_vit_h_4b8939.pth --out sam_vit_h.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from sam6d_tpu_torch.models.ism.fastsam import FASTSAM_LAYER_MAP
from sam6d_tpu_torch.params import flax_to_state_dict, sam_state_dict, save_npz

KINDS = ("mae", "pem", "dinov2", "sam", "fastsam")


def _t(x):
    return np.asarray(x)


def _count(sd, prefix: str) -> int:
    """Number of consecutive blocks `{prefix}0.`, `{prefix}1.`, ... in sd."""
    n = 0
    while any(k.startswith(f"{prefix}{n}.") for k in sd):
        n += 1
    return n


def linear(sd, p):
    out = {"kernel": _t(sd[f"{p}.weight"]).T}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def layernorm(sd, p):
    return {"scale": _t(sd[f"{p}.weight"]), "bias": _t(sd[f"{p}.bias"])}


def conv2d(sd, p):
    out = {"kernel": _t(sd[f"{p}.weight"]).transpose(2, 3, 1, 0)}
    if f"{p}.bias" in sd:
        out["bias"] = _t(sd[f"{p}.bias"])
    return out


def batchnorm(sd, p):
    params = {"scale": _t(sd[f"{p}.weight"]), "bias": _t(sd[f"{p}.bias"])}
    stats = {"mean": _t(sd[f"{p}.running_mean"]),
             "var": _t(sd[f"{p}.running_var"])}
    return params, stats


def _vit_block(sd, b):
    return {
        "norm1": layernorm(sd, f"{b}.norm1"),
        "attn": {"qkv": linear(sd, f"{b}.attn.qkv"),
                 "proj": linear(sd, f"{b}.attn.proj")},
        "norm2": layernorm(sd, f"{b}.norm2"),
        "mlp": {"fc1": linear(sd, f"{b}.mlp.fc1"),
                "fc2": linear(sd, f"{b}.mlp.fc2")},
    }


def convert_vit_backbone(sd, prefix: str = ""):
    """timm / MAE-layout ViT -> the ViT tree (`models/vit.py`)."""
    p = (prefix + ".") if prefix else ""
    params = {
        "patch_embed": conv2d(sd, f"{p}patch_embed.proj"),
        "cls_token": _t(sd[f"{p}cls_token"]),
        "pos_embed": _t(sd[f"{p}pos_embed"]),
        "norm": layernorm(sd, f"{p}norm"),
    }
    for i in range(_count(sd, f"{p}blocks.")):
        params[f"blocks_{i}"] = _vit_block(sd, f"{p}blocks.{i}")
    return params


def convert_mae_vit(sd):
    """MAE pretrain checkpoint -> the ViT tree (head keys ignored)."""
    return convert_vit_backbone(
        {k: v for k, v in sd.items() if not k.startswith("head")})


def convert_dino_vit(sd):
    """DINOv2 checkpoint -> the DinoViT tree (`models/ism/dinov2.py`)."""
    params = convert_vit_backbone(sd)
    for i in range(_count(sd, "blocks.")):
        for ls in ("ls1", "ls2"):
            params[f"blocks_{i}"][ls] = {
                "gamma": _t(sd[f"blocks.{i}.{ls}.gamma"])}
    return params


def _attention_layer(sd, p, rpe: bool):
    """Reference (RPE)TransformerLayer -> the flattened layer tree."""
    names = ("proj_q", "proj_k", "proj_v") + (("proj_p",) if rpe else ())
    return {
        "attention": {n: linear(sd, f"{p}.attention.attention.{n}")
                      for n in names},
        "linear": linear(sd, f"{p}.attention.linear"),
        "norm": layernorm(sd, f"{p}.attention.norm"),
        "output": {n: (layernorm if n == "norm" else linear)(
            sd, f"{p}.output.{n}") for n in ("expand", "squeeze", "norm")},
    }


def _geometric_transformer(sd, p):
    """blocks = (self with RPE, cross)."""
    return {"layers_0": _attention_layer(sd, f"{p}.layers.0", rpe=True),
            "layers_1": _attention_layer(sd, f"{p}.layers.1", rpe=False)}


def _linear_attention_layer(sd, p):
    out = _attention_layer(sd, p, rpe=False)
    out["attention"]["scale"] = _t(sd[f"{p}.attention.attention.scale"])
    return out


def _shared_mlp(sd, p, n_layers: int):
    """pointnet2 SharedMLP (1x1 conv + BN) -> Dense + BN stack."""
    params, stats = {}, {}
    for i in range(n_layers):
        params[f"dense_{i}"] = {
            "kernel": _t(sd[f"{p}.layer{i}.conv.weight"])[:, :, 0, 0].T}
        params[f"bn_{i}"], stats[f"bn_{i}"] = batchnorm(
            sd, f"{p}.layer{i}.bn.bn")
    return params, stats


def _conv_transpose_as_dense(sd, p):
    """ConvTranspose2d(k=2, s=2) (in, out, kh, kw) -> a Dense whose
    columns nest (a, b, out), the bias tiled 4x (ViTAE's deconv head)."""
    w = _t(sd[f"{p}.weight"])
    return {"kernel": w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1),
            "bias": np.tile(_t(sd[f"{p}.bias"]), 4)}


def convert_pem(sd):
    """Full SAM-6D PEM checkpoint -> {"params", "batch_stats"}."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    vit_prefix = "feature_extraction.rgb_net.vit."
    rgb_net = {"vit": convert_vit_backbone(
        {k[len(vit_prefix):]: v for k, v in sd.items()
         if k.startswith(vit_prefix)})}
    up = "feature_extraction.rgb_net.output_upscaling"
    if f"{up}.0.weight" in sd:  # the deconv head (a Sequential)
        rgb_net["upscale_deconv1"] = _conv_transpose_as_dense(sd, f"{up}.0")
        rgb_net["upscale_ln"] = layernorm(sd, f"{up}.1")
        rgb_net["upscale_deconv2"] = _conv_transpose_as_dense(sd, f"{up}.3")
    else:
        rgb_net["output_upscaling"] = linear(sd, up)
    params = {
        "feature_extraction": {"rgb_net": rgb_net},
        "geo_embedding": {"proj_d": linear(sd, "geo_embedding.proj_d"),
                          "proj_a": linear(sd, "geo_embedding.proj_a")},
    }
    stages = {}
    for name in ("coarse_point_matching", "fine_point_matching"):
        stages[name] = {
            "in_proj": linear(sd, f"{name}.in_proj"),
            "out_proj": linear(sd, f"{name}.out_proj"),
            "bg_token": _t(sd[f"{name}.bg_token"]),
        }
    coarse, fine = (stages["coarse_point_matching"],
                    stages["fine_point_matching"])
    c = "coarse_point_matching.transformers"
    for i in range(_count(sd, f"{c}.")):
        coarse[f"transformers_{i}"] = _geometric_transformer(sd, f"{c}.{i}")

    pe_params, pe_stats = {}, {}
    for mlp in ("mlp1", "mlp2"):
        pe_params[mlp], pe_stats[mlp] = _shared_mlp(
            sd, f"fine_point_matching.PE.{mlp}", 3)
    pe_params["mlp3"] = {
        "kernel": _t(sd["fine_point_matching.PE.mlp3.conv.weight"])[:, :, 0].T,
        "bias": _t(sd["fine_point_matching.PE.mlp3.conv.bias"]),
    }
    fine["PE"] = pe_params
    f = "fine_point_matching.transformers"
    for i in range(_count(sd, f"{f}.")):
        fine[f"transformers_{i}"] = {
            "sparse_layer": _geometric_transformer(sd, f"{f}.{i}.sparse_layer"),
            "dense_layer": _linear_attention_layer(sd, f"{f}.{i}.dense_layer"),
        }
    params.update(stages)
    return {"params": params,
            "batch_stats": {"fine_point_matching": {"PE": pe_stats}}}


def _conv_block(sd, p):
    """ultralytics Conv (conv + BN + SiLU) -> ConvBNSiLU params, stats."""
    bn_p, bn_s = batchnorm(sd, f"{p}.bn")
    return ({"conv": {"kernel": _t(sd[f"{p}.conv.weight"]).transpose(
        2, 3, 1, 0)}, "bn": bn_p}, {"bn": bn_s})


def _conv_blocks(sd, p, names):
    params, stats = {}, {}
    for name in names:
        params[name], stats[name] = _conv_block(sd, f"{p}.{name}")
    return params, stats


def convert_fastsam(sd):
    """ultralytics YOLOv8-seg / FastSAM state dict (model.N.* keys) ->
    the YOLOv8Seg tree {"params", "batch_stats"}.  Indices follow
    FASTSAM_LAYER_MAP; model.22 is the Segment head.  The DFL conv (fixed
    arange weights) is dropped: `decode_boxes` computes the expectation
    over the bins directly."""
    def strip(k):
        while k.startswith("model."):
            k = k[len("model."):]
        return k

    sd = {strip(k): v for k, v in sd.items()}
    params, stats = {}, {}
    for idx, name in FASTSAM_LAYER_MAP.items():
        p = str(idx)
        if f"{p}.m.0.cv1.conv.weight" in sd:  # C2f
            params[name], stats[name] = _conv_blocks(sd, p, ("cv1", "cv2"))
            for i in range(_count(sd, f"{p}.m.")):
                params[name][f"m_{i}"], stats[name][f"m_{i}"] = _conv_blocks(
                    sd, f"{p}.m.{i}", ("cv1", "cv2"))
        elif f"{p}.cv1.conv.weight" in sd:  # SPPF
            params[name], stats[name] = _conv_blocks(sd, p, ("cv1", "cv2"))
        else:
            params[name], stats[name] = _conv_block(sd, p)

    h = "22"
    for i in (1, 2, 3):
        params[f"proto_cv{i}"], stats[f"proto_cv{i}"] = _conv_block(
            sd, f"{h}.proto.cv{i}")
    # torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose
    # (kh, kw, in, out), spatially flipped (`fastsam.ConvTranspose2x2`).
    up_w = _t(sd[f"{h}.proto.upsample.weight"]).transpose(2, 3, 0, 1)
    params["proto_up"] = {"kernel": np.ascontiguousarray(up_w[::-1, ::-1]),
                          "bias": _t(sd[f"{h}.proto.upsample.bias"])}
    for i in range(3):
        for branch, name in (("cv2", "box"), ("cv3", "cls"), ("cv4", "mask")):
            for j in range(2):
                key = f"head_{name}{j + 1}_{i}"
                params[key], stats[key] = _conv_block(
                    sd, f"{h}.{branch}.{i}.{j}")
            params[f"head_{name}3_{i}"] = conv2d(sd, f"{h}.{branch}.{i}.2")
    return {"params": params, "batch_stats": stats}


def convert_sam_encoder(sd):
    """SAM checkpoint (image_encoder.* keys) -> the ImageEncoderViT tree."""
    p = "image_encoder."
    params = {
        "patch_embed": conv2d(sd, f"{p}patch_embed.proj"),
        "pos_embed": _t(sd[f"{p}pos_embed"]),
    }
    for i in (0, 2):
        params[f"neck_{i}"] = {
            "kernel": _t(sd[f"{p}neck.{i}.weight"]).transpose(2, 3, 1, 0)}
        params[f"neck_{i + 1}"] = {"weight": _t(sd[f"{p}neck.{i + 1}.weight"]),
                                   "bias": _t(sd[f"{p}neck.{i + 1}.bias"])}
    for i in range(_count(sd, f"{p}blocks.")):
        b = f"{p}blocks.{i}"
        blk = {
            "norm1": layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": linear(sd, f"{b}.attn.qkv"),
                     "proj": linear(sd, f"{b}.attn.proj")},
            "norm2": layernorm(sd, f"{b}.norm2"),
            "mlp_lin1": linear(sd, f"{b}.mlp.lin1"),
            "mlp_lin2": linear(sd, f"{b}.mlp.lin2"),
        }
        if f"{b}.attn.rel_pos_h" in sd:
            blk["attn"]["rel_pos_h"] = _t(sd[f"{b}.attn.rel_pos_h"])
            blk["attn"]["rel_pos_w"] = _t(sd[f"{b}.attn.rel_pos_w"])
        params[f"blocks_{i}"] = blk
    return params


def convert_sam_prompt(sd):
    """SAM checkpoint (prompt_encoder.* keys) -> the PromptEncoder tree:
    point and corner embeddings, the no-mask embedding and the mask
    downscaling stack (2x2 convs (O, I, 2, 2) -> (2, 2, I, O); the 1x1
    conv, index 6, -> a Dense kernel (I, O))."""
    p = "prompt_encoder."
    params = {
        "pe_layer": {"positional_encoding_gaussian_matrix": _t(
            sd[f"{p}pe_layer.positional_encoding_gaussian_matrix"])},
        "not_a_point_embed": _t(sd[f"{p}not_a_point_embed.weight"]),
        "no_mask_embed": _t(sd[f"{p}no_mask_embed.weight"]),
    }
    for i in range(4):
        params[f"point_embed_{i}"] = _t(sd[f"{p}point_embeddings.{i}.weight"])
    for i in (0, 3):
        params[f"mask_downscaling_{i}"] = conv2d(sd, f"{p}mask_downscaling.{i}")
    for i in (1, 4):
        params[f"mask_downscaling_{i}"] = {
            "weight": _t(sd[f"{p}mask_downscaling.{i}.weight"]),
            "bias": _t(sd[f"{p}mask_downscaling.{i}.bias"])}
    params["mask_downscaling_6"] = {
        "kernel": _t(sd[f"{p}mask_downscaling.6.weight"])[:, :, 0, 0].T,
        "bias": _t(sd[f"{p}mask_downscaling.6.bias"])}
    return params


def _cross_attention(sd, p):
    return {n: linear(sd, f"{p}.{n}")
            for n in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _conv_transpose_2x2(sd, p):
    """torch ConvTranspose2d (in, out, kh, kw) -> (kh, kw, in, out), not
    flipped: the decoder's ConvTranspose2x2 has torch's semantics."""
    return {"kernel": _t(sd[f"{p}.weight"]).transpose(2, 3, 0, 1),
            "bias": _t(sd[f"{p}.bias"])}


def _mlp(sd, p, n_layers):
    return {f"layers_{i}": linear(sd, f"{p}.layers.{i}")
            for i in range(n_layers)}


def convert_sam_decoder(sd):
    """SAM checkpoint (mask_decoder.* keys) -> the MaskDecoder tree."""
    p = "mask_decoder."
    tr = {}
    for i in range(_count(sd, f"{p}transformer.layers.")):
        b = f"{p}transformer.layers.{i}"
        tr[f"layers_{i}"] = {
            **{n: _cross_attention(sd, f"{b}.{n}")
               for n in ("self_attn", "cross_attn_token_to_image",
                         "cross_attn_image_to_token")},
            "mlp_lin1": linear(sd, f"{b}.mlp.lin1"),
            "mlp_lin2": linear(sd, f"{b}.mlp.lin2"),
            **{f"norm{j}": layernorm(sd, f"{b}.norm{j}") for j in (1, 2, 3, 4)},
        }
    tr["final_attn_token_to_image"] = _cross_attention(
        sd, f"{p}transformer.final_attn_token_to_image")
    tr["norm_final_attn"] = layernorm(sd, f"{p}transformer.norm_final_attn")
    params = {
        "iou_token": _t(sd[f"{p}iou_token.weight"]),
        "mask_tokens": _t(sd[f"{p}mask_tokens.weight"]),
        "transformer": tr,
        "output_upscaling_0": _conv_transpose_2x2(sd, f"{p}output_upscaling.0"),
        "output_upscaling_1": {
            "weight": _t(sd[f"{p}output_upscaling.1.weight"]),
            "bias": _t(sd[f"{p}output_upscaling.1.bias"])},
        "output_upscaling_3": _conv_transpose_2x2(sd, f"{p}output_upscaling.3"),
        "iou_prediction_head": _mlp(sd, f"{p}iou_prediction_head", 3),
    }
    for i in range(_count(sd, f"{p}output_hypernetworks_mlps.")):
        params[f"output_hypernetworks_mlps_{i}"] = _mlp(
            sd, f"{p}output_hypernetworks_mlps.{i}", 3)
    return params


def convert_sam(sd):
    """Full SAM checkpoint -> the {encoder, prompt, decoder} trees of the
    JAX SAM's variables."""
    return {"encoder": {"params": convert_sam_encoder(sd)},
            "prompt": {"params": convert_sam_prompt(sd)},
            "decoder": {"params": convert_sam_decoder(sd)}}


def convert_checkpoint(kind: str, sd: dict) -> dict:
    """A reference-layout state dict (numpy) -> the port's state dict of
    `kind` (float32 tensors, torch keys)."""
    if kind == "sam":
        return sam_state_dict(convert_sam(sd))
    convert = {"mae": lambda s: {"params": convert_mae_vit(s)},
               "dinov2": lambda s: {"params": convert_dino_vit(s)},
               "pem": convert_pem, "fastsam": convert_fastsam}[kind]
    return flax_to_state_dict(convert(sd))


def _walk_module_dict(obj, prefix="") -> dict:
    """The state dict of a pickled nn.Module object graph whose defining
    package (e.g. ultralytics) is not importable: the stub objects keep
    the _parameters / _buffers / _modules dicts in __dict__."""
    d = getattr(obj, "__dict__", None) or {}
    out = {}
    for group in ("_parameters", "_buffers"):
        for name, t in (d.get(group) or {}).items():
            if t is not None:
                out[prefix + name] = t
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            out.update(_walk_module_dict(m, prefix + name + "."))
    return out


def _torch_load_with_stubs(path: str):
    """torch.load that makes a plain stub class for every class it cannot
    import (ultralytics checkpoints pickle whole model objects)."""
    import pickle
    import types

    import torch

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (), {})

    shim = types.ModuleType("stub_pickle")
    shim.Unpickler = StubUnpickler
    shim.load = pickle.load
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=shim)


def load_torch_state_dict(path: str) -> dict:
    """A torch checkpoint -> {key: float32 numpy array}.  Unwraps
    {"model" | "state_dict" | "model_state_dict": ...}; a pickled module
    (ultralytics) gives its state dict, through stub classes when its
    package is not importable.  `weights_only=False` is explicit: newer
    torch defaults to True, which refuses pickled modules.  Only load
    checkpoints from a source you trust: unpickling can run code."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        ckpt = _torch_load_with_stubs(path)
    if isinstance(ckpt, dict):
        for key in ("model", "state_dict", "model_state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    if not isinstance(ckpt, dict):
        if isinstance(ckpt, torch.nn.Module):
            ckpt = ckpt.float().state_dict()
        else:  # a stub-unpickled object graph
            ckpt = _walk_module_dict(ckpt)
    return {k: v.detach().float().numpy() if hasattr(v, "detach")
            else np.asarray(v)
            for k, v in ckpt.items() if hasattr(v, "numpy")}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--ckpt", required=True, help="torch checkpoint")
    p.add_argument("--out", required=True, help="output .npz")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    sd = load_torch_state_dict(args.ckpt)
    t1 = time.perf_counter()
    state = convert_checkpoint(args.kind, sd)
    del sd  # the checkpoint's copy; the state dict is the only one left
    t2 = time.perf_counter()
    save_npz(state, args.out)
    t3 = time.perf_counter()
    print(f"saved {len(state)} tensors of {args.kind} to {args.out} (host "
          f"clock: load {t1 - t0:.2f} s, relayout {t2 - t1:.2f} s, save "
          f"{t3 - t2:.2f} s)")


if __name__ == "__main__":
    main()
