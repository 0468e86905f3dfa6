"""Synthetic checkpoints in the released files' layouts, shared by the CPU
tests of the weight converter and by chip_smoke.py.

`reference_state_dict(kind, shapes, seed)` draws seeded values in the
shapes of a port module's state dict (`{key: shape}`) and lays them out
under the key names and tensor layouts of the released checkpoint of
`kind` (the reference's torch modules), by the inverse of the relayout
in `sam6d_tpu_torch/convert_weights.py`.  The tests check the names
independently: the JAX package's converter (`tools/convert_weights.py`)
must accept them and produce what the port's converter produces, and
where a torch mirror of the reference module exists
(tests/test_fastsam_convert.py, tests/test_convert_weights.py) its
`load_state_dict` must accept them too.  Extra keys that the released
files carry and the converters drop are added: MAE's `head.*`,
DINOv2's `mask_token`, FastSAM's DFL conv.

Values are drawn at fan-in scale: kernels N(0, 1 / fan_in), norm scales
1 + N(0, 0.05^2), biases N(0, 0.05^2), BatchNorm variances U(0.5, 1.5)
and means N(0, 0.1^2), so that activations stay finite at full width.

`checkpoint(kind, sd)` wraps a state dict as the released file stores
it.  This module imports numpy only, so the card's machine can load it.
"""

import re

import numpy as np

FASTSAM_INDEX = {
    "stem": 0, "down1": 1, "c2f_1": 2, "down2": 3, "c2f_2": 4, "down3": 5,
    "c2f_3": 6, "down4": 7, "c2f_4": 8, "sppf": 9, "neck_c2f_1": 12,
    "neck_c2f_2": 15, "neck_down1": 16, "neck_c2f_3": 18, "neck_down2": 19,
    "neck_c2f_4": 21,
}
UNIT_NORMAL = ("positional_encoding_gaussian_matrix", "not_a_point_embed",
               "no_mask_embed", "iou_token", "mask_tokens")


def draw(key, shape, rng):
    """A port-layout value for `key` (float32)."""
    leaf = key.rsplit(".", 1)[-1]
    r = rng.standard_normal(shape, dtype=np.float32)
    if leaf == "kernel":
        r /= np.float32(np.sqrt(np.prod(shape[:-1])))
    elif leaf == "weight" and len(shape) == 2:
        r /= np.float32(np.sqrt(shape[1]))
    elif leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    elif leaf in ("weight", "gamma"):
        r = 1.0 + np.float32(0.05) * r
    elif leaf in ("bias", "scale"):
        r *= np.float32(0.05)
    elif leaf in ("cls_token", "pos_embed", "bg_token"):
        r *= np.float32(0.02)
    elif leaf in UNIT_NORMAL or leaf.startswith("point_embed_"):
        pass
    else:  # running_mean, rel-pos tables
        r *= np.float32(0.1)
    return r


def _dots(key):
    """flax list names (blocks_3, layers_0) -> torch ModuleList indices."""
    return re.sub(r"_(\d+)(?=\.|$)", r".\1", key)


def _conv(v):
    """(kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return v.transpose(3, 2, 0, 1)


def _vit(key, v):
    if key == "patch_embed.kernel":
        return "patch_embed.proj.weight", _conv(v)
    if key == "patch_embed.bias":
        return "patch_embed.proj.bias", v
    return _dots(key), v


def _sam(key, v):
    part, rest = key.split(".", 1)
    rest = rest.replace("mlp_lin", "mlp.lin")
    if part == "encoder":
        if rest.startswith("patch_embed."):
            rest, v = _vit(rest, v)
        elif rest.startswith("neck_") and rest.endswith(".kernel"):
            rest, v = rest[:-len("kernel")] + "weight", _conv(v)
        return "image_encoder." + _dots(rest), v
    if part == "prompt":
        m = re.fullmatch(r"point_embed_(\d)", rest)
        if m:
            return f"prompt_encoder.point_embeddings.{m.group(1)}.weight", v
        if rest in ("not_a_point_embed", "no_mask_embed"):
            rest += ".weight"
        elif rest == "mask_downscaling_6.weight":
            v = v[:, :, None, None]
        elif rest.endswith(".kernel"):  # mask_downscaling_0 / _3
            rest, v = rest[:-len("kernel")] + "weight", _conv(v)
        return "prompt_encoder." + _dots(rest), v
    if rest in ("iou_token", "mask_tokens"):
        rest += ".weight"
    elif rest.startswith("output_upscaling_") and rest.endswith(".kernel"):
        # (kh, kw, in, out) -> ConvTranspose2d (in, out, kh, kw).
        rest, v = rest[:-len("kernel")] + "weight", v.transpose(2, 3, 0, 1)
    return "mask_decoder." + _dots(rest), v


def _pem(key, v):
    vit = "feature_extraction.rgb_net.vit."
    if key.startswith(vit):
        rest, v = _vit(key[len(vit):], v)
        return "module." + vit + rest, v
    up = "feature_extraction.rgb_net."
    m = re.fullmatch(re.escape(up) + r"upscale_deconv([12])\.(weight|bias)",
                     key)
    if m:  # Dense (4 * out, in), columns (a, b, out) -> (in, out, 2, 2)
        idx = {"1": 0, "2": 3}[m.group(1)]
        if m.group(2) == "weight":
            out = v.shape[0] // 4
            v = v.T.reshape(v.shape[1], 2, 2, out).transpose(0, 3, 1, 2)
        else:
            v = v[:len(v) // 4]
        return f"module.{up}output_upscaling.{idx}.{m.group(2)}", v
    key = key.replace(up + "upscale_ln.", up + "output_upscaling.1.")
    m = re.fullmatch(r"(.*\.PE\.mlp\d)\.(dense|bn)_(\d)\.(\w+)", key)
    if m:
        p, kind, i, leaf = m.groups()
        if kind == "dense":
            return f"module.{p}.layer{i}.conv.weight", v[:, :, None, None]
        return f"module.{p}.layer{i}.bn.bn.{leaf}", v
    m = re.fullmatch(r"(.*\.PE\.mlp3)\.(weight|bias)", key)
    if m:
        return (f"module.{m.group(1)}.conv.{m.group(2)}",
                v[:, :, None] if m.group(2) == "weight" else v)
    key = re.sub(r"\.attention\.(proj_[qkvp]|scale)\.?",
                 r".attention.attention.\1.", key).rstrip(".")
    key = re.sub(r"(layers_\d+|dense_layer)\.(linear|norm)\.",
                 r"\1.attention.\2.", key)
    return "module." + _dots(key), v


def _fastsam(key, v):
    first, rest = key.split(".", 1)
    head = re.fullmatch(r"head_(box|cls|mask)(\d)_(\d)", first)
    if first in FASTSAM_INDEX:
        prefix = f"model.model.{FASTSAM_INDEX[first]}"
    elif first.startswith("proto_cv"):
        prefix = f"model.model.22.proto.cv{first[-1]}"
    elif first == "proto_up":
        # flax ConvTranspose (kh, kw, in, out), flipped -> torch's.
        if rest == "kernel":
            rest, v = "weight", v[::-1, ::-1].transpose(2, 3, 0, 1)
        return f"model.model.22.proto.upsample.{rest}", v
    else:
        branch = {"box": "cv2", "cls": "cv3", "mask": "cv4"}[head.group(1)]
        prefix = (f"model.model.22.{branch}.{head.group(3)}."
                  f"{int(head.group(2)) - 1}")
    if rest.endswith("kernel"):
        rest, v = rest[:-len("kernel")] + "weight", _conv(v)
    return f"{prefix}.{_dots(rest)}", v


_RELAYOUT = {"mae": _vit, "dinov2": _vit, "pem": _pem, "sam": _sam,
             "fastsam": _fastsam}


def reference_state_dict(kind: str, shapes: dict, seed: int = 0) -> dict:
    """{reference key: float32 array} of a released checkpoint of `kind`
    whose conversion has the given port shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        ref, v = _RELAYOUT[kind](key, draw(key, tuple(shape), rng))
        out[ref] = np.ascontiguousarray(v)
    if kind == "mae":
        dim = shapes["cls_token"][-1]
        out["head.weight"] = draw("head.weight", (1000, dim), rng)
        out["head.bias"] = np.zeros(1000, np.float32)
    elif kind == "dinov2":
        out["mask_token"] = np.zeros((1, shapes["cls_token"][-1]), np.float32)
    elif kind == "fastsam":
        out["model.model.22.dfl.conv.weight"] = np.arange(
            16, dtype=np.float32).reshape(1, 16, 1, 1)
    return out


def checkpoint(kind: str, sd: dict):
    """The object the released file pickles: MAE, the PEM and FastSAM
    wrap their state dict under "model"; DINOv2 and SAM store it bare."""
    return {"model": sd} if kind in ("mae", "pem", "fastsam") else sd
