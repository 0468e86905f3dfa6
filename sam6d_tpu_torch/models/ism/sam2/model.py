"""Assembled SAM 2 for single images: Hiera image encoder and FPN neck,
SAM's prompt encoder, SAM 2's mask decoder, SAM2Transforms'
preprocessing.

Port of the image path of sam2/modeling/sam2_base.py (forward_image
:236, the high-resolution features through `conv_s0` / `conv_s1`),
sam2_image_predictor.py (set_image :88: `no_mem_embed` added to the
lowest-resolution level; _predict :334) and utils/transforms.py
(SAM2Transforms: a square resize, no padding).  The video path (memory
encoder, memory attention, object pointers) is not ported.

`SamAutomaticMaskGenerator` (`models/ism/sam/amg.py`) drives this model
as it drives SAM (`sam/model.py`): `preprocess`, `encode`,
`decode_points`, `decode_points_pre`, `decode_tail`,
`decoder_tail_params`.  `encode` returns `SAM2Features`: the image
embedding with the two high-resolution maps, which the decoder's tail
adds (also in the layout of its key rows, as K6 and `MaskDecoder.tail`
read them).  `square_resize` tells the generator that the frame is
stretched to the square input (per-axis scales), and that masks go from
the logit grid straight to the frame, as SAM2Transforms.postprocess_masks
resizes them.  Sizes by variant in `SAM2_VARIANTS`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from sam6d_tpu_torch.device import resolve_device
from sam6d_tpu_torch.models.ism.sam.decoder import MaskDecoder
from sam6d_tpu_torch.models.ism.sam.prompt import PromptEncoder
from sam6d_tpu_torch.models.ism.sam2.hiera import FpnNeck, Hiera, ImageEncoder
from sam6d_tpu_torch.utils.timer import stage

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

SAM2_VARIANTS = {
    # sam2/configs/sam2.1/sam2.1_hiera_l.yaml (the trunk's other sizes
    # are Hiera's defaults: q_pool 3, q_stride 2, dim_mul = head_mul = 2)
    "sam2.1_hiera_l": dict(
        embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
        global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8),
        window_pos_embed_bkg_spatial_size=(7, 7)),
}
D_MODEL = 256  # the neck's width and the decoder's
FPN_TOP_DOWN_LEVELS = (2, 3)


class SAM2Features(NamedTuple):
    """One image's encoding: the embedding (1, h, w, 256), feat_s1 (1, 2h,
    2w, 64), feat_s0 (1, 4h, 4w, 32), and the two in the layout of the
    decoder's key rows: res1 (h w, 4 * 64) nesting (a, d, c), res0 (h w,
    4, 4 * 32) nesting (a, d), (e, f, c), for pixel (2y + a, 2x + d) of
    feat_s1 and (4y + 2a + e, 4x + 2d + f) of feat_s0."""

    embedding: torch.Tensor
    feat_s1: torch.Tensor
    feat_s0: torch.Tensor
    res1: torch.Tensor
    res0: torch.Tensor


def key_row_layout(feat_s1: torch.Tensor, feat_s0: torch.Tensor):
    """(res1, res0) of `SAM2Features` from the two maps (batch 1)."""
    _, H1, W1, c4 = feat_s1.shape
    h, w = H1 // 2, W1 // 2
    c8 = feat_s0.shape[-1]
    res1 = feat_s1.reshape(h, 2, w, 2, c4).permute(0, 2, 1, 3, 4)
    res0 = feat_s0.reshape(h, 2, 2, w, 2, 2, c8).permute(0, 3, 1, 4, 2, 5, 6)
    return (res1.reshape(h * w, 4 * c4),
            res0.reshape(h * w, 4, 4 * c8))


class SAM2(nn.Module):
    square_resize = True

    def __init__(self, model_type: str = "sam2.1_hiera_l",
                 img_size: int = 1024, dtype=torch.float32,
                 trunk_kwargs: dict | None = None, device="cuda"):
        """Built on `device` (the card unless the caller asks for the
        CPU); weights are zero until loaded or drawn
        (`params.init_random_`).  trunk_kwargs override the variant's
        Hiera sizes (the tests' tiny trunks)."""
        super().__init__()
        sizes = dict(SAM2_VARIANTS[model_type])
        sizes.update(trunk_kwargs or {})
        trunk = Hiera(**sizes, dtype=dtype)
        self.image_encoder = ImageEncoder(
            trunk, FpnNeck(D_MODEL, trunk.channel_list, FPN_TOP_DOWN_LEVELS,
                           dtype), scalp=1)
        emb = img_size // 16
        self.sam_prompt_encoder = PromptEncoder(
            D_MODEL, (emb, emb), (img_size, img_size), dtype=dtype)
        self.sam_mask_decoder = MaskDecoder(
            D_MODEL, dtype=dtype, pred_obj_scores=True, iou_sigmoid=True,
            high_res=True)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, D_MODEL))
        self.dtype = dtype
        self.input_size = img_size
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.no_mem_embed.device

    def preprocess(self, image: torch.Tensor):
        """uint8 (H, W, 3) -> the normalised (S, S, 3) float32 input (a
        bilinear resize of the 0-1 image to S x S, then ImageNet's mean
        and std), the per-axis scales (S / W, S / H) and (S, S)."""
        H, W = image.shape[:2]
        S = self.input_size
        x = image.permute(2, 0, 1)[None].float() / 255.0
        x = F.interpolate(x, size=(S, S), mode="bilinear",
                          align_corners=False, antialias=True)[0]
        x = x.permute(1, 2, 0)
        x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
        return x, (S / W, S / H), (S, S)

    def encode(self, image: torch.Tensor) -> SAM2Features:
        """(1, S, S, 3) -> the image's `SAM2Features`."""
        enc = self.image_encoder
        feats = enc.trunk(image)
        with stage(None, "sam2.neck"):
            s0, s1, top = enc.levels(feats)
            dec = self.sam_mask_decoder
            feat_s0, feat_s1 = dec.conv_s0(s0), dec.conv_s1(s1)
            embedding = top + self.no_mem_embed.to(top.dtype)
            res1, res0 = key_row_layout(feat_s1, feat_s0)
        return SAM2Features(embedding, feat_s1, feat_s0, res1, res0)

    def _prompt_inputs(self, points):
        pr = self.sam_prompt_encoder
        labels = torch.ones(points.shape[:2], dtype=torch.long,
                            device=points.device)
        return pr.dense_pe(), pr.encode_points(points, labels), \
            pr.no_mask_dense(1)

    def decode_points(self, features: SAM2Features, points):
        """points (B, 1, 2) in input coordinates -> ((B, 4, 4h, 4w) mask
        logits, (B, 4) predicted IoUs)."""
        pe, sparse, dense = self._prompt_inputs(points)
        h, w = features.embedding.shape[1:3]
        keys, hyper, iou = self.sam_mask_decoder.transformer_forward(
            features.embedding, pe, sparse, dense)
        return self.decode_tail(keys, hyper, h, w, features), iou

    def decode_points_pre(self, features: SAM2Features, points):
        """Transformer-only decode for the fused AMG tail: points
        (B, 1, 2) -> keys (B, N, 256), hyper (B, 4, 32), iou (B, 4)."""
        pe, sparse, dense = self._prompt_inputs(points)
        return self.sam_mask_decoder.transformer_forward(
            features.embedding, pe, sparse, dense)

    def decode_tail(self, keys, hyper, h: int, w: int,
                    features: SAM2Features):
        """Mask logits of a candidate set with the image's high-resolution
        features: keys (K, N, 256), hyper (K, T, 32) -> (K, T, 4h, 4w)."""
        return self.sam_mask_decoder.tail(
            keys, hyper, h, w, (features.res1, features.res0))

    def decoder_tail_params(self, features: SAM2Features) -> dict:
        """K6's weights (`MaskDecoder.tail_kernel_params`) and the image's
        residuals res1 (N, 256), res0 (N, 512) in the compute dtype (the
        keys' of the fused route)."""
        res1, res0 = features.res1, features.res0
        return dict(self.sam_mask_decoder.tail_kernel_params(),
                    res1=res1.to(self.dtype).contiguous(),
                    res0=res0.to(self.dtype).reshape(
                        res0.shape[0], -1).contiguous())
