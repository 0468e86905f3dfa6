"""Assembled SAM: image encoder, prompt encoder and mask decoder, with the
ResizeLongestSide preprocessing.

Plain copy of `sam6d_tpu_torch/models/ism/sam/model.py` (reference
segment_anything/modeling/sam.py :18, predictor.py SamPredictor :17,
utils/transforms.py ResizeLongestSide :16).  The submodules `encoder`,
`prompt` and `decoder` hold the JAX SAM's three variable trees
(`params.sam_state_dict`).  `preprocess` takes the frame as a uint8
tensor; its resize is PIL's BILINEAR computed in torch
(`bbox.pil_bilinear_resize`).
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.ism.decoder import MaskDecoder
from portbench.reference.ism.encoder import ImageEncoderViT
from portbench.reference.ism.prompt import PromptEncoder
from portbench.reference.ism.bbox import pil_bilinear_resize

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

SAM_VARIANTS = {
    # embed_dim, depth, num_heads, global_attn_indexes
    "vit_b": (768, 12, 12, (2, 5, 8, 11)),
    "vit_l": (1024, 24, 16, (5, 11, 17, 23)),
    "vit_h": (1280, 32, 16, (7, 15, 23, 31)),
}


class SAM(nn.Module):
    def __init__(self, model_type: str = "vit_h", img_size: int = 1024,
                 dtype=torch.float32, encoder_kwargs: dict | None = None,
                 device="cuda"):
        """Built on `device` (the card unless the caller asks for the
        CPU); weights are zero until loaded or drawn
        (`params.init_random_`)."""
        super().__init__()
        embed_dim, depth, num_heads, global_idx = SAM_VARIANTS[model_type]
        kwargs = dict(img_size=img_size, embed_dim=embed_dim, depth=depth,
                      num_heads=num_heads, global_attn_indexes=global_idx,
                      dtype=dtype)
        kwargs.update(encoder_kwargs or {})
        self.encoder = ImageEncoderViT(**kwargs)
        emb = img_size // kwargs.get("patch_size", 16)
        self.prompt = PromptEncoder(256, (emb, emb), (img_size, img_size),
                                    dtype=dtype)
        self.decoder = MaskDecoder(dtype=dtype)
        self.dtype = dtype
        self.input_size = img_size
        self.to(torch.device(device))

    @property
    def device(self) -> torch.device:
        return self.prompt.no_mask_embed.device

    def preprocess(self, image: torch.Tensor):
        """uint8 (H, W, 3) -> normalised, zero-padded (S, S, 3) float32,
        the input-size-per-pixel scale and the resized (h, w)."""
        H, W = image.shape[:2]
        scale = self.input_size / max(H, W)
        eff_h, eff_w = int(round(H * scale)), int(round(W * scale))
        resized = pil_bilinear_resize(image, eff_h, eff_w).float()
        mean = resized.new_tensor(PIXEL_MEAN)
        std = resized.new_tensor(PIXEL_STD)
        padded = resized.new_zeros(self.input_size, self.input_size, 3)
        padded[:eff_h, :eff_w] = (resized - mean) / std
        return padded, scale, (eff_h, eff_w)

    def encode(self, image: torch.Tensor) -> torch.Tensor:
        """(1, S, S, 3) -> (1, h, w, 256)."""
        return self.encoder(image)

    def _prompt_inputs(self, points):
        labels = torch.ones(points.shape[:2], dtype=torch.long,
                            device=points.device)
        sparse = self.prompt.encode_points(points, labels)
        # The image side stays at batch 1 and broadcasts in the decoder.
        return self.prompt.dense_pe(), sparse, self.prompt.no_mask_dense(1)

    def decode_points(self, embedding, points):
        """points (B, 1, 2) in input coordinates -> ((B, 4, 4h, 4w) mask
        logits, (B, 4) predicted IoUs)."""
        pe, sparse, dense = self._prompt_inputs(points)
        return self.decoder(embedding, pe, sparse, dense)

