"""PEM configuration dataclasses.

A standalone copy of the PEM part of `sam6d_tpu/config.py` (the port
imports nothing of the JAX package).  Names and defaults are identical,
so a config written for one package describes the same network in the
other.  Reference: Pose_Estimation_Model/config/base.yaml:16-54.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ViTConfig:
    """MAE-style ViT backbone for PEM feature extraction."""

    vit_type: str = "vit_base"
    up_type: str = "linear"
    embed_dim: int = 768
    out_dim: int = 256
    use_pyramid_feat: bool = True
    patch_size: int = 16
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    img_size: int = 224
    dtype: Any = None
    remat: bool = False

    _PRESETS = {
        "vit_small": (384, 12, 6),
        "vit_base": (768, 12, 12),
        "vit_large": (1024, 24, 16),
    }

    def __post_init__(self):
        preset = self._PRESETS.get(self.vit_type)
        dims = (self.embed_dim, self.depth, self.num_heads)
        if preset and preset != dims and dims in self._PRESETS.values():
            import warnings

            warnings.warn(
                f"ViTConfig vit_type={self.vit_type!r} implies "
                f"(embed_dim, depth, num_heads)={preset} but config has "
                f"({self.embed_dim}, {self.depth}, {self.num_heads}); "
                f"the explicit fields win.",
                stacklevel=3,
            )


@dataclass(frozen=True)
class GeoEmbeddingConfig:
    """Geometric structure embedding (GeoTransformer-style).

    `fused`: "auto" runs the fused CUDA kernel whenever the points lie
    on a CUDA device, at any batch size; "on"/"off" force it.  On the
    CPU the fused path computes the kernel's plain PyTorch version.
    """

    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"
    hidden_dim: int = 256
    angle_cheb_terms: int = 28
    fused: str = "auto"
    dist_cheb_terms: int = 40
    dist_cheb_hi: float = 20.0


@dataclass(frozen=True)
class CoarseMatchingConfig:
    nblock: int = 3
    input_dim: int = 256
    hidden_dim: int = 256
    out_dim: int = 256
    temp: float = 0.1
    sim_type: str = "cosine"
    normalize_feat: bool = True
    loss_dis_thres: float = 0.15
    nproposal1: int = 6000
    nproposal2: int = 300
    num_heads: int = 4


@dataclass(frozen=True)
class FineMatchingConfig:
    nblock: int = 3
    input_dim: int = 256
    hidden_dim: int = 256
    out_dim: int = 256
    pe_radius1: float = 0.1
    pe_radius2: float = 0.2
    pe_nsample1: int = 32
    pe_nsample2: int = 64
    focusing_factor: float = 3.0
    temp: float = 0.1
    sim_type: str = "cosine"
    normalize_feat: bool = True
    loss_dis_thres: float = 0.15
    dis_thres: float = 0.15
    num_heads: int = 4


@dataclass(frozen=True)
class PEMConfig:
    coarse_npoint: int = 196
    fine_npoint: int = 2048
    feature_extraction: ViTConfig = field(default_factory=ViTConfig)
    geo_embedding: GeoEmbeddingConfig = field(default_factory=GeoEmbeddingConfig)
    coarse_point_matching: CoarseMatchingConfig = field(
        default_factory=CoarseMatchingConfig
    )
    fine_point_matching: FineMatchingConfig = field(default_factory=FineMatchingConfig)
    n_template_view: int = 42
    n_sample_template_point: int = 5000
    n_sample_model_point: int = 1024
    n_sample_observed_point: int = 2048


def default_pem_config() -> PEMConfig:
    return PEMConfig()

