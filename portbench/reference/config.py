"""PEM and ISM configuration dataclasses.

A standalone copy of the PEM and ISM parts of `sam6d_tpu/config.py` (the
port imports nothing of the JAX package).  Names and defaults are
identical, so a config written for one package describes the same
network in the other.  References: Pose_Estimation_Model/config/
base.yaml:16-54 and Instance_Segmentation_Model/configs/model/.
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


@dataclass(frozen=True)
class OptimConfig:
    """Training optimizer and schedule (reference config/base.yaml:3-14).

    Adam with a warmup-cosine schedule; `grad_clip` clips by the global
    norm (0 disables); `spike_skip_norm` drops the whole update, optimizer
    state included, when the gradient norm is non-finite or not below it
    (0 disables; `skip_nonfinite` then guards non-finite norms alone);
    `accum_steps` averages that many microbatches per update (1 disables).
    """

    lr: float = 1e-4
    betas: tuple = (0.5, 0.999)
    eps: float = 1e-6
    weight_decay: float = 0.0
    max_iters: int = 600_000
    warmup_factor: float = 0.001
    warmup_iters: int = 1000
    grad_clip: float = 1.0
    skip_nonfinite: bool = True
    spike_skip_norm: float = 150.0
    accum_steps: int = 1


@dataclass(frozen=True)
class TrainConfig:
    """Training loop settings (reference config/base.yaml:58-104)."""

    batch_size: int = 28
    training_epoch: int = 15
    iters_to_print: int = 50
    rd_seed: int = 1
    img_size: int = 224
    n_sample_observed_point: int = 2048
    n_sample_model_point: int = 2048
    n_sample_template_point: int = 5000
    optim: OptimConfig = field(default_factory=OptimConfig)



# -- ISM (reference Instance_Segmentation_Model/configs) ---------------------


@dataclass(frozen=True)
class SegmentorConfig:
    """SAM automatic-mask-generation settings.

    Reference: Instance_Segmentation_Model/configs/model/segmentor_model/sam.yaml
    (stability_score_thresh 0.85, iou_threshold 0.88, points_per_batch 64).
    """

    model_type: str = "vit_h"
    points_per_side: int = 32
    points_per_batch: int = 64
    stability_score_thresh: float = 0.85
    pred_iou_thresh: float = 0.88
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    mask_threshold: float = 0.0
    segmentor_width_size: int = 640
    # Post-filter: drop disconnected regions / fill holes smaller than
    # this many pixels (reference sam.yaml min_mask_region_area, 0 = off).
    min_mask_region_area: int = 0
    # Fused decode-tail statistics kernel (ops/decode_tail.py): None = on
    # when the tensors lie on a CUDA device (the JAX package's rule is "on
    # TPU"); True/False force.  The unfused path stays as a second oracle.
    fused_tail: bool | None = None


@dataclass(frozen=True)
class FastSAMConfig:
    """FastSAM (YOLOv8-seg) proposal-generation settings
    (`models/ism/fastsam.py`; `demo --segmentor_model fastsam`).

    Reference: Instance_Segmentation_Model/configs/model/segmentor_model/
    fast_sam.yaml + model/fast_sam.py CustomYOLO overrides.
    """

    scale: str = "x"
    img_size: int = 640
    iou_threshold: float = 0.9
    conf_threshold: float = 0.05
    max_det: int = 200


@dataclass(frozen=True)
class DescriptorConfig:
    """DINOv2 descriptor settings.

    Reference: Instance_Segmentation_Model/configs/model/descriptor_model/dinov2.yaml
    (vitl14, 224x224 crops, chunk 42) and model/dinov2.py.
    """

    model_type: str = "vitl14"
    image_size: int = 224
    patch_size: int = 14
    chunk_size: int = 42
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    validpatch_thresh: float = 0.5


@dataclass(frozen=True)
class ISMConfig:
    """Instance Segmentation Model.

    Reference: Instance_Segmentation_Model/configs/model/ISM_sam.yaml
    (nms_thresh 0.25, confidence_thresh 0.2, aggregation avg_5, chunk 16).
    """

    segmentor: SegmentorConfig = field(default_factory=SegmentorConfig)
    fastsam: FastSAMConfig = field(default_factory=FastSAMConfig)
    descriptor: DescriptorConfig = field(default_factory=DescriptorConfig)
    # Network compute dtype (params stay f32; scoring/geometry stay f32).
    compute_dtype: str = "bfloat16"
    max_proposals: int = 256
    matching_chunk_size: int = 16
    aggregation_function: str = "avg_5"
    confidence_thresh: float = 0.2
    nms_thresh: float = 0.25
    min_box_size: float = 0.05
    min_mask_size: float = 3e-4
    visible_thred: float = 0.5
    pointcloud_sample_num: int = 2048


