"""PointNet++ set-abstraction and feature-propagation modules.

Counterpart of `sam6d_tpu/ops/pointnet2_modules.py` (reference
Pose_Estimation_Model/model/pointnet2/pointnet2_modules.py:1-237),
channel-last: SA = FPS centres (K1 on the card, `ops/fps.py`) ->
`query_and_group` -> `SharedMLP` -> max over each neighbourhood; FP =
`three_nn` inverse-distance interpolation -> `SharedMLP`.  The PEM uses
the grouping ops directly; these modules complete the pointnet2
surface.  `params.flax_to_state_dict` carries a JAX module's variables
(`mlp/dense_i/kernel`, `mlp/bn_i/*`) into them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sam6d_tpu_torch.models.pem.matching import SharedMLP
from sam6d_tpu_torch.ops.fps import furthest_point_sample
from sam6d_tpu_torch.ops.pointcloud import (
    gather_points,
    interpolation_weights,
    query_and_group,
    three_interpolate,
    three_nn,
)


class PointnetSAModule(nn.Module):
    """Single-scale set abstraction.

    mlp: the SharedMLP's output widths.  npoint: FPS centres (None groups
    all points into one centre at the origin).  in_channels: the width C
    of the point features the module is called with (0 for none); the
    MLP's input width is C + 3 with features and use_xyz, else C, or 3
    (the coordinates) without features."""

    def __init__(self, mlp: Sequence[int], npoint: int | None = None,
                 radius: float = 0.2, nsample: int = 64, use_xyz: bool = True,
                 in_channels: int = 0, dtype=torch.float32):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.use_xyz = use_xyz
        if in_channels:
            in_dim = in_channels + 3 if use_xyz else in_channels
        else:
            in_dim = 3
        self.mlp = SharedMLP(in_dim, list(mlp), dtype)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor | None = None,
                train: bool = False):
        """xyz (B, N, 3) float32, feats (B, N, C) -> (new_xyz (B, npoint,
        3), new_feats (B, npoint, mlp[-1]))."""
        if self.npoint is not None:
            idx = furthest_point_sample(xyz.contiguous(), self.npoint)
            new_xyz = gather_points(xyz, idx)
            grouped = query_and_group(xyz, new_xyz, feats, self.radius,
                                      self.nsample, use_xyz=self.use_xyz)
        else:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            if feats is not None and self.use_xyz:
                grouped = torch.cat([xyz, feats], dim=-1)
            else:
                grouped = feats if feats is not None else xyz
            grouped = grouped[:, None]
        return new_xyz, self.mlp(grouped, train).amax(dim=2)


class PointnetFPModule(nn.Module):
    """Feature propagation from sparse (known) to dense (unknown) points.

    in_channels: the width of the known points' features plus that of the
    unknown points' own features (0 if they have none)."""

    def __init__(self, mlp: Sequence[int], in_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.mlp = SharedMLP(in_channels, list(mlp), dtype)

    def forward(self, unknown, known, unknown_feats, known_feats,
                train: bool = False):
        """unknown (B, N, 3), known (B, M, 3), unknown_feats (B, N, C1) or
        None, known_feats (B, M, C2) -> (B, N, mlp[-1])."""
        dist, idx = three_nn(unknown, known)
        interp = three_interpolate(known_feats, idx,
                                   interpolation_weights(dist))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp[:, :, None, :], train)[:, :, 0, :]
