"""Device meshes over the ranks of the process group.

Counterpart of `sam6d_tpu/parallel/mesh.py`: a `DeviceMesh`
(`torch.distributed.device_mesh.init_device_mesh`) with named axes, one
rank a device.  `torch.distributed` must be initialised first
(`parallel.distributed.init_distributed`).  The axes the port lays work
over have the names below: `DP` splits frames, instance batches and the
training batch, `TP` the ViT and transformer layers, `HYP` the coarse
solve's hypotheses.
"""

from __future__ import annotations

import math

import torch.distributed as dist

DP, TP, HYP = "dp", "tp", "hyp"


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = (DP, TP),
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` over every rank, axes `axis_names`; None
    puts every rank on the first axis.  device_type "cuda" (NCCL) or
    "cpu" (gloo).  A shape whose product is not the world size raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.distributed.init_distributed)")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def has_axis(mesh, name: str) -> bool:
    return mesh is not None and name in (mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """Ranks along `name` (1 when the mesh has no such axis)."""
    if not has_axis(mesh, name):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along `name` (0 without the axis)."""
    if not has_axis(mesh, name):
        return 0
    return mesh.get_local_rank(mesh.mesh_dim_names.index(name))


def axis_group(mesh, name: str):
    return mesh.get_group(mesh.mesh_dim_names.index(name))
