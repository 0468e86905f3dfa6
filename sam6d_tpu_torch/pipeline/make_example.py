"""Generate a self-contained example scene (analog of the reference's
Data/Example: CAD + rgb + depth + camera.json) by rendering a mesh into a
synthetic RGB-D frame with the software rasterizer.

Counterpart of `sam6d_tpu/pipeline/make_example.py`: the same seed gives
the same files' arrays (the port writes them with its own PNG codec; the
depth as a 16-bit PNG in mm).

Usage:
  python -m sam6d_tpu_torch.pipeline.make_example --output_dir D \
      [--cad_path mesh.ply]
If no mesh is given, a coloured cube CAD (60 mm) is written too.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from sam6d_tpu_torch.pipeline.renderer import (
    compute_vertex_normals,
    rasterize_numpy,
)
from sam6d_tpu_torch.provider.training_dataset import random_rotation
from sam6d_tpu_torch.utils.mesh import TriMesh, load_mesh
from sam6d_tpu_torch.utils.png import write_png


def make_cube_mesh(size_mm: float = 60.0) -> TriMesh:
    s = size_mm / 2
    verts = np.array(
        [
            [-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
            [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
            [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
            [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
        ],
        np.int64,
    )
    colors = np.full((8, 3), 180, np.uint8)
    colors[:4, 0] = 255  # red-ish bottom, distinguishes orientation
    return TriMesh(verts, faces, colors)


def write_ply(mesh: TriMesh, path: str):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if mesh.vertex_colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(mesh.faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(mesh.vertices):
            row = f"{v[0]} {v[1]} {v[2]}"
            if mesh.vertex_colors is not None:
                c = mesh.vertex_colors[i]
                row += f" {c[0]} {c[1]} {c[2]}"
            f.write(row + "\n")
        for face in mesh.faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def make_example(
    output_dir: str,
    cad_path: str | None = None,
    image_hw: tuple[int, int] = (480, 640),
    seed: int = 1,
):
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    if cad_path is None:
        mesh = make_cube_mesh()
        cad_path = os.path.join(output_dir, "obj_example.ply")
        write_ply(mesh, cad_path)
    else:
        mesh = load_mesh(cad_path)

    H, W = image_hw
    K = np.array(
        [[572.4, 0.0, W / 2 - 5.0], [0.0, 573.6, H / 2 + 2.0], [0, 0, 1]],
        np.float32,
    )

    # Pose the object ~0.6 m in front of the camera, random rotation.
    R = random_rotation(rng)
    t_mm = np.array([20.0, -15.0, 600.0], np.float32)
    verts_cam = mesh.vertices @ R.T + t_mm

    normals = compute_vertex_normals(mesh)
    shade = np.clip(-(normals @ R.T)[:, 2], 0.15, 1.0)[:, None]
    colors = (
        mesh.vertex_colors.astype(np.float32) / 255.0
        if mesh.vertex_colors is not None
        else np.full((len(mesh.vertices), 3), 0.6, np.float32)
    )
    attrs = np.concatenate([colors * shade, verts_cam], axis=1)
    attr_img, mask, _ = rasterize_numpy(verts_cam, mesh.faces, K, (H, W),
                                        attrs)

    # Background: gradient + noise, flat far plane depth.
    bg = (
        np.linspace(60, 120, W, dtype=np.float32)[None, :, None]
        + rng.rand(H, W, 3).astype(np.float32) * 40.0
    )
    rgb = np.where(mask[..., None], attr_img[..., :3] * 255.0, bg)
    depth = np.where(mask, attr_img[..., 5], 1200.0)  # mm (z of the hit)

    write_png(os.path.join(output_dir, "rgb.png"),
              np.clip(rgb, 0, 255).astype(np.uint8))
    write_png(os.path.join(output_dir, "depth.png"), depth.astype(np.uint16))
    with open(os.path.join(output_dir, "camera.json"), "w") as f:
        json.dump(
            {"cam_K": K.flatten().tolist(), "depth_scale": 1.0}, f
        )
    with open(os.path.join(output_dir, "gt_pose.json"), "w") as f:
        json.dump(
            {"R": R.flatten().tolist(), "t_mm": t_mm.tolist()}, f
        )
    return cad_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Write an example RGB-D scene")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--cad_path", default=None)
    args = p.parse_args(argv)
    cad = make_example(args.output_dir, args.cad_path)
    print(f"example scene in {args.output_dir} (CAD: {cad})")


if __name__ == "__main__":
    main()
