"""Software template renderer: z-buffer rasterization of CAD meshes.

Counterpart of `sam6d_tpu/pipeline/renderer.py`, which replaces the
reference's BlenderProc stage (Render/render_custom_templates.py): renders
the 42 level-0 icosphere views of a mesh to the on-disk contract that
`pipeline/pem_data.load_template` and the ISM onboarding read --
rgb_<i>.png, mask_<i>.png and xyz_<i>.npy (object-frame coordinates in
mm, float16; the JAX package's stated deviation from the reference's
NOCS values, render_custom_templates.py:105).

`rasterize` takes the C++ rasterizer (native/src/rasterizer.cpp, built
by the port's own loader `utils/native.py`) when it loads and the numpy
rasterizer otherwise, as the JAX renderer does; the PNGs are written with
the port's own codec.  Lambertian shading with a headlight, vertex
colours if the mesh has them.
"""

from __future__ import annotations

import os

import numpy as np

from sam6d_tpu_torch.utils import native
from sam6d_tpu_torch.utils.mesh import TriMesh, load_mesh
from sam6d_tpu_torch.utils.png import write_png
from sam6d_tpu_torch.utils.template_poses import get_camera_poses


def rasterize(verts_cam: np.ndarray, faces: np.ndarray, K: np.ndarray,
              hw: tuple[int, int], vert_attrs: np.ndarray):
    """Z-buffer rasterization: the native library when it loads, else
    `rasterize_numpy`; the same contract either way (they differ on
    boundary pixels only, tests/test_torch_native.py)."""
    out = native.rasterize(verts_cam, faces, K, hw, vert_attrs)
    if out is not None:
        return out
    return rasterize_numpy(verts_cam, faces, K, hw, vert_attrs)


def rasterize_numpy(
    verts_cam: np.ndarray,
    faces: np.ndarray,
    K: np.ndarray,
    hw: tuple[int, int],
    vert_attrs: np.ndarray,
):
    """Z-buffer rasterization.

    Args:
      verts_cam: (V, 3) camera-frame vertices (z > 0 visible).
      faces: (F, 3) triangle indices.
      K: (3, 3) intrinsics.
      hw: output (H, W).
      vert_attrs: (V, A) per-vertex attributes to interpolate.

    Returns:
      (attr_img (H, W, A), mask (H, W) bool, depth (H, W)).
    """
    H, W = hw
    uv = verts_cam @ K.T
    uv = uv[:, :2] / np.maximum(uv[:, 2:3], 1e-9)  # (V, 2) x,y pixels
    z = verts_cam[:, 2]

    attr_img = np.zeros((H, W, vert_attrs.shape[1]), np.float32)
    depth = np.full((H, W), np.inf, np.float32)
    mask = np.zeros((H, W), bool)

    tri_uv = uv[faces]  # (F, 3, 2)
    tri_z = z[faces]  # (F, 3)
    tri_attr = vert_attrs[faces]  # (F, 3, A)

    # Cull behind-camera triangles.
    ok = (tri_z > 1e-6).all(axis=1)
    tri_uv, tri_z, tri_attr = tri_uv[ok], tri_z[ok], tri_attr[ok]

    x0 = np.clip(np.floor(tri_uv[:, :, 0].min(1)), 0, W - 1).astype(int)
    x1 = np.clip(np.ceil(tri_uv[:, :, 0].max(1)), 0, W - 1).astype(int)
    y0 = np.clip(np.floor(tri_uv[:, :, 1].min(1)), 0, H - 1).astype(int)
    y1 = np.clip(np.ceil(tri_uv[:, :, 1].max(1)), 0, H - 1).astype(int)

    order = np.argsort(-tri_z.mean(1))  # paint far-to-near, z-tested
    for t in order:
        xa, xb, ya, yb = x0[t], x1[t], y0[t], y1[t]
        if xb < xa or yb < ya:
            continue
        a, b, c = tri_uv[t]
        xs = np.arange(xa, xb + 1)
        ys = np.arange(ya, yb + 1)
        gx, gy = np.meshgrid(xs + 0.5, ys + 0.5)
        det = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(det) < 1e-12:
            continue
        w1 = ((gx - a[0]) * (c[1] - a[1]) - (gy - a[1]) * (c[0] - a[0])) / det
        w2 = ((b[0] - a[0]) * (gy - a[1]) - (b[1] - a[1]) * (gx - a[0])) / det
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # Perspective-correct interpolation in 1/z.
        iz = (
            w0 / tri_z[t, 0] + w1 / tri_z[t, 1] + w2 / tri_z[t, 2]
        )
        zpix = 1.0 / np.maximum(iz, 1e-12)
        attr = (
            w0[..., None] * tri_attr[t, 0] / tri_z[t, 0]
            + w1[..., None] * tri_attr[t, 1] / tri_z[t, 1]
            + w2[..., None] * tri_attr[t, 2] / tri_z[t, 2]
        ) * zpix[..., None]

        sub_d = depth[ya : yb + 1, xa : xb + 1]
        upd = inside & (zpix < sub_d)
        sub_d[upd] = zpix[upd]
        depth[ya : yb + 1, xa : xb + 1] = sub_d
        sub_a = attr_img[ya : yb + 1, xa : xb + 1]
        sub_a[upd] = attr[upd]
        attr_img[ya : yb + 1, xa : xb + 1] = sub_a
        mask[ya : yb + 1, xa : xb + 1] |= upd
    return attr_img, mask, depth


def compute_vertex_normals(mesh: TriMesh) -> np.ndarray:
    v, f = mesh.vertices, mesh.faces
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    n = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def render_templates(
    cad_path: str,
    output_dir: str,
    image_size: int = 420,
    level: int = 0,
    base_color: float = 0.6,
    distance_factor: float = 2.8,
):
    """Render all level-`level` icosphere views of a CAD model.

    Writes rgb_<i>.png, mask_<i>.png, xyz_<i>.npy (mm, float16) into
    output_dir/templates.
    """
    mesh = load_mesh(cad_path)
    radius_mm = mesh.radius
    cam_poses = get_camera_poses(level, radius=distance_factor * radius_mm)
    normals = compute_vertex_normals(mesh)
    if mesh.vertex_colors is not None:
        colors = mesh.vertex_colors.astype(np.float32) / 255.0
    else:
        colors = np.full((len(mesh.vertices), 3), base_color, np.float32)

    S = image_size
    f = S  # simple pinhole: ~53 deg FOV
    K = np.array(
        [[f, 0, S / 2], [0, f, S / 2], [0, 0, 1]], np.float32
    )

    out = os.path.join(output_dir, "templates")
    os.makedirs(out, exist_ok=True)
    for i, pose in enumerate(cam_poses):
        R_c2w, t_c2w = pose[:3, :3], pose[:3, 3]
        R_w2c = R_c2w.T
        t_w2c = -R_w2c @ t_c2w
        verts_cam = mesh.vertices @ R_w2c.T + t_w2c
        normals_cam = normals @ R_w2c.T

        # Headlight Lambertian shading.
        shade = np.clip(-normals_cam[:, 2], 0.15, 1.0)[:, None]
        rgb_attr = colors * shade
        attrs = np.concatenate([rgb_attr, mesh.vertices], axis=1)  # (V, 6)

        attr_img, mask, _ = rasterize(verts_cam, mesh.faces, K, (S, S),
                                      attrs)
        rgb = (np.clip(attr_img[..., :3], 0, 1) * 255).astype(np.uint8)
        xyz_mm = attr_img[..., 3:6]

        write_png(os.path.join(out, f"rgb_{i}.png"), rgb)
        write_png(os.path.join(out, f"mask_{i}.png"),
                  (mask * 255).astype(np.uint8))
        np.save(
            os.path.join(out, f"xyz_{i}.npy"), xyz_mm.astype(np.float16)
        )
    return out


def render_bop_templates(
    models_dir: str, template_root: str, image_size: int = 420,
    level: int = 0,
):
    """Render template banks for every BOP object
    (analog of Render/render_bop_templates.py): writes
    template_root/obj_XXXXXX/{rgb,mask,xyz}_i.* for each obj_XXXXXX.ply.
    """
    import glob

    for path in sorted(glob.glob(os.path.join(models_dir, "obj_*.ply"))):
        obj_name = os.path.splitext(os.path.basename(path))[0]
        out_dir = os.path.join(template_root, obj_name)
        tdir = render_templates(path, out_dir, image_size, level)
        # Flatten templates/ into the object dir (provider contract).
        for f in os.listdir(tdir):
            os.replace(os.path.join(tdir, f), os.path.join(out_dir, f))
        os.rmdir(tdir)
        print(f"{obj_name}: templates -> {out_dir}")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Render CAD templates")
    p.add_argument("--cad_path", help="single CAD model")
    p.add_argument("--bop_models_dir", help="render banks for all BOP models")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_size", type=int, default=420)
    p.add_argument("--level", type=int, default=0)
    args = p.parse_args(argv)
    if args.bop_models_dir:
        render_bop_templates(args.bop_models_dir, args.output_dir,
                             args.image_size, args.level)
    else:
        if not args.cad_path:
            p.error("--cad_path or --bop_models_dir required")
        out = render_templates(args.cad_path, args.output_dir,
                               args.image_size, args.level)
        print(f"templates written to {out}")


if __name__ == "__main__":
    main()
