"""Minimal mesh IO and surface sampling.

A numpy copy of `sam6d_tpu/utils/mesh.py` (the port imports nothing of
the JAX package), which replaces the reference's trimesh dependency
(trimesh.load_mesh + mesh.sample, e.g. run_inference_custom_pytorch.py:
299-300, utils/bop_object_utils.py:17): PLY (ascii and
binary_little_endian) and OBJ triangle meshes, and seeded area-weighted
surface samples.  The same file and seed give the same arrays.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float
    faces: np.ndarray  # (F, 3) int
    vertex_colors: np.ndarray | None = None  # (V, 3) uint8

    @property
    def radius(self) -> float:
        return float(np.linalg.norm(self.vertices, axis=1).max())

    def sample(self, n: int, seed: int | None = None) -> np.ndarray:
        """Area-weighted uniform surface samples, (n, 3)."""
        rng = np.random.default_rng(seed)
        v = self.vertices
        f = self.faces
        a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        probs = areas / areas.sum()
        tri = rng.choice(len(f), size=n, p=probs)
        u = rng.random((n, 1))
        w = rng.random((n, 1))
        flip = (u + w) > 1.0
        u = np.where(flip, 1.0 - u, u)
        w = np.where(flip, 1.0 - w, w)
        return (a[tri] + u * (b[tri] - a[tri]) + w * (c[tri] - a[tri])).astype(
            np.float32
        )


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop_type, prop_name) | list-prop])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append([parts[1], int(parts[2]), []])
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    verts, faces, colors = [], [], []
    if fmt == "ascii":
        tokens = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            for _ in range(count):
                vals = tokens[li].split()
                li += 1
                if name == "vertex":
                    d = {}
                    vi = 0
                    for p in props:
                        d[p[-1]] = float(vals[vi])
                        vi += 1
                    verts.append([d["x"], d["y"], d["z"]])
                    if "red" in d:
                        colors.append([d["red"], d["green"], d["blue"]])
                elif name == "face":
                    n = int(vals[0])
                    faces.append([int(x) for x in vals[1 : 1 + n]])
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                fmt_str = "<" + "".join(
                    _PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar"
                )
                size = struct.calcsize(fmt_str)
                names = [p[2] for p in props if p[0] == "scalar"]
                arr = np.frombuffer(
                    body[off : off + count * size],
                    dtype=np.dtype(
                        [(n_, "<" + _PLY_TYPES[p[1]][0])
                         for n_, p in zip(names, props)]
                    ),
                    count=count,
                )
                off += count * size
                verts = np.stack(
                    [arr["x"], arr["y"], arr["z"]], axis=1
                ).astype(np.float32)
                if "red" in names:
                    colors = np.stack(
                        [arr["red"], arr["green"], arr["blue"]], axis=1
                    )
            elif name == "face":
                for _ in range(count):
                    p = props[0]  # ("list", count_type, index_type, name)
                    cnt_fmt, cnt_size = _PLY_TYPES[p[1]]
                    idx_fmt, idx_size = _PLY_TYPES[p[2]]
                    (n,) = struct.unpack_from("<" + cnt_fmt, body, off)
                    off += cnt_size
                    idxs = struct.unpack_from("<" + idx_fmt * n, body, off)
                    off += idx_size * n
                    faces.append(list(idxs))
    else:
        raise ValueError(f"unsupported ply format {fmt}")

    verts = np.asarray(verts, np.float32)
    # Triangulate polygon faces (fan).
    tris = []
    for face in faces:
        for i in range(1, len(face) - 1):
            tris.append([face[0], face[i], face[i + 1]])
    faces_arr = np.asarray(tris, np.int64) if tris else np.zeros((0, 3), np.int64)
    colors_arr = (
        np.asarray(colors, np.uint8) if len(colors) else None
    )
    return TriMesh(verts, faces_arr, colors_arr)


def load_obj(path: str) -> TriMesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return TriMesh(
        np.asarray(verts, np.float32), np.asarray(faces, np.int64)
    )


def load_mesh(path: str) -> TriMesh:
    if path.lower().endswith(".ply"):
        return load_ply(path)
    if path.lower().endswith(".obj"):
        return load_obj(path)
    raise ValueError(f"unsupported mesh format: {path}")
