"""Template viewpoint library: icosphere camera and object poses.

A numpy copy of `sam6d_tpu/utils/template_poses.py` (the port imports
nothing of the JAX package).  It replaces the reference's pre-baked pose
blobs (Instance_Segmentation_Model/utils/poses/predefined_poses/*.npy,
generated by create_template_poses.py via Blender) with a deterministic
icosphere generator: subdivided icosahedron vertices -> look-at camera
poses sorted by (elevation, azimuth).  Level 0/1/2 = subdivision 1/2/3 =
42/162/642 views (the reference's template counts).

Conventions (matching reference usage):
  * cam pose: camera-to-world 4x4, camera at vertex * radius looking at
    the origin, OpenCV convention (+z forward, +x right, +y down).
  * obj pose: world-to-camera 4x4 (the object rotation used to score
    proposals, detector.py:215).
"""

from __future__ import annotations

import numpy as np


def _icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    return verts, faces


def icosphere(subdivisions: int):
    """Unit icosphere vertices/faces; 42/162/642 verts at subdiv 1/2/3."""
    verts, faces = _icosahedron()
    for _ in range(subdivisions):
        edge_mid: dict[tuple[int, int], int] = {}
        verts_list = list(verts)
        new_faces = []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts_list[a] + verts_list[b]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def look_at_opencv(cam_location: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-world rotation, OpenCV convention (+z toward target)."""
    forward = target - cam_location
    forward = forward / np.linalg.norm(forward)
    up_world = np.array([0.0, 0.0, -1.0])
    if abs(np.dot(forward, up_world)) > 0.999:
        up_world = np.array([0.0, -1.0, 0.0])
    right = np.cross(up_world, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    R = np.stack([right, down, forward], axis=1)  # columns: x, y, z axes
    return R


def get_camera_poses(level: int, radius: float = 1.0) -> np.ndarray:
    """(N, 4, 4) camera-to-world poses on the level icosphere, sorted by
    (elevation, azimuth) as the reference does
    (create_template_poses.py:48-66)."""
    verts, _ = icosphere(level + 1)
    az = np.arctan2(verts[:, 0], verts[:, 1])
    el = np.arctan2(verts[:, 2], np.linalg.norm(verts[:, :2], axis=1))
    order = np.lexsort((az, el))
    verts = verts[order]

    poses = np.zeros((len(verts), 4, 4), np.float32)
    for i, v in enumerate(verts):
        loc = v * radius
        poses[i, :3, :3] = look_at_opencv(loc, np.zeros(3))
        poses[i, :3, 3] = loc
        poses[i, 3, 3] = 1.0
    return poses


def cam_to_obj_poses(cam_poses: np.ndarray) -> np.ndarray:
    """World-to-camera (object) poses from camera-to-world poses."""
    obj = np.zeros_like(cam_poses)
    R = cam_poses[:, :3, :3]
    t = cam_poses[:, :3, 3]
    Rt = np.swapaxes(R, 1, 2)
    obj[:, :3, :3] = Rt
    obj[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, t)
    obj[:, 3, 3] = 1.0
    return obj


def get_obj_poses_from_template_level(
    level: int,
    pose_distribution: str = "all",
    radius: float = 1.0,
    return_index: bool = False,
):
    """Object poses of the template library
    (reference pose_utils.py:70-100)."""
    cam_poses = get_camera_poses(level, radius)
    obj_poses = cam_to_obj_poses(cam_poses)
    if pose_distribution == "all":
        index = np.arange(len(obj_poses))
    elif pose_distribution == "upper":
        index = np.arange(len(obj_poses))[cam_poses[:, 2, 3] >= 0]
        obj_poses = obj_poses[index]
    else:
        raise ValueError(pose_distribution)
    if return_index:
        return index, obj_poses
    return obj_poses


class NearestTemplateFinder:
    """Map query object poses to nearest template viewpoints
    (reference pose_utils.py:245-296)."""

    def __init__(self, level: int = 2, pose_distribution: str = "all"):
        self.index, self.obj_poses = get_obj_poses_from_template_level(
            level, pose_distribution, return_index=True
        )
        # Viewing direction of each template (third row of R maps world
        # z to camera z).
        self.view_dirs = self.obj_poses[:, 2, :3]

    def find(self, query_R: np.ndarray) -> np.ndarray:
        """query_R: (N, 3, 3) object rotations -> (N,) template indices
        by nearest viewing direction."""
        q_dirs = query_R[:, 2, :3]
        sim = q_dirs @ self.view_dirs.T
        return self.index[np.argmax(sim, axis=1)]
