"""In-memory triangle mesh with pose-visualization primitives.

Host copy of ``stereo_reconstruction_tpu/recon/simple_mesh.py``, the
equivalent of the reference's ``SimpleMesh``
(``src/Reconstruction/simple_mesh.h:34-359``): vertex/triangle storage,
rigid transform, mesh joining, OFF read/write, and the parametric
sphere / camera-frustum / cylinder primitives used to visualize estimated
extrinsics (``showExtrinsicsReconstruction``,
``src/PoseEstimation/keypoints.cpp:35-50``). Pure NumPy — visualization
is off the metric path, so none of this touches the device.

Primitives are generated parametrically rather than from the reference's
baked-in vertex tables; shapes are equivalent (a unit sphere / frustum /
capped cylinder at the same pose and scale).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from stereo_reconstruction_tpu_torch.io.mesh_io import read_off, write_off

_BLUE = (0, 0, 255, 255)
_RED = (255, 0, 0, 255)


@dataclasses.dataclass
class SimpleMesh:
    positions: np.ndarray   # (N, 3) float64
    colors: np.ndarray      # (N, 4) uint8 RGBA
    triangles: np.ndarray   # (M, 3) int64

    @staticmethod
    def empty() -> "SimpleMesh":
        return SimpleMesh(
            positions=np.zeros((0, 3)),
            colors=np.zeros((0, 4), np.uint8),
            triangles=np.zeros((0, 3), np.int64),
        )

    @property
    def num_vertices(self) -> int:
        return len(self.positions)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def transform(self, transformation: np.ndarray) -> "SimpleMesh":
        """Apply a 4x4 homogeneous transform to every vertex
        (simple_mesh.h:76-81). Returns a new mesh (functional style)."""
        T = np.asarray(transformation, np.float64)
        hom = np.concatenate(
            [self.positions, np.ones((self.num_vertices, 1))], axis=1
        )
        out = hom @ T.T
        w = np.where(np.abs(out[:, 3:4]) > 1e-12, out[:, 3:4], 1.0)
        return dataclasses.replace(self, positions=out[:, :3] / w)

    @staticmethod
    def join(mesh1: "SimpleMesh", mesh2: "SimpleMesh",
             pose1to2: np.ndarray = None) -> "SimpleMesh":
        """Concatenate two meshes, transforming mesh1 by ``pose1to2``
        (simple_mesh.h:186-223 joinMeshes)."""
        if pose1to2 is not None:
            mesh1 = mesh1.transform(pose1to2)
        off = mesh1.num_vertices
        return SimpleMesh(
            positions=np.concatenate([mesh1.positions, mesh2.positions]),
            colors=np.concatenate([mesh1.colors, mesh2.colors]),
            triangles=np.concatenate([mesh1.triangles, mesh2.triangles + off]),
        )

    def write(self, path: str) -> None:
        write_off(path, self.positions, self.colors, self.triangles)

    @staticmethod
    def read(path: str) -> "SimpleMesh":
        verts, cols, faces = read_off(path)
        if cols.size == 0 or cols.ndim < 2 or cols.shape[1] < 4:
            cols = np.tile(np.array([[128, 128, 128, 255]], np.uint8),
                           (len(verts), 1))
        faces = faces if faces.size else np.zeros((0, 3), np.int64)
        return SimpleMesh(
            positions=np.asarray(verts, np.float64),
            colors=np.asarray(cols, np.uint8),
            triangles=np.asarray(faces, np.int64)[:, :3],
        )

    # ---------------- primitives ----------------

    @staticmethod
    def sphere(center, scale: float = 1.0,
               color: Tuple[int, int, int, int] = _BLUE,
               stacks: int = 6, slices: int = 8) -> "SimpleMesh":
        """UV sphere around ``center`` (simple_mesh.h:228-253)."""
        center = np.asarray(center, np.float64).reshape(3)
        th = np.linspace(0.0, np.pi, stacks + 1)
        ph = np.linspace(0.0, 2 * np.pi, slices, endpoint=False)
        T, P = np.meshgrid(th, ph, indexing="ij")
        pts = np.stack(
            [np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)], axis=-1
        ).reshape(-1, 3)
        verts = center[None] + scale * pts
        tris = []
        for i in range(stacks):
            for j in range(slices):
                a = i * slices + j
                b = i * slices + (j + 1) % slices
                c = (i + 1) * slices + j
                d = (i + 1) * slices + (j + 1) % slices
                tris += [[a, b, c], [b, d, c]]
        return SimpleMesh(
            positions=verts,
            colors=np.tile(np.asarray(color, np.uint8), (len(verts), 1)),
            triangles=np.asarray(tris, np.int64),
        )

    @staticmethod
    def camera(camera_pose: np.ndarray, scale: float = 1.0,
               color: Tuple[int, int, int, int] = _RED) -> "SimpleMesh":
        """Camera frustum placed at ``camera_pose`` (world->camera, like
        the reference: vertices are mapped by pose^-1,
        simple_mesh.h:257-281). Apex at the optical center, 4 image-plane
        corners, fully triangulated (sides + base)."""
        pose = np.asarray(camera_pose, np.float64)
        cam_to_world = np.linalg.inv(pose)
        s = float(scale)
        verts_cam = np.array(
            [
                [0.0, 0.0, 0.0],            # optical center
                [-1.0, -0.75, 1.0],         # image-plane corners (z=+1)
                [1.0, -0.75, 1.0],
                [1.0, 0.75, 1.0],
                [-1.0, 0.75, 1.0],
            ]
        ) * s
        hom = np.concatenate([verts_cam, np.ones((5, 1))], axis=1)
        verts = (hom @ cam_to_world.T)[:, :3]
        tris = np.array(
            [[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1], [1, 3, 2], [1, 4, 3]],
            np.int64,
        )
        return SimpleMesh(
            positions=verts,
            colors=np.tile(np.asarray(color, np.uint8), (5, 1)),
            triangles=tris,
        )

    @staticmethod
    def cylinder(p0, p1, radius: float, stacks: int = 2, slices: int = 8,
                 color: Tuple[int, int, int, int] = _BLUE) -> "SimpleMesh":
        """Cylinder from ``p0`` to ``p1`` (simple_mesh.h:285-327): a unit
        z-cylinder rotated so +z faces p1-p0, translated to p0."""
        p0 = np.asarray(p0, np.float64).reshape(3)
        p1 = np.asarray(p1, np.float64).reshape(3)
        axis = p1 - p0
        length = np.linalg.norm(axis)
        ph = np.linspace(0.0, 2 * np.pi, slices, endpoint=False)
        ring = np.stack([np.cos(ph), np.sin(ph), np.zeros_like(ph)], axis=-1)
        verts = []
        for i in range(stacks + 1):
            z = length * i / stacks
            verts.append(radius * ring + np.array([0.0, 0.0, z]))
        verts = np.concatenate(verts)
        tris = []
        for i in range(stacks):
            for j in range(slices):
                a = i * slices + j
                b = i * slices + (j + 1) % slices
                c = (i + 1) * slices + j
                d = (i + 1) * slices + (j + 1) % slices
                tris += [[a, b, c], [b, d, c]]
        R = _face(np.array([0.0, 0.0, 1.0]), axis)
        mesh = SimpleMesh(
            positions=verts @ R.T + p0[None],
            colors=np.tile(np.asarray(color, np.uint8), (len(verts), 1)),
            triangles=np.asarray(tris, np.int64),
        )
        return mesh


def _face(v_from: np.ndarray, v_to: np.ndarray) -> np.ndarray:
    """Rotation taking direction ``v_from`` to ``v_to``
    (simple_mesh.h's ``face`` helper: axis-angle from the cross product)."""
    a = v_from / (np.linalg.norm(v_from) + 1e-30)
    b = v_to / (np.linalg.norm(v_to) + 1e-30)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def show_extrinsics(
    filename: str,
    pose: np.ndarray,                  # (4, 4) right-camera pose
    points_left: np.ndarray,           # (3, N) triangulated points
    points_right: np.ndarray = None,   # unused by the reference too
    point_scale: float = 0.5,
    camera_scale: float = 0.05,
) -> SimpleMesh:
    """Write the extrinsics visualization mesh: one sphere per
    reconstructed point, a red identity-pose camera and a green camera at
    ``pose`` (reference showExtrinsicsReconstruction,
    keypoints.cpp:35-50). Returns the joined mesh."""
    out = SimpleMesh.empty()
    pts = np.asarray(points_left, np.float64)
    for i in range(pts.shape[1]):
        out = SimpleMesh.join(out, SimpleMesh.sphere(pts[:, i], point_scale))
    cam_l = SimpleMesh.camera(np.eye(4), camera_scale)
    cam_r = SimpleMesh.camera(np.asarray(pose, np.float64), camera_scale,
                              color=(0, 255, 0, 255))
    out = SimpleMesh.join(out, SimpleMesh.join(cam_l, cam_r))
    out.write(filename)
    return out
