"""Synthetic data: posed meshes and reference depth rendering (host-side
numpy; counterpart of ``sdfest_tpu/pipeline/synthetic.py``).

Meshes are plain numpy vertex/face arrays (minimal OBJ IO) and
:func:`draw_depth_geometry` is a numpy z-buffer triangle rasterizer, the
JAX package's code term by term, so both packages rasterize the same depth.
The rasterized camera follows the OpenCV convention (camera at the origin
looking along +z), pixel_center 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from sdfest_torch.ops.camera import Camera


class Object:
    """Generic positioned object (position + scalar-last quaternion)."""

    def __init__(self, position=None, orientation=None):
        self.position = np.array([0.0, 0.0, 0.0]) if position is None else position
        self.orientation = (
            np.array([0.0, 0.0, 0.0, 1.0]) if orientation is None else orientation
        )


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ loader (v and f records, triangulating fans)."""
    vertices = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(vertices) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(vertices, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a mesh as Wavefront OBJ."""
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


class Mesh(Object):
    """Posed triangle mesh with original/scaled vertex sets.

    Scale semantics follow the reference: the *absolute* scale is half the
    largest x/y/z extent; updating the scale is always relative to the
    original mesh (idempotent).
    """

    def __init__(
        self,
        vertices: Optional[np.ndarray] = None,
        faces: Optional[np.ndarray] = None,
        path: Optional[str] = None,
        scale: float = 1.0,
        rel_scale: bool = False,
        center: bool = False,
        position=None,
        orientation=None,
    ):
        super().__init__(position=position, orientation=orientation)
        if path is not None:
            if vertices is not None:
                raise ValueError("Only one of vertices/faces or path can be given.")
            vertices, faces = load_obj(path)
        self._original_vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        if center:
            center_point = (
                self._original_vertices.max(axis=0)
                + self._original_vertices.min(axis=0)
            ) / 2.0
            self._original_vertices = self._original_vertices - center_point
        self.update_scale(scale, rel_scale)

    def load_mesh_from_file(
        self, path: str, scale: float = 1.0, rel_scale: bool = False
    ) -> None:
        self._original_vertices, self.faces = load_obj(path)
        self.update_scale(scale, rel_scale)

    def update_scale(self, scale: float = 1.0, rel_scale: bool = False) -> None:
        """Set relative (factor) or absolute (half-max-extent) scale."""
        original_scale = self._get_original_scale()
        if rel_scale:
            factor = scale
            self._scale = original_scale * scale
        else:
            factor = scale / original_scale
            self._scale = scale
        self.vertices = self._original_vertices * factor

    @property
    def scale(self) -> float:
        """Absolute scale (half the largest extent) of the scaled mesh."""
        return self._scale

    def _get_original_scale(self) -> float:
        ranges = self._original_vertices.max(axis=0) - self._original_vertices.min(
            axis=0
        )
        return float(np.max(ranges)) / 2.0

    def get_transformed_vertices(self) -> np.ndarray:
        """Scaled vertices at the current pose."""
        # copy: scipy rejects read-only buffers
        rot = Rotation.from_quat(np.array(self.orientation, np.float64)).as_matrix()
        return self.vertices @ rot.T + np.asarray(self.position)[None, :]

    def sample_points_uniformly(
        self, number_of_points: int, rng: Optional[np.random.Generator] = None
    ) -> np.ndarray:
        """Area-weighted uniform surface sampling of the posed mesh."""
        if rng is None:
            rng = np.random.default_rng(0)
        verts = self.get_transformed_vertices()
        tris = verts[self.faces]  # (F, 3, 3)
        cross = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        areas = 0.5 * np.linalg.norm(cross, axis=-1)
        total = areas.sum()
        if total <= 0:
            raise ValueError("Mesh has zero surface area.")
        chosen = rng.choice(len(areas), size=number_of_points, p=areas / total)
        u = rng.random(number_of_points)
        v = rng.random(number_of_points)
        flip = u + v > 1
        u[flip] = 1 - u[flip]
        v[flip] = 1 - v[flip]
        t = tris[chosen]
        return t[:, 0] + u[:, None] * (t[:, 1] - t[:, 0]) + v[:, None] * (
            t[:, 2] - t[:, 0]
        )


def rasterize_depth(
    vertices: np.ndarray, faces: np.ndarray, camera: Camera
) -> np.ndarray:
    """Z-buffer rasterize triangles to a depth image (OpenCV convention).

    Camera at the origin looking along +z, x right, y down; depth is the
    z-coordinate; pixels without geometry are 0.  Back faces are rendered
    (as the reference enables ``mesh_show_back_face``).
    """
    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.0)
    h, w = camera.height, camera.width
    depth = np.full((h, w), np.inf)

    v = np.asarray(vertices, dtype=np.float64)
    z = v[:, 2]
    valid_v = z > 1e-9
    # project
    px = np.where(valid_v, fx * v[:, 0] / np.where(valid_v, z, 1.0) + cx, 0.0)
    py = np.where(valid_v, fy * v[:, 1] / np.where(valid_v, z, 1.0) + cy, 0.0)

    for face in faces:
        if not valid_v[face].all():
            continue  # skip triangles crossing the camera plane
        xs, ys, zs = px[face], py[face], z[face]
        min_x = max(int(np.floor(xs.min() + 0.5)), 0)
        max_x = min(int(np.ceil(xs.max() - 0.5)), w - 1)
        min_y = max(int(np.floor(ys.min() + 0.5)), 0)
        max_y = min(int(np.ceil(ys.max() - 0.5)), h - 1)
        if min_x > max_x or min_y > max_y:
            continue
        gx, gy = np.meshgrid(
            np.arange(min_x, max_x + 1), np.arange(min_y, max_y + 1)
        )
        # barycentric coordinates
        d = (ys[1] - ys[2]) * (xs[0] - xs[2]) + (xs[2] - xs[1]) * (ys[0] - ys[2])
        if abs(d) < 1e-12:
            continue
        l0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / d
        l1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth interpolation
        inv_z = l0 / zs[0] + l1 / zs[1] + l2 / zs[2]
        with np.errstate(divide="ignore"):
            pixel_z = np.where(inside, 1.0 / inv_z, np.inf)
        sub = depth[min_y : max_y + 1, min_x : max_x + 1]
        np.minimum(sub, pixel_z, out=sub)

    depth[np.isinf(depth)] = 0.0
    return depth


def draw_depth_geometry(obj: Mesh, camera: Camera) -> np.ndarray:
    """Render the depth image of a posed mesh (reference-compatible API)."""
    return rasterize_depth(obj.get_transformed_vertices(), obj.faces, camera)
