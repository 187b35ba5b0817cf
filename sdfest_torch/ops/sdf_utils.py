"""Mesh <-> SDF conversion utilities (host-side numpy; counterpart of
``sdfest_tpu/ops/sdf_utils.py``).

:func:`mesh_to_sdf` voxelizes with the port's host C++ library
(:mod:`sdfest_torch.native`); :func:`mesh_from_sdf` and
:func:`sdf_to_pointcloud` are the JAX package's code.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sdfest_torch.ops import marching_cubes as mc
from sdfest_torch.pipeline.synthetic import Mesh


def scale_to_unit_cube(vertices: np.ndarray) -> np.ndarray:
    """Center a mesh's bounding box and scale its longest extent to [-1, 1]."""
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    center = (lo + hi) / 2.0
    half_extent = np.max(hi - lo) / 2.0
    if half_extent <= 0:
        raise ValueError("Degenerate mesh with zero extent.")
    return (vertices - center) / half_extent


def mesh_to_sdf(
    mesh: Mesh, cells_per_dim: int, padding: Optional[int] = 0
) -> Optional[np.ndarray]:
    """Convert a mesh to a discretized signed distance field.

    The mesh is stretched so its longest extent fills the unit cube, leaving
    ``padding`` empty cells on each side (reference semantics,
    vae/sdf_utils.py:17-43).

    Args:
        mesh: The mesh to convert (unposed vertices are used).
        cells_per_dim: Cells per grid axis.
        padding: Number of empty boundary cells.
    Returns:
        (D, D, D) float32 SDF grid, or None if the voxelizer rejects the
        mesh.
    """
    from sdfest_torch.native import api as native_api

    vertices = scale_to_unit_cube(np.asarray(mesh.vertices, dtype=np.float64))
    vertices = vertices * ((cells_per_dim - 2 * padding) / cells_per_dim)
    try:
        return native_api.voxelize_mesh(vertices, mesh.faces, cells_per_dim)
    except ValueError as e:
        print(f"Bad mesh detected ({e}). Skipping.")
        return None


def mesh_from_sdf(
    sdf_volume: np.ndarray,
    level: float = 0.0,
    complete_mesh: bool = False,
) -> Optional[Mesh]:
    """Extract a mesh from an SDF volume (marching tetrahedra).

    Vertices are mapped to the SDF's [-1, 1]^3 object space.

    Args:
        sdf_volume: (D, D, D) grid.
        level: Isosurface level.
        complete_mesh: Pad with positive values first (watertight output).
    Returns:
        The extracted :class:`Mesh` or None when the level is out of range.
    """
    if complete_mesh:
        sdf_volume = np.pad(sdf_volume, pad_width=1, constant_values=1.0)
    spacing = 2.0 / np.asarray(sdf_volume.shape)
    verts, faces = mc.marching_cubes(
        sdf_volume, level=level, spacing=tuple(spacing)
    )
    if verts is None:
        return None
    verts = verts - 1.0
    # rel_scale keeps the extracted geometry at its SDF-space size (the
    # default absolute-scale mode would rescale max extent to 2)
    return Mesh(vertices=verts, faces=faces, scale=1.0, rel_scale=True)


def sdf_to_pointcloud(
    sdf: np.ndarray,
    position: np.ndarray,
    orientation: np.ndarray,
    scale: float,
    threshold: float = 0.05,
    max_points: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Near-surface voxel centers of an SDF, posed into the camera frame.

    Args:
        sdf: (D, D, D) grid.
        position: Object position, shape (3,).
        orientation: Scalar-last quaternion, shape (4,).
        scale: Half-width of the SDF volume.
        threshold: |sdf| threshold selecting near-surface voxels.
        max_points: Optional random subsampling budget.
        rng: PRNG for subsampling.
    Returns:
        Posed points, shape (N, 3).
    """
    from scipy.spatial.transform import Rotation

    res = sdf.shape[0]
    idx = np.argwhere(np.abs(sdf) < threshold)
    points = idx * (2.0 / (res - 1)) - 1.0
    if max_points is not None and len(points) > max_points:
        if rng is None:
            rng = np.random.default_rng()
        points = points[rng.choice(len(points), max_points, replace=False)]
    rot = Rotation.from_quat(np.asarray(orientation, np.float64)).as_matrix()
    return points * scale @ rot.T + np.asarray(position)
