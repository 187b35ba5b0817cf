"""Numpy wrappers of the host C++ geometry library (counterpart of
``sdfest_tpu/native/api.py``)."""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import Tuple

import numpy as np

from sdfest_torch import native


def available() -> bool:
    """Whether the library can be used: it is built, or a compiler is there
    to build it (then it is built and loaded now; a failed build raises)."""
    if not (os.path.exists(native.library_path()) or os.environ.get("CXX")
            or shutil.which("g++")):
        return False
    native.load()
    return True


def voxelize_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    res: int = 64,
    band_cells: int = 3,
) -> np.ndarray:
    """Voxelize a triangle mesh (already in [-1, 1]^3) into an SDF grid.

    Args:
        vertices: (V, 3) float vertex positions within [-1, 1]^3.
        faces: (F, 3) int vertex indices.
        res: Output resolution per axis.
        band_cells: Half-width of the exact-distance band in cells.
    Returns:
        (res, res, res) float32 signed distance grid (negative inside).
    Raises ``ValueError`` for a mesh the voxelizer rejects, ``RuntimeError``
    when the library does not build.
    """
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"vertices {v.shape} and faces {f.shape} must be "
                         "(N, 3)")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("face indices out of range")
    out = np.empty((res, res, res), dtype=np.float32)
    rc = native.load().voxelize_mesh(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(f), res,
        band_cells, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:  # an empty mesh or a grid below 2 cells
        raise ValueError(f"voxelize_mesh rejected the mesh (code {rc})")
    return out


def marching_tetrahedra(
    grid: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the isosurface of a cubic scalar grid (native kernel).

    Returns (vertices (V, 3) in index space, faces (F, 3)); duplicate
    vertices along shared edges are merged.
    """
    g = np.ascontiguousarray(grid, dtype=np.float32)
    res = g.shape[0]
    if g.shape != (res, res, res):
        raise ValueError(f"grid {g.shape} must be cubic")
    # 6 tets/cell, at most 2 triangles each
    max_tris = (res - 1) ** 3 * 12
    soup = np.empty((max_tris, 9), dtype=np.float32)
    n_tris = native.load().marching_tetrahedra(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), res, level,
        soup.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_tris,
    )
    if n_tris < 0:
        raise RuntimeError("marching_tetrahedra capacity exceeded")
    verts = soup[:n_tris].reshape(-1, 3)
    faces = np.arange(n_tris * 3, dtype=np.int64).reshape(-1, 3)
    # merge duplicate vertices along shared edges
    key = np.round(verts * 1e6).astype(np.int64)
    _, unique_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[unique_idx]
    faces = inverse.reshape(-1)[faces]
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float64), faces[good]
