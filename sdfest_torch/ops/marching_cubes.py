"""Isosurface extraction from voxel grids (host-side numpy; counterpart of
``sdfest_tpu/ops/marching_cubes.py``).

Marching *tetrahedra*: each cell is split into 6 tetrahedra, which needs no
256-case tables, gives watertight isosurfaces and vectorizes cleanly.  The
code is the JAX package's numpy path, term by term, so both give the same
mesh for the same grid.  :func:`marching_cubes` takes the host C++
library's marching tetrahedra (:mod:`sdfest_torch.native`) where it can be
built, as the JAX package does; :func:`marching_tetrahedra_np` stays the
plain version.

Vertex coordinates match skimage conventions: index-space positions scaled
by ``spacing`` (vertex ``i`` along an axis sits at ``i * spacing``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# cube corner offsets, indexed 0..7 (binary xyz)
_CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int64,
)

# decomposition of a cube into 6 tetrahedra sharing the 0-6 diagonal
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int64,
)

# tetrahedron edges as (vertex, vertex) index pairs
_TET_EDGES = np.array(
    [[0, 1], [1, 2], [2, 0], [0, 3], [1, 3], [2, 3]], dtype=np.int64
)


def _case_triangles():
    """Edge-index triangles for each of the 16 inside/outside sign cases."""
    edge_of = {}
    for e, (a, b) in enumerate(_TET_EDGES):
        edge_of[(a, b)] = e
        edge_of[(b, a)] = e
    cases = [[] for _ in range(16)]
    for case in range(1, 15):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if not case & (1 << v)]
        if len(inside) == 1:
            i = inside[0]
            e = [edge_of[(i, o)] for o in outside]
            cases[case] = [(e[0], e[1], e[2])]
        elif len(inside) == 3:
            o = outside[0]
            e = [edge_of[(o, i)] for i in inside]
            cases[case] = [(e[0], e[2], e[1])]
        elif len(inside) == 2:
            i0, i1 = inside
            o0, o1 = outside
            a = edge_of[(i0, o0)]
            b = edge_of[(i0, o1)]
            c = edge_of[(i1, o1)]
            d = edge_of[(i1, o0)]
            cases[case] = [(a, b, c), (a, c, d)]
    return cases


_CASES = _case_triangles()


def marching_tetrahedra_np(
    grid: np.ndarray, level: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``grid == level`` isosurface (vectorized numpy).

    Args:
        grid: Scalar field, shape (X, Y, Z).
        level: Iso level.
    Returns:
        Tuple of vertices (V, 3) in index space and int faces (F, 3).
        Duplicate vertices along shared edges are merged.
    """
    grid = np.asarray(grid, dtype=np.float64)
    rx, ry, rz = grid.shape
    # cell origins
    ci, cj, ck = np.meshgrid(
        np.arange(rx - 1), np.arange(ry - 1), np.arange(rz - 1), indexing="ij"
    )
    cells = np.stack([ci.ravel(), cj.ravel(), ck.ravel()], axis=-1)  # (C, 3)
    corner_pos = cells[:, None, :] + _CORNERS[None, :, :]  # (C, 8, 3)
    corner_val = grid[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # (C, 8)

    tri_edge_vertex_a = []
    tri_edge_vertex_b = []
    tri_frac = []
    faces_parts = []
    n_emitted = 0
    for tet in _TETS:
        tet_pos = corner_pos[:, tet, :]  # (C, 4, 3)
        tet_val = corner_val[:, tet]  # (C, 4)
        inside = tet_val < level
        case_id = (
            inside[:, 0].astype(np.int64)
            + 2 * inside[:, 1]
            + 4 * inside[:, 2]
            + 8 * inside[:, 3]
        )
        for case in range(1, 15):
            tris = _CASES[case]
            sel = np.nonzero(case_id == case)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                # 3 edge vertices per triangle
                va_list, vb_list, fr_list = [], [], []
                for e in tri:
                    a, b = _TET_EDGES[e]
                    pa = tet_pos[sel, a, :]
                    pb = tet_pos[sel, b, :]
                    fa = tet_val[sel, a]
                    fb = tet_val[sel, b]
                    t = (level - fa) / (fb - fa)
                    va_list.append(pa)
                    vb_list.append(pb)
                    fr_list.append(t)
                tri_edge_vertex_a.append(np.stack(va_list, axis=1))  # (S, 3, 3)
                tri_edge_vertex_b.append(np.stack(vb_list, axis=1))
                tri_frac.append(np.stack(fr_list, axis=1))  # (S, 3)
                faces_parts.append(
                    n_emitted + np.arange(len(sel) * 3).reshape(-1, 3)
                )
                n_emitted += len(sel) * 3

    if not tri_edge_vertex_a:
        return np.zeros((0, 3)), np.zeros((0, 3), dtype=np.int64)

    va = np.concatenate(tri_edge_vertex_a).reshape(-1, 3)
    vb = np.concatenate(tri_edge_vertex_b).reshape(-1, 3)
    fr = np.concatenate(tri_frac).reshape(-1, 1)
    verts = va + fr * (vb - va)
    faces = np.concatenate(faces_parts)

    # merge duplicate vertices (shared edges across tets/cells)
    key = np.round(verts * 1e6).astype(np.int64)
    _, unique_idx, inverse = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    verts = verts[unique_idx]
    faces = inverse[faces]
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[good]


def marching_cubes(
    grid: np.ndarray,
    level: float = 0.0,
    spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Extract an isosurface mesh; skimage-compatible signature subset.

    Args:
        grid: Scalar field (X, Y, Z).
        level: Iso level.
        spacing: Voxel spacing per axis.
    Returns:
        (vertices (V, 3), faces (F, 3)); vertices are index positions scaled
        by ``spacing``.  Returns (None, None) when the level is outside the
        grid's value range.
    """
    grid = np.asarray(grid)
    if not (grid.min() < level < grid.max()):
        return None, None
    from sdfest_torch.native import api as native_api

    if native_api.available():
        verts, faces = native_api.marching_tetrahedra(grid, level)
    else:
        verts, faces = marching_tetrahedra_np(grid, level)
    return verts * np.asarray(spacing)[None, :], faces
