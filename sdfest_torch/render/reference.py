"""Numpy golden-reference sphere-tracing depth renderer (the port's copy of
``sdfest_tpu/render/reference.py``).

An independent, host-side float64 implementation of the renderer's math,
the port's second oracle for the march beside :mod:`sdfest_torch.render.plain`
(numpy only: it shares no code with the kernels or their plain twins):

- OpenGL camera at the origin looking down -z, y up; rays through pixel
  centers at ``(col + 0.5 - cx) / fx``, ``-(row + 0.5 - cy) / fy``, ``-1``
  with intrinsics taken at pixel_center=0.5.
- Oriented-bounding-box slab test (Akenine-Moller) for ray entry/exit.
- Sphere-trace with trilinear SDF interpolation; termination when
  ``distance < threshold * t``; depth is ``-t * d_z`` (positive); miss
  pixels are 0.
- SDF volume spans ``[-1, 1]^3``; ``scale`` is the half-width of the scaled
  volume and the renderer takes the inverse scale.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from sdfest_torch.ops.camera import Camera


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Rotation matrix of a scalar-last unit quaternion."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def pixel_directions(camera: Camera) -> np.ndarray:
    """Normalized ray directions per pixel, shape (H, W, 3)."""
    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.5)
    cols = np.arange(camera.width, dtype=np.float64)
    rows = np.arange(camera.height, dtype=np.float64)
    dx = (cols[None, :] + 0.5 - cx) / fx
    dy = -(rows[:, None] + 0.5 - cy) / fy
    dx, dy = np.broadcast_arrays(dx, dy)
    dz = -np.ones_like(dx)
    d = np.stack([dx, dy, dz], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _obb_intersect(
    dirs: np.ndarray, position: np.ndarray, rot: np.ndarray, scale: float
) -> tuple:
    """Slab test of all rays against the scaled, oriented SDF bounding box.

    Rays originate at the camera origin.  Returns (hit, t_min, t_max).
    """
    t_min = np.full(dirs.shape[:-1], -1e-10)
    t_max = np.full(dirs.shape[:-1], 1e10)
    hit = np.ones(dirs.shape[:-1], dtype=bool)
    for axis in range(3):
        a = rot[:, axis]  # rotated box axis
        e = float(a @ position)
        f = dirs @ a
        parallel = np.abs(f) <= 1e-20
        with np.errstate(divide="ignore", invalid="ignore"):
            t_1 = (e + scale) / f
            t_2 = (e - scale) / f
        lo = np.minimum(t_1, t_2)
        hi = np.maximum(t_1, t_2)
        t_min = np.where(parallel, t_min, np.maximum(t_min, lo))
        t_max = np.where(parallel, t_max, np.minimum(t_max, hi))
        hit &= ~(parallel & (abs(e) > scale))
        hit &= ~((t_min > t_max) | (t_max < 0))
    t_min = np.maximum(t_min, 0.0)
    return hit, t_min, t_max


def trilinear(sdf: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Trilinear interpolation at normalized points (..., 3), extrapolating."""
    res = sdf.shape[0]
    grid_size = 2.0 / (res - 1)
    base = np.clip(np.floor((points + 1.0) * (res - 1) * 0.5), 0, res - 2).astype(
        np.int64
    )
    origin = base * grid_size - 1.0
    f = (points - origin) / grid_size
    i, j, k = base[..., 0], base[..., 1], base[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = sdf[i, j, k] * (1 - fx) + sdf[i + 1, j, k] * fx
    c01 = sdf[i, j, k + 1] * (1 - fx) + sdf[i + 1, j, k + 1] * fx
    c10 = sdf[i, j + 1, k] * (1 - fx) + sdf[i + 1, j + 1, k] * fx
    c11 = sdf[i, j + 1, k + 1] * (1 - fx) + sdf[i + 1, j + 1, k + 1] * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def render_depth_np(
    sdf: np.ndarray,
    position: np.ndarray,
    orientation: np.ndarray,
    inv_scale: float,
    camera: Camera,
    threshold: float = 0.0,
    max_steps: Optional[int] = 500,
) -> np.ndarray:
    """Render a depth image of a posed, scaled, voxelized SDF (numpy).

    Args:
        sdf: Voxel grid, shape (res, res, res), indexed [x, y, z].
        position: SDF origin in the camera frame (OpenGL convention), (3,).
        orientation: Scalar-last unit quaternion of the SDF, (4,).
        inv_scale: Inverse of the SDF half-width.
        camera: Pinhole camera.
        threshold: Relative sphere-trace termination threshold.
        max_steps: Safety cap on marching iterations.
    Returns:
        Depth image (H, W), positive at hits, 0 elsewhere.
    """
    sdf = np.asarray(sdf, dtype=np.float64)
    position = np.asarray(position, dtype=np.float64)
    orientation = np.asarray(orientation, dtype=np.float64)
    scale = 1.0 / inv_scale
    rot = _quat_to_matrix(orientation)

    dirs = pixel_directions(camera)
    hit, t_min, t_max = _obb_intersect(dirs, position, rot, scale)

    # march in object coordinates
    origin_o = rot.T @ (-position)
    dirs_o = dirs @ rot  # == (rot.T @ d) per pixel

    t = t_min.copy()
    depth = np.zeros(dirs.shape[:-1])
    active = hit & (t < t_max)
    steps = 0
    while active.any():
        pts = origin_o + t[..., None] * dirs_o
        dist = trilinear(sdf, pts * inv_scale) * scale
        terminated = active & (dist < threshold * t)
        depth[terminated] = (-t * dirs[..., 2])[terminated]
        active &= ~terminated
        t = np.where(active, t + dist, t)
        active &= t < t_max
        steps += 1
        if max_steps is not None and steps >= max_steps:
            break
    return depth
