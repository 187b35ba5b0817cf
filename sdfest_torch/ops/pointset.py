"""Point-set utilities: dense depth lifting, masked normalization and
subsampling (counterpart of ``sdfest_tpu/ops/pointset.py``).

Point sets on the refinement path are dense ``(M, 3)`` tensors with a
validity mask, so every shape is fixed and the loop needs no host
synchronisation.  The dataset loaders use the host-side numpy helpers:
:func:`depth_to_pointcloud` (variable length), :func:`normalize_points` and
the ``change_*_camera_convention`` functions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.camera import Camera


def normalize_points(points: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-mean normalize ``(..., M, D)`` point sets; returns the moved
    points and the centroids ``(..., D)``."""
    centroids = torch.mean(points, dim=-2, keepdim=True)
    return points - centroids, centroids.squeeze(-2)


def normalize_points_masked(
    points: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-mean normalize ``(..., M, D)`` using the rows where ``mask`` is
    nonzero; returns the moved points and the centroids ``(..., D)``."""
    w = mask.to(points.dtype)[..., None]
    denom = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    centroids = torch.sum(points * w, dim=-2, keepdim=True) / denom
    return points - centroids, centroids.squeeze(-2)


def depth_to_pointcloud_dense(
    depth_image: torch.Tensor,
    camera: Camera,
    convention: str = "opengl",
    mask: Optional[torch.Tensor] = None,
    order: str = "raster",
    pixel_offset: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lift an ``(H, W)`` depth image to ``(H*W, 3)`` points and a mask
    (images ``(..., H, W)`` in raster order give ``(..., H*W, 3)``).

    ``order="tile"`` permutes the rows into 16x16-pixel tile-major order
    when both dims allow it (the order the JAX package's pc loss uses; the
    reductions over it are order-invariant), and keeps raster order
    otherwise.  Invalid rows hold the lift of zero depth (all zeros).

    ``pixel_offset``: an integer ``(2,)`` ``[row, col]`` tensor on the
    image's device (never read on the host) when the image is an ROI crop
    starting at that pixel of ``camera``'s frame; the crop's lift is then
    exactly the matching rows of the full lift.
    """
    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.0)
    h, w = depth_image.shape[-2:]
    lead = depth_image.shape[:-2]
    dev = depth_image.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    if pixel_offset is not None:
        rows = rows + pixel_offset[0].to(torch.float32)
        cols = cols + pixel_offset[1].to(torch.float32)
    rows, cols = rows.expand(h, w), cols.expand(h, w)
    z = depth_image.to(torch.float32)
    if convention == "opengl":
        x = (cols - cx) * z / fx
        y = -(rows - cy) * z / fy
        z_out = -z
    elif convention == "opencv":
        x = (cols - cx) * z / fx
        y = (rows - cy) * z / fy
        z_out = z
    else:
        raise ValueError(f"Unsupported camera convention {convention}.")
    valid = depth_image != 0
    if mask is not None:
        valid = torch.logical_and(valid, mask != 0)
    points = torch.stack([x, y, z_out], dim=-1)
    if order == "tile":
        from sdfest_torch.render.kernels import TILE, tile_image

        if lead:
            raise ValueError("tile order lifts one (H, W) image")
        if h % TILE == 0 and w % TILE == 0:
            return (
                tile_image(points, h, w),
                tile_image(valid[..., None], h, w).reshape(h * w),
            )
    elif order != "raster":
        raise ValueError(f"Unsupported point order {order}.")
    return points.reshape(*lead, h * w, 3), valid.reshape(*lead, h * w)


def _uniform(num_points: int, generator: Optional[torch.Generator],
             device: torch.device) -> torch.Tensor:
    """The uniforms in ``[0, 1)`` that :func:`subsample_masked` draws.

    The one place the port's randomness enters the init; parity tests
    replace it to feed the JAX package's ``jax.random.uniform`` draws.
    """
    return torch.rand(num_points, generator=generator, device=device)


def subsample_masked(
    points: torch.Tensor,
    mask: torch.Tensor,
    num_points: int,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick ``num_points`` valid rows uniformly, with replacement.

    Inverse-CDF sampling over the mask's running count, as the JAX package
    does: no boolean indexing, so no host synchronisation.  Returns the
    sampled points ``(num_points, 3)`` and whether any valid row existed
    (a 0-d bool tensor).
    """
    return subsample_with_uniforms(
        points, mask, _uniform(num_points, generator, points.device))


def subsample_with_uniforms(
    points: torch.Tensor, mask: torch.Tensor, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse-CDF pick of :func:`subsample_masked` for the uniforms
    ``u``, shape ``(..., P)`` for points ``(..., M, 3)`` and a mask
    ``(..., M)``: rows ``(..., P, 3)`` and whether any row was valid
    ``(...)``."""
    m = points.shape[-2]
    cnt = torch.cumsum(mask.to(torch.int64), dim=-1)
    n_valid = cnt[..., -1:]
    ranks = torch.floor(u * n_valid).to(torch.int64) + 1
    idx = torch.clamp(torch.searchsorted(cnt, ranks, side="left"), 0, m - 1)
    rows = torch.gather(points, -2, idx[..., None].expand(
        *idx.shape, points.shape[-1]))
    return rows, n_valid[..., 0] > 0


def depth_to_pointcloud(
    depth_image: np.ndarray,
    camera: Camera,
    normalize: bool = False,
    mask: Optional[np.ndarray] = None,
    convention: str = "opengl",
) -> np.ndarray:
    """Host-side variable-length depth lifting (numpy): the valid points of
    :func:`depth_to_pointcloud_dense`, shape ``(N, 3)`` in raster order,
    optionally zero-mean.  For dataset preprocessing."""
    depth_image = np.asarray(depth_image)
    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.0)
    masked = depth_image if mask is None else depth_image * np.asarray(mask)
    rows, cols = np.nonzero(masked)
    z = depth_image[rows, cols].astype(np.float32)
    if convention == "opengl":
        points = np.stack(
            [(cols - cx) * z / fx, -(rows - cy) * z / fy, -z], axis=-1
        )
    elif convention == "opencv":
        points = np.stack(
            [(cols - cx) * z / fx, (rows - cy) * z / fy, z], axis=-1
        )
    else:
        raise ValueError(f"Unsupported camera convention {convention}.")
    if normalize:
        points = points - points.mean(axis=0, keepdims=True)
    return points


def change_transform_camera_convention(
    in_transform: torch.Tensor, in_convention: str, out_convention: str
) -> torch.Tensor:
    """Change the camera convention of frame-A -> camera ``(..., 4, 4)``
    transforms."""
    _check_conventions(in_convention, out_convention)
    if in_convention == out_convention:
        return in_transform
    gl2cv = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0],
                                    dtype=in_transform.dtype,
                                    device=in_transform.device))
    return gl2cv @ in_transform


def change_position_camera_convention(
    in_position: torch.Tensor, in_convention: str, out_convention: str
) -> torch.Tensor:
    """Change the camera convention of positions, shape ``(..., 3)``."""
    _check_conventions(in_convention, out_convention)
    if in_convention == out_convention:
        return in_position
    return in_position * torch.tensor([1.0, -1.0, -1.0],
                                      dtype=in_position.dtype,
                                      device=in_position.device)


def change_orientation_camera_convention(
    in_orientation_q: torch.Tensor, in_convention: str, out_convention: str
) -> torch.Tensor:
    """Change the camera convention of orientations (quaternions
    ``(..., 4)``, scalar last)."""
    _check_conventions(in_convention, out_convention)
    if in_convention == out_convention:
        return in_orientation_q
    gl2cv_q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=in_orientation_q.dtype,
                           device=in_orientation_q.device)
    return quaternion.multiply(gl2cv_q, in_orientation_q)


def _check_conventions(*conventions: str) -> None:
    for convention in conventions:
        if convention not in ("opengl", "opencv"):
            raise ValueError(f"Camera convention {convention} not supported.")
