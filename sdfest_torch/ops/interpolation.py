"""Trilinear interpolation on voxel grids (counterpart of
``sdfest_tpu/ops/interpolation.py``).

- The SDF volume spans ``[-1, 1]^3`` in normalized object space and is
  indexed ``sdf[x, y, z]``.
- Base cell per axis: ``floor((p + 1) * (res - 1) / 2)`` clamped to
  ``[0, res - 2]``; the fraction is taken against the clamped cell, so it
  leaves ``[0, 1]`` outside the volume (constant-slope extrapolation), and
  ``inside`` is computed from the unclamped cell.

These gathers are the plain versions the CUDA samplers are held against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sdfest_torch.utils.device import device_cache


@device_cache(maxsize=8)
def _divisor(value: float, device: torch.device, dtype: torch.dtype
             ) -> torch.Tensor:
    """``value`` as a tensor on ``device``, made once.  PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, one
    rounding off the true quotient that the CUDA kernels (and PyTorch on
    the CPU) compute; a tensor divisor keeps the true division."""
    return torch.tensor(value, dtype=dtype, device=device)


def _base_and_frac(
    points: torch.Tensor, res: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Clamped base cells (int64), cell-local fractions and inside-mask."""
    grid_size = 2.0 / (res - 1)
    c_unclamped = torch.floor((points + 1.0) * (res - 1) * 0.5)
    inside = torch.logical_and(
        torch.amin(c_unclamped, dim=-1) >= 0,
        torch.amax(c_unclamped, dim=-1) <= res - 2,
    )
    base = torch.clamp(c_unclamped, 0, res - 2)
    cell_origin = base * grid_size - 1.0
    frac = (points - cell_origin) / _divisor(grid_size, points.device,
                                              points.dtype)
    return base.long(), frac, inside


def _corner_offsets(res: int, device) -> torch.Tensor:
    """Flat offsets of the 8 cell corners, shape (2, 2, 2) ``[dx, dy, dz]``."""
    return torch.tensor(
        [
            [[0, 1], [res, res + 1]],
            [[res * res, res * res + 1], [res * res + res, res * res + res + 1]],
        ],
        dtype=torch.long,
        device=device,
    )


def _flat_base(base: torch.Tensor, res: int) -> torch.Tensor:
    return (base[..., 0] * res + base[..., 1]) * res + base[..., 2]


def _gather_corners(sdf: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Corner values ``(..., 2, 2, 2)`` indexed ``[dx, dy, dz]``."""
    res = sdf.shape[-1]
    idx = _flat_base(base, res)[..., None, None, None] + _corner_offsets(
        res, sdf.device
    )
    return sdf.reshape(-1)[idx]


def _lerp_corners(corners: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c0 = corners[..., 0, :, :] * (1 - fx)[..., None, None] + corners[
        ..., 1, :, :
    ] * fx[..., None, None]
    c00 = c0[..., 0, :] * (1 - fy)[..., None] + c0[..., 1, :] * fy[..., None]
    return c00[..., 0] * (1 - fz) + c00[..., 1] * fz


def sample_sdf(sdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinear samples ``(...,)`` at points ``(..., 3)``, extrapolating."""
    base, frac, _ = _base_and_frac(points, sdf.shape[-1])
    return _lerp_corners(_gather_corners(sdf, base), frac)


def sample_sdf_masked(
    sdf: torch.Tensor, points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear samples that are 0 outside the volume, and the inside mask."""
    base, frac, inside = _base_and_frac(points, sdf.shape[-1])
    values = _lerp_corners(_gather_corners(sdf, base), frac)
    return torch.where(inside, values, torch.zeros_like(values)), inside


def sample_sdf_value_and_grad(
    sdf: torch.Tensor, points: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear value ``(N,)`` and its gradient ``(N, 3)`` w.r.t. the
    normalized point, in closed form (piecewise-constant base cell,
    constant-slope fraction, as autodiff of :func:`sample_sdf` gives)."""
    res = sdf.shape[-1]
    base, frac, _ = _base_and_frac(points, res)
    c = _gather_corners(sdf, base)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1 - fx, fx], dim=-1)
    wy = torch.stack([1 - fy, fy], dim=-1)
    wz = torch.stack([1 - fz, fz], dim=-1)
    c0 = (c * wx[..., :, None, None]).sum(-3)  # (..., dy, dz)
    c00 = (c0 * wy[..., :, None]).sum(-2)  # (..., dz)
    value = (c00 * wz).sum(-1)
    inv_cell = (res - 1) * 0.5
    dx = ((c[..., 1, :, :] - c[..., 0, :, :]) * wy[..., :, None]
          * wz[..., None, :]).sum((-2, -1))
    dy = ((c0[..., 1, :] - c0[..., 0, :]) * wz).sum(-1)
    dz = c00[..., 1] - c00[..., 0]
    return value, torch.stack([dx, dy, dz], dim=-1) * inv_cell


def trilinear_weights(
    points: torch.Tensor, res: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat corner indices ``(N, 8)`` and weights ``(N, 8)`` of each point,
    corners ordered ``dx*4 + dy*2 + dz`` (the transpose of sampling)."""
    base, frac, _ = _base_and_frac(points, res)
    idx = _flat_base(base, res)[:, None] + _corner_offsets(
        res, points.device
    ).reshape(1, 8)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    wx = torch.cat([1 - fx, fx], dim=1)
    wy = torch.cat([1 - fy, fy], dim=1)
    wz = torch.cat([1 - fz, fz], dim=1)
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return idx, w.reshape(-1, 8)


def resize_trilinear(volume: torch.Tensor, out_size: int) -> torch.Tensor:
    """Upsample ``(N, C, D, D, D)`` volumes with half-pixel trilinear
    sampling, equal to ``jax.image.resize(..., "trilinear")`` of the JAX
    package when ``out_size >= D`` (when shrinking, jax antialiases and
    this does not).

    Its backward is :func:`_resize_adjoint`, a fixed-order product:
    PyTorch's CUDA backward adds with float atomics in no fixed order, so
    two runs of a gradient through the decoder (the trainers' steps, the
    estimate's shape optimization) would part in the last bits."""
    if out_size < volume.shape[-1]:
        raise ValueError("resize_trilinear only upsamples")
    return _Resize.apply(volume, out_size)


def _resize_matrix_np(n: int, m: int, dtype) -> np.ndarray:
    """The ``(m, n)`` matrix of a half-pixel linear resize ``n -> m`` along
    one axis: PyTorch's source index in ``dtype``, clamped at 0, and its two
    taps (the last row's two taps on the same entry)."""
    one, half = dtype(1), dtype(0.5)
    scale = dtype(n) / dtype(m)
    src = scale * (np.arange(m).astype(dtype) + half) - half
    src = np.where(src < 0, dtype(0), src).astype(dtype)
    i0 = src.astype(np.int64)
    l1 = (src - i0.astype(dtype)).astype(dtype)
    mat = np.zeros((m, n), dtype)
    rows = np.arange(m)
    np.add.at(mat, (rows, i0), one - l1)
    np.add.at(mat, (rows, np.minimum(i0 + 1, n - 1)), l1)
    return mat


@device_cache(maxsize=32)
def _resize_matrix(n: int, m: int, device: torch.device, dtype: torch.dtype
                   ) -> torch.Tensor:
    """:func:`_resize_matrix_np` on ``device``, made once (a captured step
    reads it in place)."""
    return torch.from_numpy(_resize_matrix_np(
        n, m, np.float64 if dtype == torch.float64 else np.float32)
    ).to(device)


def _resize_adjoint(grad: torch.Tensor, n: int) -> torch.Tensor:
    """The gradient of ``(N, C, n, n, n)`` volumes from the gradient
    ``(N, C, m, m, m)`` of their trilinear resize: per axis one product with
    the transpose of the resize's ``(m, n)`` matrix (:func:`torch.mm`, full
    precision and a fixed order in float32 and float64; no atomics).  Each
    product contracts the last axis and writes its result first, so the
    three run on the volume as it lies, and one copy restores the layout:
    four launches."""
    lead, m = grad.shape[:2], grad.shape[-1]
    mat_t = _resize_matrix(n, m, grad.device, grad.dtype).t()
    out = grad
    for _ in range(3):  # z, then y, then x: (N C X Y z) -> (n_z, N C X Y)
        out = torch.mm(mat_t, out.reshape(-1, m).t())
    # (n_x, n_y, n_z, N C) -> (N, C, n_x, n_y, n_z)
    return out.reshape(n, n, n, -1).permute(3, 0, 1, 2).reshape(
        *lead, n, n, n)


class _Resize(torch.autograd.Function):
    """``F.interpolate`` (trilinear, half-pixel) forward; its fixed-order
    adjoint backward."""

    @staticmethod
    def forward(ctx, volume, out_size):
        ctx.in_size = volume.shape[-1]
        return F.interpolate(volume, size=(out_size,) * 3, mode="trilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, grad):
        return _resize_adjoint(grad.contiguous(), ctx.in_size), None
