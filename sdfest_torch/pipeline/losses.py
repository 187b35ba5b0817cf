"""Render-and-compare losses (counterpart of
``sdfest_tpu/pipeline/losses.py``): dense point sets with validity masks,
so every reduction has a fixed shape.

Hypotheses: each loss reduces over its own trailing dims only, so
estimates with a leading hypothesis dim (depth ``(B, H, W)``, values ``(B,
M)``, poses ``(B, ...)``) against a shared observation give one loss per
hypothesis, ``(B,)``."""
from __future__ import annotations

from typing import Optional

import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.render.api import (
    _pc_object_points,
    sample_sdf_masked_extrapolating,
)


def nn_loss(points_from: torch.Tensor, points_to: torch.Tensor
            ) -> torch.Tensor:
    """Squared distance from each point of ``points_from (N, D)`` to its
    nearest neighbour in ``points_to (M, D)``, ``(N,)``; the expanded
    ``|a|^2 - 2 a.b + |b|^2`` is clamped at 0 (rounding can take it below).
    A library function: both pipelines raise on ``nn_weight != 0``."""
    a = torch.sum(points_from ** 2, dim=1)
    b = points_from @ points_to.T
    c = torch.sum(points_to ** 2, dim=1)
    d = torch.clamp(-2 * b + a[:, None] + c[None, :], min=0.0)
    return torch.min(d, dim=1).values


def pc_loss(
    points: torch.Tensor,
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    sdf: torch.Tensor,
    point_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Metric SDF value ``(M,)`` at observed points ``(M, 3)``; 0 outside
    the volume or the mask.  Differentiable w.r.t. pose (with the
    quaternion's normalization), scale and the SDF.  Hypotheses' poses
    ``(B, ...)`` and grids ``(B, R, R, R)`` give ``(B, M)``."""
    if point_mask is None:
        point_mask = torch.ones(points.shape[0], device=points.device)
    obj, mask = _pc_object_points(position, orientation, 1.0 / scale, points,
                                  point_mask, sdf.shape[-1])
    return sample_sdf_masked_extrapolating(sdf, obj, mask) * scale[..., None]


def masked_mean_abs(values: torch.Tensor, point_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Mean ``|values (..., M)|`` over the valid points of ``point_mask
    (M,)`` (the pc-loss reduction)."""
    w = (point_mask != 0).to(values.dtype)
    return torch.sum(torch.abs(values) * w, dim=-1) / torch.clamp(
        torch.sum(w), min=1.0)


def masked_pc_loss(
    points: torch.Tensor,
    point_mask: torch.Tensor,
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    sdf: torch.Tensor,
) -> torch.Tensor:
    """Mean ``|pc_loss|`` over the valid points ``(M, 3)`` (the pc term of a
    refinement that does not take the fused render op)."""
    values = pc_loss(points, position, orientation, scale, sdf, point_mask)
    return masked_mean_abs(values, point_mask)


def depth_l1_loss(depth_input: torch.Tensor, depth_estimate: torch.Tensor
                  ) -> torch.Tensor:
    """Mean absolute depth error over pixels valid in both images (per
    estimate ``(..., H, W)``)."""
    overlap = (depth_input > 0) & (depth_estimate > 0)
    err = torch.abs(depth_estimate - depth_input)
    w = overlap.to(err.dtype)
    return torch.sum(err * w, dim=(-2, -1)) / torch.clamp(
        torch.sum(w, dim=(-2, -1)), min=1.0)


def point_constraint_loss(
    orientation_q: torch.Tensor, source: torch.Tensor, target: torch.Tensor
) -> torch.Tensor:
    """``|| R(orientation_q) source - target ||_2`` (scalar, or ``(B,)`` of
    quaternions ``(B, 4)``): the distance between the rotated object-frame
    point ``source (3,)`` and ``target (3,)``; the quaternion ``(4,)`` is
    applied as given (not normalized)."""
    rotated = quaternion.apply(orientation_q, source)
    return torch.linalg.norm(rotated - target, dim=-1)


def inlier_ratio(
    depth_input: torch.Tensor,
    depth_estimate: torch.Tensor,
    relative_threshold: float = 0.03,
) -> torch.Tensor:
    """Share of valid input pixels whose relative depth error is small (per
    estimate ``(..., H, W)``)."""
    valid = depth_input > 0
    rel_err = torch.abs(depth_input - depth_estimate) / torch.where(
        valid, depth_input, torch.ones_like(depth_input)
    )
    inliers = torch.sum((rel_err < relative_threshold) & valid, dim=(-2, -1))
    return inliers.to(torch.float32) / torch.clamp(
        torch.sum(valid), min=1
    ).to(torch.float32)
