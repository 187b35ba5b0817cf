"""Render-and-compare losses (counterpart of
``sdfest_tpu/pipeline/losses.py``): dense point sets with validity masks,
so every reduction has a fixed shape."""
from __future__ import annotations

from typing import Optional

import torch

from sdfest_torch.render.api import (
    _pc_object_points,
    sample_sdf_masked_extrapolating,
)


def pc_loss(
    points: torch.Tensor,
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    sdf: torch.Tensor,
    point_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Metric SDF value ``(M,)`` at observed points; 0 outside the volume
    or the mask.  Differentiable w.r.t. pose (with the quaternion's
    normalization), scale and the SDF."""
    if point_mask is None:
        point_mask = torch.ones(points.shape[0], device=points.device)
    obj, mask = _pc_object_points(position, orientation, 1.0 / scale, points,
                                  point_mask, sdf.shape[-1])
    return sample_sdf_masked_extrapolating(sdf, obj, mask) * scale


def masked_mean_abs(values: torch.Tensor, point_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Mean ``|values|`` over valid points (the pc-loss reduction)."""
    w = (point_mask != 0).to(values.dtype)
    return torch.sum(torch.abs(values) * w) / torch.clamp(torch.sum(w), min=1.0)


def depth_l1_loss(depth_input: torch.Tensor, depth_estimate: torch.Tensor
                  ) -> torch.Tensor:
    """Mean absolute depth error over pixels valid in both images."""
    overlap = (depth_input > 0) & (depth_estimate > 0)
    err = torch.abs(depth_estimate - depth_input)
    w = overlap.to(err.dtype)
    return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)


def inlier_ratio(
    depth_input: torch.Tensor,
    depth_estimate: torch.Tensor,
    relative_threshold: float = 0.03,
) -> torch.Tensor:
    """Share of valid input pixels whose relative depth error is small."""
    valid = depth_input > 0
    rel_err = torch.abs(depth_input - depth_estimate) / torch.where(
        valid, depth_input, torch.ones_like(depth_input)
    )
    inliers = torch.sum((rel_err < relative_threshold) & valid)
    return inliers.to(torch.float32) / torch.clamp(
        torch.sum(valid), min=1
    ).to(torch.float32)
