"""Pose/shape head and backbone composition (counterpart of
``sdfest_tpu/models/pose_net.py``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from sdfest_torch.models.pointnet import (
    BatchNorm,
    GeneralizedIterativePointNet,
    IterativePointNet,
    VanillaPointNet,
)
from sdfest_torch.ops.so3grid import SO3Grid


class SDFPoseHead(nn.Module):
    """MLP mapping a feature vector to (latent, position, scale,
    orientation).  ``"quaternion"`` orientations are L2-normalized (N, 4);
    ``"discretized"`` ones are raw logits over the SO(3) grid cells."""

    def __init__(
        self,
        in_size: int,
        mlp_out_sizes: Sequence[int],
        shape_dimension: int,
        batchnorm: bool,
        orientation_repr: str = "quaternion",
        orientation_grid_resolution: Optional[int] = None,
    ):
        super().__init__()
        self.shape_dimension = shape_dimension
        self.batchnorm = batchnorm
        self.orientation_repr = orientation_repr
        self.num_layers = len(mlp_out_sizes)
        in_features = in_size
        for i, out_size in enumerate(mlp_out_sizes):
            self.add_module(f"linear_{i}", nn.Linear(in_features, out_size))
            if batchnorm:
                self.add_module(f"bn_{i}", BatchNorm(out_size))
            in_features = out_size
        if orientation_repr == "quaternion":
            n_orientation = 4
        elif orientation_repr == "discretized":
            n_orientation = SO3Grid(orientation_grid_resolution).num_cells()
        else:
            raise NotImplementedError(
                f"orientation_repr {orientation_repr} is not supported."
            )
        self.final = nn.Linear(in_features, shape_dimension + 4 + n_orientation)

    def forward(
        self, x: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        out = x
        for i in range(self.num_layers):
            out = getattr(self, f"linear_{i}")(out)
            if self.batchnorm:
                out = getattr(self, f"bn_{i}")(out)
            out = torch.relu(out)
        out = self.final(out)
        d = self.shape_dimension
        orientation = out[:, d + 4:]
        if self.orientation_repr == "quaternion":
            orientation = orientation / torch.sqrt(
                torch.sum(orientation ** 2, dim=1, keepdim=True)
            )
        return out[:, :d], out[:, d:d + 3], out[:, d + 3], orientation


class SDFPoseNet(nn.Module):
    """Backbone + head for single-shot pose and shape estimation."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor):
        return self.head(self.backbone(x))


BACKBONE_TYPES = {
    "VanillaPointNet": VanillaPointNet,
    "IterativePointNet": IterativePointNet,
    "GeneralizedIterativePointNet": GeneralizedIterativePointNet,
}


def create_pose_net(init_config: Dict[str, Any], shape_dimension: int
                    ) -> SDFPoseNet:
    """Build an :class:`SDFPoseNet` from a reference-format init config."""
    backbone = BACKBONE_TYPES[init_config["backbone_type"]](
        **init_config["backbone"])
    head = SDFPoseHead(shape_dimension=shape_dimension, **init_config["head"])
    return SDFPoseNet(backbone, head)
