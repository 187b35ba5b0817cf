"""PointNet backbone (counterpart of ``VanillaPointNet`` in
``sdfest_tpu/models/pointnet.py``; the iterative variants are not ported
yet).

The per-point MLP runs on the flattened ``(N*M, C)`` view, so BatchNorm
normalizes over all points of all sets, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class VanillaPointNet(nn.Module):
    """Per-point MLP + max-pool; optional batchnorm, dense global-feature
    concatenation between layers and residual adds where shapes match.
    Input ``(N, M, C)``, output ``(N, features)``."""

    def __init__(
        self,
        in_size: int,
        mlp_out_sizes: Sequence[int],
        batchnorm: bool,
        residual: bool = False,
        dense: bool = False,
    ):
        super().__init__()
        self.batchnorm = batchnorm
        self.residual = residual
        self.dense = dense
        self.num_layers = len(mlp_out_sizes)
        in_features = in_size
        for i, out_size in enumerate(mlp_out_sizes):
            self.add_module(f"linear_{i}", nn.Linear(in_features, out_size))
            if batchnorm:
                self.add_module(
                    f"bn_{i}", nn.BatchNorm1d(out_size, eps=1e-5, momentum=0.1)
                )
            in_features = 2 * out_size if dense else out_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, _ = x.shape
        out = prev_out = x.reshape(n * m, -1)
        for i in range(self.num_layers):
            out = getattr(self, f"linear_{i}")(out)
            if self.batchnorm:
                out = getattr(self, f"bn_{i}")(out)
            out = torch.relu(out)
            if self.dense:
                out_max = torch.amax(out.reshape(n, m, -1), dim=1)
                if i != self.num_layers - 1:
                    out = torch.cat(
                        [out, out_max[:, None, :].expand(n, m, -1).reshape(
                            n * m, -1)],
                        dim=-1,
                    )
            if self.residual and prev_out.shape == out.shape:
                out = prev_out + out
            prev_out = out
        return torch.amax(out.reshape(n, m, -1), dim=1)
