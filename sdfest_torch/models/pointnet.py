"""PointNet backbones (counterpart of ``sdfest_tpu/models/pointnet.py``):
``VanillaPointNet``, ``IterativePointNet`` and
``GeneralizedIterativePointNet``.

The per-point MLP runs on the flattened ``(N*M, C)`` view, so BatchNorm
normalizes over all points of all sets, as in the JAX package.  Training
mode (``module.train()``) normalizes with the batch's statistics and moves
the running ones as flax does (:class:`BatchNorm`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class _TrainingNorm(torch.autograd.Function):
    """Training-mode batch norm with given batch statistics: the forward is
    PyTorch's fused batch-norm pass over ``(N, C)``, the backward its fused
    training backward (which also carries the gradient through the
    statistics)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_batch_norm_backward(
            dy.contiguous(), x, weight, None, None, mean, invstd, True,
            ctx.eps, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None, None, None


class BatchNorm(nn.BatchNorm1d):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over ``(N, C)``.

    In training the batch variance is flax's ``E[x^2] - E[x]^2`` (clipped at
    0; in float32 the two-pass variance moves the init network's loss by
    ~2e-5 of its value), and the running variance moves toward that *biased*
    variance: ``nn.BatchNorm1d`` would move it toward the unbiased one,
    larger by ``N / (N - 1)`` (64 / 63 in the init network's head at batch
    64) every step.  PyTorch's ``momentum=0.1`` is flax's 0.9.  In eval mode
    it is ``nn.BatchNorm1d``.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            mean = torch.mean(x, dim=0)
            var = torch.clamp(torch.mean(x * x, dim=0) - mean * mean,
                              min=0.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return _TrainingNorm.apply(x, self.weight, self.bias, mean, var,
                                   self.eps)


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
                self.add_module(f"bn_{i}", BatchNorm(out_size))
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


def _concat_feature(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``concat(out repeated over the points, x)``, ``(N, M, F + C)``."""
    return torch.cat([out[:, None, :].expand(-1, x.shape[1], -1), x], dim=2)


class IterativePointNet(nn.Module):
    """Two PointNets; the second is re-applied ``num_concat`` times to
    ``concat(out, x)``."""

    def __init__(self, num_concat: int, in_size: int,
                 mlp_out_sizes: Sequence[int], batchnorm: bool):
        super().__init__()
        self.num_concat = num_concat
        self.pointnet_1 = VanillaPointNet(in_size, mlp_out_sizes, batchnorm)
        self.pointnet_2 = VanillaPointNet(in_size + mlp_out_sizes[-1],
                                          mlp_out_sizes, batchnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.pointnet_1(x)
        for _ in range(self.num_concat):
            out = self.pointnet_2(_concat_feature(out, x))
        return out


class GeneralizedIterativePointNet(nn.Module):
    """A sequence of IterativePointNets; each stage after the first takes
    ``concat(previous out, input)``."""

    def __init__(self, list_concat: Sequence[int], in_size: int,
                 list_mlp_out_sizes: Sequence[Sequence[int]],
                 batchnorm: bool):
        super().__init__()
        self.num_nets = len(list_concat)
        size = in_size
        for i, (num_concat, sizes) in enumerate(zip(list_concat,
                                                    list_mlp_out_sizes)):
            self.add_module(f"iterative_pointnet_{i}", IterativePointNet(
                num_concat, size, sizes, batchnorm))
            size = sizes[-1] + in_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        init_x, out = x, None
        for i in range(self.num_nets):
            out = getattr(self, f"iterative_pointnet_{i}")(x)
            x = _concat_feature(out, init_x)
        return out
