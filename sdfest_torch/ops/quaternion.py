"""Quaternion operations, scalar-last ``(x, y, z, w)``, on torch tensors.

Counterpart of ``sdfest_tpu/ops/quaternion.py``; the expressions are copied
term by term so results round the same way.
"""
from __future__ import annotations

import math

import torch


def multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Compose two rotations ``q1 * q2``; shapes ``(..., 4)`` broadcast."""
    ax, ay, az, aw = torch.unbind(q1, dim=-1)
    bx, by, bz, bw = torch.unbind(q2, dim=-1)
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox, oy, oz, ow = torch.broadcast_tensors(ox, oy, oz, ow)
    return torch.stack((ox, oy, oz, ow), dim=-1)


def invert(q: torch.Tensor) -> torch.Tensor:
    """Invert unit quaternions (conjugate), shape ``(..., 4)``.  Negation is
    exact, so this equals ``q * [-1, -1, -1, 1]`` bit for bit, without
    building the sign vector on the device every call."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def apply(q: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate points ``(..., 3)`` by quaternions ``(..., 4)``."""
    p = torch.cat([points, torch.zeros_like(points[..., :1])], dim=-1)
    return multiply(multiply(q, p), invert(q))[..., :3]


def to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``(..., 3, 3)`` with ``R @ p == apply(q, p)``."""
    x, y, z, w = torch.unbind(q, dim=-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def geodesic_distance(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Geodesic distance (radians) between quaternions ``(..., 4)``."""
    abs_q1q2 = torch.clamp(torch.abs(torch.sum(q1 * q2, dim=-1)), 0.0, 1.0)
    return 2.0 * torch.arccos(abs_q1q2)


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternions ``(..., 4)`` to unit norm."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def simple_quaternion_loss(q1: torch.Tensor, q2: torch.Tensor
                           ) -> torch.Tensor:
    """Trig-free rotation distance: mean of ``1 - <q1, q2>^2``."""
    return torch.mean(1.0 - torch.sum(q1 * q2, dim=-1) ** 2)


def from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Unit quaternions ``(..., 4)`` from uniforms ``(..., 3)`` in ``[0, 1)``
    (Shoemake 1992): uniformly distributed on SO(3)."""
    u1, u2, u3 = torch.unbind(u, dim=-1)
    two_pi = 2.0 * math.pi
    return torch.stack(
        [
            torch.sqrt(1.0 - u1) * torch.sin(two_pi * u2),
            torch.sqrt(1.0 - u1) * torch.cos(two_pi * u2),
            torch.sqrt(u1) * torch.sin(two_pi * u3),
            torch.sqrt(u1) * torch.cos(two_pi * u3),
        ],
        dim=-1,
    )


def random_uniform(shape: tuple = (), generator: torch.Generator = None,
                   device=None) -> torch.Tensor:
    """Uniformly distributed unit quaternions, shape ``shape + (4,)``,
    drawn from ``generator`` (on ``device``)."""
    return from_uniforms(torch.rand(*shape, 3, generator=generator,
                                    device=device))
