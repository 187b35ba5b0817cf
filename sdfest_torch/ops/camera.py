"""Pinhole camera model (counterpart of ``sdfest_tpu/ops/camera.py``).

A frozen, hashable dataclass, so ray-direction tables can be cached per
camera.  ``strided`` and the Open3D export are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera intrinsics.

    ``pixel_center`` defines the relation between continuous image plane
    coordinates and discrete pixel coordinates: discrete ``(x, y)``
    corresponds to continuous ``(x + pixel_center, y + pixel_center)``.
    """

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    s: float = 0.0
    pixel_center: float = 0.0

    def get_pinhole_camera_parameters(self, pixel_center: float) -> Tuple:
        """Return ``(fx, fy, cx, cy, s)`` for the requested pixel center."""
        cx_corrected = self.cx - self.pixel_center + pixel_center
        cy_corrected = self.cy - self.pixel_center + pixel_center
        return self.fx, self.fy, cx_corrected, cy_corrected, self.s

    @staticmethod
    def from_fov(width: int, height: int, fov_deg: float) -> "Camera":
        """Construct a square-pixel camera from a horizontal field of view."""
        f = width / math.tan(fov_deg * math.pi / 180.0 / 2.0) / 2.0
        return Camera(
            width=width,
            height=height,
            fx=f,
            fy=f,
            cx=width / 2.0,
            cy=height / 2.0,
            pixel_center=0.5,
        )
