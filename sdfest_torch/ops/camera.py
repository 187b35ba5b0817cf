"""Pinhole camera model (counterpart of ``sdfest_tpu/ops/camera.py``).

A frozen, hashable dataclass, so ray-direction tables can be cached per
camera.  ``strided`` gives the exactly-strided camera of the coarse
refinement phases; the Open3D export is not ported yet.
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

    def strided(self, factor: int) -> "Camera":
        """Camera observing every ``factor``-th pixel of this camera.

        Its pixel ``(i, j)`` ray is this camera's pixel ``(factor*i,
        factor*j)`` ray: with ``c = cx - pixel_center``, ``fx' = fx/factor``
        and ``cx' = c/factor + pixel_center`` give the same slope.  So
        ``depth[::factor, ::factor]`` is an exact sub-observation, which the
        coarse-to-fine refinement rests on.
        """
        if factor < 1 or self.width % factor or self.height % factor:
            raise ValueError(
                f"stride {factor} must divide {self.width}x{self.height}"
            )
        if self.s != 0.0:
            raise ValueError("strided() requires zero skew")
        pc = self.pixel_center
        return dataclasses.replace(
            self,
            width=self.width // factor,
            height=self.height // factor,
            fx=self.fx / factor,
            fy=self.fy / factor,
            cx=(self.cx - pc) / factor + pc,
            cy=(self.cy - pc) / factor + pc,
        )

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
