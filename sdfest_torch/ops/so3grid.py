"""Deterministic low-dispersion grid on SO(3) via the Hopf fibration.

Copy of ``sdfest_tpu/ops/so3grid.py`` (Yershova et al. 2010, base grid
only), with healpy replaced by :mod:`sdfest_torch.ops.healpix`.  The S^1
factor is an equidistant grid of ``6 * 2^r`` points; the S^2 factor is a
nested HEALPix grid of ``12 * 4^r`` cells; cell index = ``s1_index * n_s2 +
s2_index``.

All cell-center quaternions are precomputed into a table
(:meth:`SO3Grid.quaternions`), so decoding a discretized orientation on the
device is an argmax plus one gather.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from sdfest_torch.ops import healpix


class SO3Grid:
    """Low-dispersion SO(3) grid."""

    def __init__(self, resol: int):
        """Construct the grid; ``resol=0`` is the coarsest (72 cells)."""
        self._resol = resol
        self._s1 = self._grid_s1(resol)
        self._s2_theta, self._s2_phi = self._grid_s2(resol)
        self._quaternions = None

    def num_cells(self) -> int:
        """Number of grid cells (``6 * 12 * 8^resol``)."""
        return len(self._s1) * len(self._s2_theta)

    def hopf_to_index(self, psi: float, theta: float, phi: float) -> int:
        """Index of the grid cell closest (in Hopf coordinates) to the input.

        Args:
            psi: ``[0, 2pi)``; theta: ``[0, pi]``; phi: ``[0, 2pi)``.
        """
        s1_index = int(psi // (2 * np.pi / len(self._s1)))
        s2_index = int(
            healpix.ang2pix_nest(2**self._resol, theta, phi)
        )
        return s1_index * len(self._s2_theta) + s2_index

    def index_to_hopf(self, index: int) -> Tuple[float, float, float]:
        """Hopf coordinates ``(psi, theta, phi)`` of a grid cell center."""
        s1_index = index // len(self._s2_theta)
        s2_index = index % len(self._s2_theta)
        return (
            float(self._s1[s1_index]),
            float(self._s2_theta[s2_index]),
            float(self._s2_phi[s2_index]),
        )

    def quat_to_index(self, quaternion: np.ndarray) -> int:
        """Index of the cell closest (in Hopf coordinates) to a quaternion."""
        return self.hopf_to_index(*SO3Grid.quat_to_hopf(quaternion))

    def index_to_quat(self, index: int) -> np.ndarray:
        """Cell-center quaternion (scalar-last, x >= 0 hemisphere)."""
        return SO3Grid.hopf_to_quat(*self.index_to_hopf(index))

    def quaternions(self) -> np.ndarray:
        """Table of all cell-center quaternions, shape (num_cells, 4).

        Computed once and cached; copied to the device once so discretized
        orientations decode there (argmax + gather) without a host
        round-trip.
        """
        if self._quaternions is None:
            n_s2 = len(self._s2_theta)
            psi = np.repeat(self._s1, n_s2)
            theta = np.tile(self._s2_theta, len(self._s1))
            phi = np.tile(self._s2_phi, len(self._s1))
            half_theta = theta / 2.0
            quats = np.stack(
                [
                    np.cos(half_theta) * np.sin(psi / 2),
                    np.sin(half_theta) * np.cos(phi + psi / 2),
                    np.sin(half_theta) * np.sin(phi + psi / 2),
                    np.cos(half_theta) * np.cos(psi / 2),
                ],
                axis=-1,
            )
            flip = quats[:, 0] < 0
            quats[flip] *= -1
            self._quaternions = quats
        return self._quaternions

    @staticmethod
    def quat_to_hopf(quaternion: np.ndarray) -> Tuple[float, float, float]:
        """Convert a scalar-last quaternion to Hopf coordinates.

        Returns:
            ``(psi, theta, phi)`` in ``[0, 2pi) x [0, pi] x [0, 2pi)``.
        """
        x, y, z, w = np.asarray(quaternion, dtype=np.float64)
        psi = 2 * np.arctan2(x, w)
        theta = 2 * np.arctan2(np.sqrt(z * z + y * y), np.sqrt(w * w + x * x))
        phi = np.arctan2(z * w - x * y, y * w + x * z)
        # psi wraps at 4pi (half-sphere change); phi wraps at 2pi
        while psi < 0:
            psi += 2 * np.pi
        while psi >= 2 * np.pi:
            psi -= 2 * np.pi
        while phi < 0:
            phi += 2 * np.pi
        while phi >= 2 * np.pi:
            phi -= 2 * np.pi
        return psi, theta, phi

    @staticmethod
    def hopf_to_quat(psi: float, theta: float, phi: float) -> np.ndarray:
        """Convert Hopf coordinates to a scalar-last quaternion (x >= 0)."""
        quaternion = np.array(
            [
                np.cos(theta / 2) * np.sin(psi / 2),
                np.sin(theta / 2) * np.cos(phi + psi / 2),
                np.sin(theta / 2) * np.sin(phi + psi / 2),
                np.cos(theta / 2) * np.cos(psi / 2),
            ]
        )
        if quaternion[0] < 0:
            quaternion *= -1
        return quaternion

    @staticmethod
    def _grid_s1(resol: int) -> np.ndarray:
        """Equidistant S^1 grid of ``6 * 2^resol`` cell centers."""
        points = 6 * 2**resol
        return np.linspace(0, 2 * np.pi, points, endpoint=False) + np.pi / points

    @staticmethod
    def _grid_s2(resol: int) -> Tuple[np.ndarray, np.ndarray]:
        """Nested HEALPix S^2 grid of ``12 * 4^resol`` cell centers."""
        nside = 2**resol
        points = 12 * nside * nside
        theta, phi = healpix.pix2ang_nest(nside, np.arange(points))
        return theta, phi
