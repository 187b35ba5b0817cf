"""Deterministic low-dispersion grid on SO(3) via the Hopf fibration.

Copy of ``sdfest_tpu/ops/so3grid.py`` (Yershova et al. 2010, base grid
only), with healpy replaced by :mod:`sdfest_torch.ops.healpix`.  The S^1
factor is an equidistant grid of ``6 * 2^r`` points; the S^2 factor is a
nested HEALPix grid of ``12 * 4^r`` cells; cell index = ``s1_index * n_s2 +
s2_index``.

All cell-center quaternions are precomputed into a table
(:meth:`SO3Grid.quaternions`), so decoding a discretized orientation on the
device is an argmax plus one gather.  :func:`quat_to_index` is the batched
tensor counterpart of ``sdfest_tpu/ops/so3grid_jax.py`` (the generated
views' labels), equal to it integer for integer.
"""
from __future__ import annotations

from typing import Tuple

import math

import numpy as np
import torch

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


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x mod y`` for ``y > 0`` as ``jnp.mod`` computes it: the exact
    ``fmod``, plus ``y`` where that is negative."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def _spread_bits(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _ang2pix_nest(nside: int, theta: torch.Tensor, phi: torch.Tensor
                  ) -> torch.Tensor:
    """Nested-scheme HEALPix ang2pix (power-of-two ``nside``) on tensors,
    in float32 as ``so3grid_jax.ang2pix_nest`` computes it."""
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = _mod(phi, 2 * math.pi) / (0.5 * math.pi)
    # equatorial
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = torch.floor(temp1 - temp2).to(torch.int64)
    jm = torch.floor(temp1 + temp2).to(torch.int64)
    shift = max(int(nside).bit_length() - 1, 0)
    ifp, ifm = jp >> shift, jm >> shift
    face_eq = torch.where(ifp == ifm, (ifp & 3) + 4,
                          torch.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
    ix_eq = jm & (nside - 1)
    iy_eq = nside - (jp & (nside - 1)) - 1
    # polar caps
    ntt = torch.clamp(torch.floor(tt), max=3.0)
    tp = tt - ntt
    tmp = nside * torch.sqrt(3.0 * (1.0 - za))
    jp_p = torch.clamp(torch.floor(tp * tmp).to(torch.int64), max=nside - 1)
    jm_p = torch.clamp(torch.floor((1.0 - tp) * tmp).to(torch.int64),
                       max=nside - 1)
    north = z >= 0
    face_pol = torch.where(north, ntt.to(torch.int64),
                           ntt.to(torch.int64) + 8)
    ix_pol = torch.where(north, nside - jm_p - 1, jp_p)
    iy_pol = torch.where(north, nside - jp_p - 1, jm_p)
    equatorial = za <= 2.0 / 3.0
    face = torch.where(equatorial, face_eq, face_pol)
    ix = torch.where(equatorial, ix_eq, ix_pol)
    iy = torch.where(equatorial, iy_eq, iy_pol)
    return face * nside * nside + (_spread_bits(ix) | (_spread_bits(iy) << 1))


def quat_to_index(quat: torch.Tensor, resol: int) -> torch.Tensor:
    """Grid cell indices (int64, shape ``(...)``) of float32 quaternions
    ``(..., 4)``, scalar-last, on their device."""
    x, y, z, w = torch.unbind(quat, dim=-1)
    psi = _mod(2.0 * torch.atan2(x, w), 2 * math.pi)
    theta = 2.0 * torch.atan2(torch.sqrt(z * z + y * y),
                              torch.sqrt(w * w + x * x))
    phi = _mod(torch.atan2(z * w - x * y, y * w + x * z), 2 * math.pi)
    nside = 2 ** resol
    n_s1 = 6 * nside
    s1_index = torch.clamp(
        torch.floor(psi / (2 * math.pi / n_s1)).to(torch.int64), 0, n_s1 - 1)
    return s1_index * (12 * nside * nside) + _ang2pix_nest(nside, theta, phi)
