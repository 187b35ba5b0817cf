"""Nested-scheme HEALPix pixelization math (numpy, host-side).

Copy of ``sdfest_tpu/ops/healpix.py`` (the port imports nothing of the JAX
package): the two healpy entry points the original SDFEst SO(3) grid uses,
``ang2pix`` and ``pix2ang`` in the NESTED scheme for power-of-two ``nside``.
Implements the standard HEALPix algorithms (Gorski et al. 2005); vectorized
over inputs.  The tables built from these functions are tiny (<=768 cells in
practice) and are computed once on the host.
"""
from __future__ import annotations

import numpy as np

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Spread the lower 16 bits of v so bit i lands at position 2i."""
    v = v.astype(np.uint32)
    v = (v | (v << 8)) & np.uint32(0x00FF00FF)
    v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
    v = (v | (v << 2)) & np.uint32(0x33333333)
    v = (v | (v << 1)) & np.uint32(0x55555555)
    return v


def _compress_bits(v: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_spread_bits`: gather even bits into the low bits."""
    v = v.astype(np.uint32) & np.uint32(0x55555555)
    v = (v | (v >> 1)) & np.uint32(0x33333333)
    v = (v | (v >> 2)) & np.uint32(0x0F0F0F0F)
    v = (v | (v >> 4)) & np.uint32(0x00FF00FF)
    v = (v | (v >> 8)) & np.uint32(0x0000FFFF)
    return v


def xy_to_nest(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Interleave (ix, iy) face coordinates into a nested in-face index."""
    return (_spread_bits(ix) | (_spread_bits(iy) << 1)).astype(np.int64)


def nest_to_xy(ipf: np.ndarray) -> tuple:
    """Deinterleave a nested in-face index into (ix, iy)."""
    ipf = np.asarray(ipf, dtype=np.int64)
    ix = _compress_bits(ipf.astype(np.uint32))
    iy = _compress_bits((ipf >> 1).astype(np.uint32))
    return ix.astype(np.int64), iy.astype(np.int64)


def ang2pix_nest(nside: int, theta, phi) -> np.ndarray:
    """Convert spherical angles to nested-scheme pixel indices.

    Args:
        nside: Resolution parameter (power of two).
        theta: Colatitude in radians, ``[0, pi]``.
        phi: Longitude in radians.
    Returns:
        Nested pixel indices, int64, same shape as the broadcast inputs.
    """
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) / (0.5 * np.pi)  # in [0, 4)

    # equatorial region
    temp1 = nside * (0.5 + tt)
    temp2 = nside * (z * 0.75)
    jp = np.floor(temp1 - temp2).astype(np.int64)
    jm = np.floor(temp1 + temp2).astype(np.int64)
    ifp = jp >> int(np.log2(nside)) if nside > 1 else jp
    ifm = jm >> int(np.log2(nside)) if nside > 1 else jm
    face_eq = np.where(
        ifp == ifm, (ifp & 3) + 4, np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8)
    )
    ix_eq = jm & (nside - 1)
    iy_eq = nside - (jp & (nside - 1)) - 1

    # polar caps
    ntt = np.minimum(np.floor(tt), 3.0)
    tp = tt - ntt
    tmp = nside * np.sqrt(3.0 * (1.0 - za))
    jp_p = np.minimum(np.floor(tp * tmp).astype(np.int64), nside - 1)
    jm_p = np.minimum(np.floor((1.0 - tp) * tmp).astype(np.int64), nside - 1)
    north = z >= 0
    face_pol = np.where(north, ntt.astype(np.int64), ntt.astype(np.int64) + 8)
    ix_pol = np.where(north, nside - jm_p - 1, jp_p)
    iy_pol = np.where(north, nside - jp_p - 1, jm_p)

    equatorial = za <= 2.0 / 3.0
    face = np.where(equatorial, face_eq, face_pol)
    ix = np.where(equatorial, ix_eq, ix_pol)
    iy = np.where(equatorial, iy_eq, iy_pol)
    return face * nside * nside + xy_to_nest(ix, iy)


def pix2ang_nest(nside: int, ipix) -> tuple:
    """Convert nested-scheme pixel indices to cell-center angles.

    Args:
        nside: Resolution parameter (power of two).
        ipix: Nested pixel indices in ``[0, 12 * nside^2)``.
    Returns:
        Tuple ``(theta, phi)`` of colatitude/longitude arrays (radians).
    """
    ipix = np.asarray(ipix, dtype=np.int64)
    npface = nside * nside
    face = ipix // npface
    ipf = ipix % npface
    ix, iy = nest_to_xy(ipf)

    jr = _JRLL[face] * nside - ix - iy - 1  # ring index in [1, 4 nside - 1]

    north_cap = jr < nside
    south_cap = jr > 3 * nside
    nr = np.where(north_cap, jr, np.where(south_cap, 4 * nside - jr, nside))
    z = np.where(
        north_cap,
        1.0 - nr * nr / (3.0 * npface),
        np.where(
            south_cap,
            -1.0 + nr * nr / (3.0 * npface),
            (2 * nside - jr) * 2.0 / (3.0 * nside),
        ),
    )
    kshift = np.where(north_cap | south_cap, 0, (jr - nside) & 1)

    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp_frac_odd = (_JPLL[face] * nr + ix - iy + 1 + kshift) % 2
    # (the numerator is always even for valid nested pixels; keep exactness)
    del jp_frac_odd
    jp = np.where(jp > 4 * nside, jp - 4 * nside, jp)
    jp = np.where(jp < 1, jp + 4 * nside, jp)

    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / (2.0 * nr))
    return theta, phi
