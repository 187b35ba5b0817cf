"""Analytic test scenes (voxelized SDFs; a copy of
``sdfest_tpu/utils/scenes.py``).

The mug is the benchmark scene: a thin-walled open vessel with a handle,
whose silhouette-grazing rays march many fine steps.  The procedural mug and
bowl families make the synthetic training and evaluation sets
(:mod:`sdfest_torch.scripts.make_procedural_dataset`); the sphere is the
easy secondary scene.
"""
from __future__ import annotations

import numpy as np


def make_sphere_sdf(res: int = 64, radius: float = 0.5) -> np.ndarray:
    """Exact sphere SDF on a [-1, 1]^3 grid."""
    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - radius).astype(np.float32)


def make_mug_sdf(res: int = 64) -> np.ndarray:
    """Mug-class SDF: hollow cylinder body + torus handle on a [-1, 1]^3 grid.

    Built from standard CSG distance bounds (union = min, subtraction =
    max(a, -b)); the result is a conservative lower bound on distance except
    on the subtraction seam, which a 64^3 voxelization smooths below the
    march threshold.  Thin rim + interior wall produce a heavy graze band.
    """
    return make_mug_family_sdf(res)


def make_mug_family_sdf(
    res: int = 64,
    *,
    body_radius: float = 0.52,
    body_half_height: float = 0.55,
    wall: float = 0.08,
    bottom: float = 0.08,
    taper: float = 0.0,
    handle_ring: float = 0.28,
    handle_tube: float = 0.07,
    handle_y: float = 0.05,
    handle_gap: float = 0.10,
) -> np.ndarray:
    """Parameterized mug-family SDF on a [-1, 1]^3 grid.

    The shape family behind the procedural training data (the repository
    ships no ShapeNet, so the committed mug models were trained on grids
    from this generator, in the role ShapeNet meshes converted by the
    upstream ``process_shapenet`` script play there).  Defaults reproduce
    the benchmark mug of :func:`make_mug_sdf` exactly.

    Parameters
    ----------
    body_radius: outer radius of the vessel at its mid-height.
    body_half_height: half-height of the vessel.
    wall: wall thickness (cavity radius = ``body_radius - wall``).
    bottom: upward shift of the cavity; sets the base thickness and keeps
        the top open (the cavity protrudes past the rim).
    taper: relative radius change from bottom to top (0 = straight;
        0.1 = top 10% wider).  Applied to body and cavity so the wall
        thickness stays ~constant; the radial field is then a distance
        bound tight to ~cos(slant) (<1% for taper <= 0.2).
    handle_ring / handle_tube: torus major/minor radius of the handle.
    handle_y: vertical offset of the handle center.
    handle_gap: gap between the body surface and the handle ring center
        minus ring radius (ring center x = body_radius + handle_gap).
    """
    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")

    def capped_cylinder(px, py, pz, radius, half_h):
        # capped cylinder aligned with y; ``radius`` may vary with y
        # (taper), making the radial term a tight distance bound
        d_r = np.sqrt(px * px + pz * pz) - radius
        d_y = np.abs(py) - half_h
        outside = np.sqrt(np.maximum(d_r, 0.0) ** 2 + np.maximum(d_y, 0.0) ** 2)
        inside = np.minimum(np.maximum(d_r, d_y), 0.0)
        return outside + inside

    # linear taper: radius(y) interpolates body_radius*(1 -/+ taper/2)
    # from bottom to top
    r_scale = 1.0 + taper * (y / (2.0 * body_half_height))
    body = capped_cylinder(x, y, z, body_radius * r_scale, body_half_height)
    cavity = capped_cylinder(
        x, y - bottom, z, (body_radius - wall) * r_scale, body_half_height
    )
    vessel = np.maximum(body, -cavity)

    # torus handle in the x-y plane, attached at the body surface
    tx, ty = x - (body_radius + handle_gap), y - handle_y
    ring = np.sqrt(tx * tx + ty * ty) - handle_ring
    handle = np.sqrt(ring * ring + z * z) - handle_tube

    return np.minimum(vessel, handle).astype(np.float32)


# sampling bounds of the procedural mug family (kept inside the grid:
# max body_radius + handle_gap + handle_ring + handle_tube < 1.0)
MUG_FAMILY_BOUNDS = {
    "body_radius": (0.40, 0.56),
    "body_half_height": (0.42, 0.62),
    "wall": (0.055, 0.11),
    "bottom": (0.05, 0.14),
    "taper": (-0.12, 0.18),
    "handle_ring": (0.20, 0.30),
    "handle_tube": (0.05, 0.09),
    "handle_y": (-0.08, 0.12),
    "handle_gap": (0.04, 0.12),
}


def sample_mug_family(rng: np.random.Generator) -> dict:
    """Draw uniform mug-family parameters within :data:`MUG_FAMILY_BOUNDS`.

    The handle extent is re-clamped so the full shape stays inside the
    [-1, 1]^3 grid with a ~2-voxel margin at 64^3.
    """
    params = {
        k: float(rng.uniform(lo, hi)) for k, (lo, hi) in MUG_FAMILY_BOUNDS.items()
    }
    max_x = 0.94
    overhang = (
        params["body_radius"]
        + params["handle_gap"]
        + params["handle_ring"]
        + params["handle_tube"]
    )
    if overhang > max_x:
        params["handle_ring"] -= overhang - max_x
    return params


def make_bowl_family_sdf(
    res: int = 64,
    *,
    radius: float = 0.72,
    wall: float = 0.08,
    bottom: float = 0.10,
    rim: float = 0.30,
    squash: float = 1.0,
) -> np.ndarray:
    """Parameterized bowl-family SDF on a [-1, 1]^3 grid.

    The second procedural category of the training demonstration (the
    reference ships six trained ShapeNet categories, estimation/configs/
    models/*.yaml; bowls are its canonical SYMMETRIC category — this
    family is exactly rotation-symmetric about y, so it exercises the
    symmetry-axis-aware metrics, reference estimation/metrics.py:9-75).

    Spherical shell (outer radius ``radius``, cavity ``radius - wall``
    lifted by ``bottom`` for base thickness) cut by the plane
    ``y <= rim`` (CSG intersection = max; all three fields are distance
    bounds, exact away from the cut seam).  ``squash`` scales y before
    the shell evaluation: <1 flattens the bowl (y-extent shrinks), the
    radial extent is untouched, and the field remains a distance bound
    after multiplying by ``min(1, squash)``.
    """
    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")

    ys = y / squash
    outer = np.sqrt(x * x + ys * ys + z * z) - radius
    yc = (y - bottom) / squash
    cavity = np.sqrt(x * x + yc * yc + z * z) - (radius - wall)
    shell = np.maximum(outer, -cavity)
    bowl = np.maximum(shell, y - rim)
    return (bowl * min(1.0, squash)).astype(np.float32)


# sampling bounds of the procedural bowl family (shape stays inside the
# grid: radius <= 0.8 < 1.0, rim cut keeps the open top)
BOWL_FAMILY_BOUNDS = {
    "radius": (0.58, 0.80),
    "wall": (0.06, 0.12),
    "bottom": (0.06, 0.16),
    "rim": (0.10, 0.42),
    "squash": (0.55, 1.0),
}


def sample_bowl_family(rng: np.random.Generator) -> dict:
    """Uniform bowl-family parameters within :data:`BOWL_FAMILY_BOUNDS`."""
    return {
        k: float(rng.uniform(lo, hi))
        for k, (lo, hi) in BOWL_FAMILY_BOUNDS.items()
    }
