"""The plain PyTorch sphere-tracing renderer (counterpart of
``sdfest_tpu/render/xla.py``): ray directions, the OBB slab test, the march
and the depth surrogate.

:func:`march_plain` is the twin the CUDA march is held against.  With
``culling`` and ``adaptive`` off it is ``xla._render_forward`` step for step;
with them on it runs the CUDA kernel's per-ray algorithm, vectorized over
all rays as one masked while-loop.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import sample_sdf, trilinear_weights

NC = 16  # coarse culling grid per axis
COARSE_MARGIN = 1e-4  # slack below the coarse min-pool (fp noise)
OMEGA_INIT, OMEGA_GROW, OMEGA_MAX = 1.4, 0.2, 1.9  # adaptive over-relaxation


def pixel_directions_np(camera: Camera) -> np.ndarray:
    """Unit ray directions ``(H, W, 3)`` at pixel centers, OpenGL frame.

    Computed on the host in float64 and cast to float32 once, as the JAX
    package's camera-constant planes are (1 ulp from the traced f32 math).
    """
    fx, fy, cx, cy, _ = camera.get_pinhole_camera_parameters(0.5)
    h, w = camera.height, camera.width
    rows, cols = np.mgrid[0:h, 0:w].astype(np.float64)
    dx = (cols + 0.5 - cx) / fx
    dy = -(rows + 0.5 - cy) / fy
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + 1.0)
    return np.stack([dx * inv, dy * inv, -inv], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def pixel_directions(camera: Camera, device: torch.device) -> torch.Tensor:
    """Ray directions ``(H*W, 3)`` in raster order, cached per camera on
    the device."""
    return torch.from_numpy(pixel_directions_np(camera).reshape(-1, 3)).to(
        device
    )


def obb_interval(
    dirs_o: torch.Tensor, e: torch.Tensor, scale: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test of rays (origin 0) against the scaled box.

    ``dirs_o`` are the per-axis direction components ``(N, 3)`` (the ray in
    the object frame) and ``e = rot^T position``.  Returns ``(hit, t_min,
    t_max)`` exactly as ``xla._obb_intersect``.
    """
    parallel = torch.abs(dirs_o) <= 1e-20
    safe_f = torch.where(parallel, torch.ones_like(dirs_o), dirs_o)
    t_1 = (e + scale) / safe_f
    t_2 = (e - scale) / safe_f
    inf = torch.full_like(dirs_o, float("inf"))
    lo = torch.where(parallel, -inf, torch.minimum(t_1, t_2))
    hi = torch.where(parallel, inf, torch.maximum(t_1, t_2))
    t_min = torch.clamp(torch.amax(lo, dim=-1), min=-1e-10)
    t_max = torch.amin(hi, dim=-1)
    miss_parallel = torch.any(parallel & (torch.abs(e) > scale), dim=-1)
    hit = (~miss_parallel) & (t_min <= t_max) & (t_max >= 0)
    return hit, torch.clamp(t_min, min=0.0), t_max


def coarse_min_table(sdf: torch.Tensor, nc: int = NC) -> torch.Tensor:
    """Conservative ``(nc, nc, nc)`` lower bound of the interpolant per
    coarse cell (``pallas_kernel.coarse_min_table``, min block only).

    Coarse cell ``i`` covers fine coordinates ``u in [i, i+1] * (res-1)/nc``;
    the trilinear corners of such ``u`` are ``floor(u)`` and ``floor(u)+1``,
    and an interpolant is bounded below by its corners' minimum.
    """
    res = sdf.shape[0]
    i = torch.arange(nc, device=sdf.device)
    lo = (i * (res - 1)) // nc
    hi = torch.clamp(((i + 1) * (res - 1)) // nc + 1, max=res - 1)
    v = torch.arange(res, device=sdf.device)
    m = (v[None, :] >= lo[:, None]) & (v[None, :] <= hi[:, None])  # (nc, res)
    inf = sdf.new_full((), float("inf"))
    t1 = torch.where(m[:, :, None, None], sdf[None], inf).amin(1)
    t2 = torch.where(m[None, :, :, None], t1[:, None], inf).amin(2)
    t3 = torch.where(m[None, None, :, :], t2[:, :, None, :], inf).amin(3)
    return (t3 - COARSE_MARGIN).contiguous()


def coarse_lookup(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant lookup of the coarse table at points ``(N, 3)``."""
    nc = table.shape[0]
    ci = torch.clamp(torch.floor((p + 1.0) * (nc * 0.5)), 0, nc - 1).long()
    return table.reshape(-1)[(ci[:, 0] * nc + ci[:, 1]) * nc + ci[:, 2]]


def march_plain(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    threshold: float,
    max_steps: int,
    culling: bool,
    adaptive: bool,
    steps: Optional[Dict[str, int]] = None,
) -> torch.Tensor:
    """Depth ``(N,)`` of rays ``dirs (N, 3)`` against the posed SDF.

    ``pose`` is ``[rot (9, row-major), origin_o (3), inv_scale, scale]``
    (:func:`sdfest_torch.render.kernels.pose_params`).  One step is one
    sample or one coarse bound lookup, for every active ray at once.  When
    ``steps`` is given, it receives the number of ``rays`` that entered the
    box, of ``fine`` and ``bound`` ray-steps taken and of distinct grid
    ``cells`` the fine steps read (the work the march does on these
    inputs).
    """
    rot = pose[:9].reshape(3, 3)
    origin_o = pose[9:12]
    inv_scale, scale = pose[12], pose[13]
    # R^T d per ray, written out in the CUDA kernel's order: every ray's
    # result depends on its own direction only (no matmul blocking), so an
    # ROI render is the full render's crop bit for bit
    dirs_o = (dirs[:, 0:1] * rot[0] + dirs[:, 1:2] * rot[1]
              + dirs[:, 2:3] * rot[2])
    hit, t, t_max = obb_interval(dirs_o, -origin_o, scale)
    dz = dirs[:, 2]
    depth = torch.zeros_like(t)
    active = hit & (t < t_max)
    zeros = torch.zeros_like(t)
    stepped, d_prev = zeros, zeros
    omega = torch.full_like(t, OMEGA_INIT if adaptive else 1.0)
    table = coarse_min_table(sdf) if culling else None
    count = {"fine": 0, "bound": 0}
    if steps is not None:
        count["rays"] = int(active.sum())
        touched = torch.zeros(sdf.numel(), dtype=torch.bool,
                              device=sdf.device)
    for _ in range(max_steps):
        if not bool(torch.any(active)):
            break
        p = (origin_o + t[:, None] * dirs_o) * inv_scale
        fine = active
        if culling:
            cd = coarse_lookup(table, p) * scale
            far = active & (cd >= threshold * t + 1e-5)
            t = torch.where(far, t + cd, t)
            stepped = torch.where(far, zeros, stepped)
            fine = active & ~far
            if steps is not None:
                count["bound"] += int(far.sum())
        if steps is not None:
            count["fine"] += int(fine.sum())
            idx, _ = trilinear_weights(p[fine], sdf.shape[0])
            touched[idx.reshape(-1)] = True
        dist = sample_sdf(sdf, p) * scale
        if adaptive:
            revert = fine & (stepped > d_prev + dist) & (stepped > 0.0)
            ok = fine & ~revert
            hit_now = ok & (dist < threshold * t)
            adv = ok & ~hit_now
            step_len = omega * dist
            depth = torch.where(hit_now, -t * dz, depth)
            t = torch.where(
                revert, t - stepped + d_prev, torch.where(adv, t + step_len, t)
            )
            stepped = torch.where(
                revert, zeros, torch.where(adv, step_len, stepped)
            )
            d_prev = torch.where(adv, dist, d_prev)
            omega = torch.where(
                revert,
                torch.ones_like(omega),
                torch.where(
                    adv, torch.clamp(omega + OMEGA_GROW, max=OMEGA_MAX), omega
                ),
            )
        else:
            hit_now = fine & (dist < threshold * t)
            depth = torch.where(hit_now, -t * dz, depth)
            t = torch.where(fine & ~hit_now, t + dist, t)
        active = active & ~hit_now & (t < t_max)
    if steps is not None:
        count["cells"] = int(touched.sum())
        steps.update(count)
    return depth


def depth_surrogate(
    sdf: torch.Tensor,
    position: torch.Tensor,
    orientation: torch.Tensor,
    inv_scale: torch.Tensor,
    depth: torch.Tensor,
    dirs: torch.Tensor,
) -> torch.Tensor:
    """Local first-order model of depth around the terminating points
    (``xla._depth_surrogate``); ``depth`` and ``dirs`` are constants.

    The unnormalized quaternion is applied and divided by ``|q|^2``, so the
    gradients carry the projective normalization.
    """
    dz = dirs[..., 2]
    t = -depth / dz
    x = t[..., None] * dirs
    o = quaternion.apply(quaternion.invert(orientation), x - position)
    o = o / torch.sum(orientation * orientation)
    val = sample_sdf(sdf, o * inv_scale) / inv_scale
    return torch.where(depth > 0, val * torch.abs(dz), torch.zeros_like(val))
