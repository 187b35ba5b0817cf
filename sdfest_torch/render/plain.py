"""The plain PyTorch sphere-tracing renderer (counterpart of
``sdfest_tpu/render/xla.py``): ray directions, the OBB slab test, the march
and the depth surrogate.

:func:`march_plain` is the twin the CUDA march is held against.  With
``culling`` and ``adaptive`` off it is ``xla._render_forward`` step for step;
with them on, with ``relaxation > 1`` or with ``bf16``, it runs the CUDA
kernel's per-ray algorithm, vectorized over all rays as one masked
while-loop.  :func:`march_warm_plain` is the same for the warm/aux corridor
march.  A bf16 sample rounds the grid's values to bf16 and interpolates them
in float32 (:func:`bf16_corners`), as the kernel does, so the two agree to
the bit.

Hypotheses.  The coarse tables, :func:`bf16_corners`, :func:`object_rays`
and :func:`ray_interval` take leading hypothesis dims on the grid
``(B, R, R, R)`` and the pose ``(B, 14)``, elementwise, so each hypothesis
gets the bits it gets alone.  The plain marches take a batched grid and
pose (and per-hypothesis ``t_init``/``skip``) by running the unbatched
march once per hypothesis (:func:`per_hypothesis`): the twins of the
batched kernels equal a loop of unbatched twins by construction.
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
# error bound of a bf16 sample relative to the max |corner|: kBf16Err of
# csrc/march.cu, which derives it (2^-8 * amax, with a 1.5x margin)
BF16_ERR = 6e-3


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


def per_hypothesis(n: int, fn):
    """``fn(b)`` for each hypothesis ``b < n``, stacked (a tuple of results
    element by element): the plain version of a batched kernel."""
    outs = [fn(b) for b in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(xs) for xs in zip(*outs))
    return torch.stack(outs)


def _no_steps(steps) -> None:
    if steps is not None:
        raise ValueError("steps are counted for one hypothesis at a time")


def _coarse_pool(vol: torch.Tensor, nc: int, reduce: str, fill: float
                 ) -> torch.Tensor:
    """``(..., nc, nc, nc)`` reduction of ``vol (..., res, res, res)`` over
    the fine vertices that the interpolation of any point of each coarse
    cell can touch (a min or max: exact, whatever the leading dims).

    Coarse cell ``i`` covers fine coordinates ``u in [i, i+1] * (res-1)/nc``;
    the trilinear corners of such ``u`` are ``floor(u)`` and ``floor(u)+1``.
    """
    res = vol.shape[-1]
    i = torch.arange(nc, device=vol.device)
    lo = (i * (res - 1)) // nc
    hi = torch.clamp(((i + 1) * (res - 1)) // nc + 1, max=res - 1)
    v = torch.arange(res, device=vol.device)
    m = (v[None, :] >= lo[:, None]) & (v[None, :] <= hi[:, None])  # (nc, res)
    big = vol.new_full((), fill)
    red = getattr(torch, reduce)
    t1 = red(torch.where(m[:, :, None, None], vol[..., None, :, :, :], big),
             -3)
    t2 = red(torch.where(m[:, :, None], t1[..., None, :, :], big), -2)
    return red(torch.where(m, t2[..., None, :], big), -1)


def coarse_min_table(sdf: torch.Tensor, nc: int = NC) -> torch.Tensor:
    """Conservative ``(..., nc, nc, nc)`` lower bound of the interpolant per
    coarse cell (``pallas_kernel.coarse_min_table``, min block): an
    interpolant is bounded below by its corners' minimum."""
    return (_coarse_pool(sdf, nc, "amin", float("inf"))
            - COARSE_MARGIN).contiguous()


def coarse_max_table(sdf: torch.Tensor, nc: int = NC) -> torch.Tensor:
    """``(..., nc, nc, nc)`` maximum ``|value|`` over the same window per coarse
    cell, without margin (``pallas_kernel.coarse_min_table``, second block):
    the scale of the bf16 sample's error."""
    return _coarse_pool(torch.abs(sdf), nc, "amax", 0.0).contiguous()


def coarse_pair_table(sdf: torch.Tensor, nc: int = NC) -> torch.Tensor:
    """``(..., nc, nc, nc, 2)``: the min and max-|value| tables interleaved
    per coarse cell, the table of the bf16 marches (one ``float2`` per
    cell)."""
    return torch.stack([coarse_min_table(sdf, nc), coarse_max_table(sdf, nc)],
                       dim=-1).contiguous()


def coarse_lookup(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant lookup of a coarse table at points ``(N, 3)``."""
    nc = table.shape[0]
    ci = torch.clamp(torch.floor((p + 1.0) * (nc * 0.5)), 0, nc - 1).long()
    return table.reshape(-1)[(ci[:, 0] * nc + ci[:, 1]) * nc + ci[:, 2]]


def bf16_corners(sdf: torch.Tensor) -> torch.Tensor:
    """The grid with every value rounded to bf16 (round to nearest even)
    and widened back to float32: what a bf16 sample interpolates, with the
    weights, lerps and sums in float32."""
    return sdf.to(torch.bfloat16).to(torch.float32)


class _Bf16Step:
    """The bf16 gate of a fine step (``pallas_kernel.py:1327-1357``): a
    sample on the bf16-rounded corners, ``d_fast``, and its certified error
    ``err = BF16_ERR * amax * scale``; a ray whose ``d_fast`` is not within
    ``err`` of its termination band (``d_fast >= threshold*t + err``) takes
    a fast step, the others verify with the fp32 sample."""

    def __init__(self, sdf: torch.Tensor, scale: torch.Tensor):
        self.corners = bf16_corners(sdf)
        self.amax = coarse_max_table(sdf)
        self.err_c = torch.tensor(BF16_ERR, dtype=torch.float32,
                                  device=sdf.device)
        self.scale = scale

    def __call__(self, p, t, threshold, fine):
        """``(fast, d_fast, err)`` at points ``p``: ``fast`` marks the rays
        of ``fine`` that step without verification."""
        err = self.err_c * coarse_lookup(self.amax, p) * self.scale
        d_fast = sample_sdf(self.corners, p) * self.scale
        return fine & ~(d_fast < threshold * t + err), d_fast, err


def object_rays(dirs: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """``R^T d`` per ray ``(..., N, 3)`` of rays ``(N, 3)`` at poses ``(...,
    14)``, written out in the CUDA kernels' order: every ray's result
    depends on its own direction only (no matmul blocking), so an ROI
    render is the full render's crop bit for bit."""
    rot = pose[..., None, :9]
    return (dirs[:, 0:1] * rot[..., 0:3] + dirs[:, 1:2] * rot[..., 3:6]
            + dirs[:, 2:3] * rot[..., 6:9])


def ray_interval(dirs: torch.Tensor, pose: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hit, t_min, t_max)``, each ``(..., N)``, of rays ``(N, 3)``
    against the box at poses ``(..., 14)``, as the CUDA kernels compute them
    (bit for bit)."""
    return obb_interval(object_rays(dirs, pose), -pose[..., None, 9:12],
                        pose[..., None, 13:14])


def _point(pose, dirs_o, t):
    return (pose[9:12] + t[:, None] * dirs_o) * pose[12]


class _StepCount:
    """The ``steps`` report of the plain marches: rays that entered the box,
    fine (fp32-sampled) and bound ray-steps, distinct grid cells the fine
    steps read, and the ``longest`` ray's steps (the chain that a launch
    waits for); for a bf16 march also its ``fast`` steps and the distinct
    cells of the bf16 grid that its bf16 samples (fast and verified) read."""

    def __init__(self, active: torch.Tensor, sdf: torch.Tensor, bf16: bool):
        self.rays, self.fine, self.bound = int(active.sum()), 0, 0
        self.per_ray = torch.zeros(active.shape, dtype=torch.int32,
                                   device=active.device)
        self.res = sdf.shape[0]
        self.touched = torch.zeros(sdf.numel(), dtype=torch.bool,
                                   device=sdf.device)
        self.bf16 = bf16
        self.fast = 0
        self.touched_bf16 = torch.zeros_like(self.touched)

    def _touch(self, touched, rows, p):
        idx, _ = trilinear_weights(p[rows], self.res)
        touched[idx.reshape(-1)] = True

    def add(self, fine: torch.Tensor, far: torch.Tensor, p: torch.Tensor,
            fast: Optional[torch.Tensor] = None):
        self.fine += int(fine.sum())
        self.bound += int(far.sum())
        self.per_ray += fine | far if fast is None else fine | far | fast
        self._touch(self.touched, fine, p)
        if fast is not None:
            self.fast += int(fast.sum())
            self._touch(self.touched_bf16, fine | fast, p)

    def report(self, steps: Dict[str, int]) -> None:
        steps.update(rays=self.rays, fine=self.fine, bound=self.bound,
                     cells=int(self.touched.sum()),
                     longest=int(self.per_ray.max()) if self.rays else 0)
        if self.bf16:
            steps.update(fast=self.fast,
                         cells_bf16=int(self.touched_bf16.sum()))


def march_plain(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    threshold: float,
    max_steps: int,
    culling: bool,
    adaptive: bool,
    steps: Optional[Dict[str, int]] = None,
    relaxation: float = 1.0,
    bf16: bool = False,
) -> torch.Tensor:
    """Depth ``(N,)`` of rays ``dirs (N, 3)`` against the posed SDF.

    ``pose`` is ``[rot (9, row-major), origin_o (3), inv_scale, scale]``
    (:func:`sdfest_torch.render.kernels.pose_params`).  One step is one
    sample or one coarse bound lookup, for every active ray at once.  With
    ``relaxation > 1`` the march over-steps by that factor with Keinert's
    revert, and ``adaptive`` is ignored (``march.cu``).  ``bf16`` gates each
    fine step with a bf16 sample (``march.cu``); it acts only with culling,
    and there it turns ``adaptive`` off, as the JAX package dispatches.
    When ``steps`` is given, it receives the number of ``rays`` that entered
    the box, of ``fine`` and ``bound`` ray-steps taken and of distinct grid
    ``cells`` the fine steps read (the work the march does on these
    inputs), and the steps of the ``longest`` ray; with bf16 also the
    ``fast`` steps and ``cells_bf16``.

    A grid ``(B, R, R, R)`` with poses ``(B, 14)`` marches each hypothesis
    alone and gives ``(B, N)`` (``steps`` not taken then).
    """
    if sdf.ndim == 4:
        _no_steps(steps)
        return per_hypothesis(sdf.shape[0], lambda b: march_plain(
            sdf[b], dirs, pose[b], threshold, max_steps, culling, adaptive,
            relaxation=relaxation, bf16=bf16))
    scale = pose[13]
    dirs_o = object_rays(dirs, pose)
    hit, t, t_max = obb_interval(dirs_o, -pose[9:12], scale)
    dz = dirs[:, 2]
    depth = torch.zeros_like(t)
    active = hit & (t < t_max)
    zeros = torch.zeros_like(t)
    stepped, d_prev = zeros, zeros
    relaxed = relaxation > 1.0
    bf16 = bf16 and culling
    adaptive = adaptive and not bf16
    omega = torch.full_like(t, OMEGA_INIT if adaptive else 1.0)
    table = coarse_min_table(sdf) if culling else None
    gate = _Bf16Step(sdf, scale) if bf16 else None
    count = _StepCount(active, sdf, bf16) if steps is not None else None
    for _ in range(max_steps):
        if not bool(torch.any(active)):
            break
        p = _point(pose, dirs_o, t)
        fine, far, fast = active, zeros.bool(), None
        if culling:
            cd = coarse_lookup(table, p) * scale
            far = active & (cd >= threshold * t + 1e-5)
            if relaxed:
                far = far & ~(stepped > d_prev + cd)
                d_prev = torch.where(far, zeros, d_prev)
            t = torch.where(far, t + cd, t)
            stepped = torch.where(far, zeros, stepped)
            fine = active & ~far
        if gate:
            fast, d_fast, err = gate(p, t, threshold, fine)
            fine = fine & ~fast
            if relaxed:  # relaxed_update(d_fast - err, d_fast, no hit)
                d_cert = d_fast - err
                revert = fast & (stepped > d_prev + d_cert) & (stepped > 0.0)
                adv = fast & ~revert
                step_len = relaxation * d_fast
                t = torch.where(revert, t - stepped + d_prev,
                                torch.where(adv, t + step_len, t))
                stepped = torch.where(revert, zeros,
                                      torch.where(adv, step_len, stepped))
                d_prev = torch.where(adv, d_cert, d_prev)
            else:
                t = torch.where(fast, t + d_fast - err, t)
        if count:
            count.add(fine, far, p, fast)
        dist = sample_sdf(sdf, p) * scale
        if relaxed or adaptive:
            revert = fine & (stepped > d_prev + dist) & (stepped > 0.0)
            ok = fine & ~revert
            hit_now = ok & (dist < threshold * t)
            adv = ok & ~hit_now
            step_len = (relaxation if relaxed else omega) * dist
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
    if count:
        count.report(steps)
    return depth


WARM_OUTPUTS = ("depth", "t", "v0", "min_dip", "v_last", "t_last")


def march_warm_plain(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    t_init: torch.Tensor,
    skip: torch.Tensor,
    threshold: float,
    max_steps: int,
    steps: Optional[Dict[str, int]] = None,
    bf16: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The warm/aux corridor march of rays ``dirs (N, 3)`` (the twin of
    ``march_warm_kernel`` in ``csrc/march.cu``, which documents it): culling
    with relaxation 1, per-ray warm start ``t_init (N,)`` (used when >= 0)
    and ``skip (N,)`` (> 0: not marched).  With ``bf16`` a fine step is
    gated by a bf16 sample as in :func:`march_plain`; a fast step feeds the
    corridor its certified lower bound ``d_fast - err``.

    Returns the ``(N,)`` tensors named by :data:`WARM_OUTPUTS`: depth,
    terminal ``t``, the corridor's first value ``v0``, ``min_dip``, last
    value ``v_last`` (zeros for a ray that took no step) and ``t_last``.
    ``steps`` as in :func:`march_plain`.  A grid ``(B, R, R, R)`` with
    poses ``(B, 14)`` and ``t_init``/``skip`` ``(B, N)`` marches each
    hypothesis alone and gives ``(B, N)`` tensors.
    """
    if sdf.ndim == 4:
        _no_steps(steps)
        return per_hypothesis(sdf.shape[0], lambda b: march_warm_plain(
            sdf[b], dirs, pose[b], t_init[b], skip[b], threshold, max_steps,
            bf16=bf16))
    scale = pose[13]
    dirs_o = object_rays(dirs, pose)
    hit, t_min, t_max = obb_interval(dirs_o, -pose[9:12], scale)
    dz = dirs[:, 2]
    t0 = torch.where(t_init >= 0.0, torch.maximum(t_min, t_init), t_min)
    active = hit & (t0 < t_max) & (skip <= 0.0)
    zeros = torch.zeros_like(t0)
    t, depth = t0, zeros
    v_prev, t_prev, v0 = zeros, t0, zeros
    min_dip = torch.full_like(t0, 1e9)
    have = torch.zeros_like(active)
    table = coarse_min_table(sdf)
    gate = _Bf16Step(sdf, scale) if bf16 else None
    count = _StepCount(active, sdf, bf16) if steps is not None else None
    for _ in range(max_steps):
        if not bool(torch.any(active)):
            break
        p = _point(pose, dirs_o, t)
        cd = coarse_lookup(table, p) * scale
        far = active & (cd >= threshold * t + 1e-5)
        fine = active & ~far
        v = torch.where(far, cd, sample_sdf(sdf, p) * scale)
        fast = None
        if gate:
            fast, d_fast, err = gate(p, t, threshold, fine)
            fine = fine & ~fast
            v = torch.where(fast, d_fast - err, v)
        if count:
            count.add(fine, far, p, fast)
        dip = (v_prev + v - (t - t_prev)) * 0.5
        min_dip = torch.where(active & have, torch.minimum(min_dip, dip),
                              min_dip)
        v0 = torch.where(active & ~have, v, v0)
        v_prev = torch.where(active, v, v_prev)
        t_prev = torch.where(active, t, t_prev)
        have = have | active
        hit_now = fine & (v < threshold * t)
        depth = torch.where(hit_now, -t * dz, depth)
        t = torch.where(active & ~hit_now, t + v, t)
        active = active & ~hit_now & (t < t_max)
    if count:
        count.report(steps)
    return (depth, t, torch.where(have, v0, zeros),
            torch.where(have, min_dip, zeros),
            torch.where(have, v_prev, zeros), t_prev)


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
