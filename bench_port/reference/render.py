"""The reference's sphere tracer and its differentiable renders.

The march is the culling march with adaptive over-relaxation that the
estimate and the VAE's pc loss are specified with (relaxation 1, fp32
samples): every ray in the object's box steps by the coarse table's bound
where that is far from the surface and by the sampled distance near it,
vectorized over all rays as one masked loop.  The depth's gradient comes
from the local first-order surrogate around the hit points, and the pc
values from masked trilinear samples; both backward passes run through one
:class:`~bench_port.reference.ops.SampleOp` over the concatenated queries.
A frozen copy of the specification, in plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bench_port.reference import ops

NC = 16
COARSE_MARGIN = 1e-4
OMEGA_INIT, OMEGA_GROW, OMEGA_MAX = 1.4, 0.2, 1.9
MAX_STEPS = 500


def coarse_min_table(sdf: torch.Tensor, nc: int = NC) -> torch.Tensor:
    """``(nc, nc, nc)`` lower bound of the interpolant per coarse cell."""
    res = sdf.shape[-1]
    i = torch.arange(nc, device=sdf.device)
    lo = (i * (res - 1)) // nc
    hi = torch.clamp(((i + 1) * (res - 1)) // nc + 1, max=res - 1)
    v = torch.arange(res, device=sdf.device)
    m = (v[None, :] >= lo[:, None]) & (v[None, :] <= hi[:, None])
    big = sdf.new_full((), float("inf"))
    t1 = torch.amin(torch.where(m[:, :, None, None], sdf[None], big), -3)
    t2 = torch.amin(torch.where(m[:, :, None], t1[..., None, :, :], big), -2)
    return torch.amin(torch.where(m, t2[..., None, :], big), -1) \
        - COARSE_MARGIN


def coarse_lookup(table: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    nc = table.shape[0]
    ci = torch.clamp(torch.floor((p + 1.0) * (nc * 0.5)), 0, nc - 1).long()
    return table.reshape(-1)[(ci[:, 0] * nc + ci[:, 1]) * nc + ci[:, 2]]


def pose_params(position, orientation, inv_scale) -> torch.Tensor:
    """``(B, 14)``: rotation (row major), ``R^T (-position)``, inverse
    scale and scale of each hypothesis."""
    lead = position.shape[:-1]
    rot = ops.q_to_matrix(orientation)
    p = -position
    origin = (rot[..., 0, :] * p[..., 0:1] + rot[..., 1, :] * p[..., 1:2]
              + rot[..., 2, :] * p[..., 2:3])
    inv_scale = inv_scale.reshape(*lead, 1)
    return torch.cat([rot.reshape(*lead, 9), origin, inv_scale,
                      1.0 / inv_scale], dim=-1).to(torch.float32)


def _object_rays(dirs, pose):
    rot = pose[None, :9]
    return (dirs[:, 0:1] * rot[..., 0:3] + dirs[:, 1:2] * rot[..., 3:6]
            + dirs[:, 2:3] * rot[..., 6:9])


def _box_interval(dirs_o, e, scale):
    parallel = torch.abs(dirs_o) <= 1e-20
    safe = torch.where(parallel, torch.ones_like(dirs_o), dirs_o)
    t1 = (e + scale) / safe
    t2 = (e - scale) / safe
    inf = torch.full_like(dirs_o, float("inf"))
    lo = torch.where(parallel, -inf, torch.minimum(t1, t2))
    hi = torch.where(parallel, inf, torch.maximum(t1, t2))
    t_min = torch.clamp(torch.amax(lo, dim=-1), min=-1e-10)
    t_max = torch.amin(hi, dim=-1)
    miss = torch.any(parallel & (torch.abs(e) > scale), dim=-1)
    hit = (~miss) & (t_min <= t_max) & (t_max >= 0)
    return hit, torch.clamp(t_min, min=0.0), t_max


def march_one(sdf, dirs, pose, threshold: float) -> torch.Tensor:
    """Depth ``(N,)`` of rays ``(N, 3)`` against one posed grid."""
    scale = pose[13]
    dirs_o = _object_rays(dirs, pose)
    hit, t, t_max = _box_interval(dirs_o, -pose[9:12], scale)
    dz = dirs[:, 2]
    depth = torch.zeros_like(t)
    active = hit & (t < t_max)
    zeros = torch.zeros_like(t)
    stepped, d_prev = zeros, zeros
    omega = torch.full_like(t, OMEGA_INIT)
    table = coarse_min_table(sdf)
    for _ in range(MAX_STEPS):
        if not bool(torch.any(active)):
            break
        p = (pose[9:12] + t[:, None] * dirs_o) * pose[12]
        cd = coarse_lookup(table, p) * scale
        far = active & (cd >= threshold * t + 1e-5)
        t = torch.where(far, t + cd, t)
        stepped = torch.where(far, zeros, stepped)
        fine = active & ~far
        dist = ops.sample(sdf, p) * scale
        revert = fine & (stepped > d_prev + dist) & (stepped > 0.0)
        ok = fine & ~revert
        hit_now = ok & (dist < threshold * t)
        adv = ok & ~hit_now
        step_len = omega * dist
        depth = torch.where(hit_now, -t * dz, depth)
        t = torch.where(revert, t - stepped + d_prev,
                        torch.where(adv, t + step_len, t))
        stepped = torch.where(revert, zeros,
                              torch.where(adv, step_len, stepped))
        d_prev = torch.where(adv, dist, d_prev)
        omega = torch.where(revert, torch.ones_like(omega),
                            torch.where(adv, torch.clamp(omega + OMEGA_GROW,
                                                         max=OMEGA_MAX),
                                        omega))
        active = active & ~hit_now & (t < t_max)
    return depth


def march(sdf, rays: torch.Tensor, pose, threshold: float) -> torch.Tensor:
    """Depth ``(B, H, W)`` of grids ``(B, R, R, R)`` at poses ``(B, 14)``
    for rays ``(H, W, 3)``."""
    h, w = rays.shape[:2]
    flat = rays.reshape(-1, 3)
    return torch.stack([march_one(sdf[b], flat, pose[b], threshold)
                        for b in range(sdf.shape[0])]).reshape(-1, h, w)


class Rays(NamedTuple):
    """A render's rays in raster order ``(Hr, Wr, 3)`` and in the
    surrogate's query order ``(Hr*Wr, 3)``."""

    march: torch.Tensor
    surrogate: torch.Tensor


def crop(x: torch.Tensor, roi: Tuple[int, int], offset: torch.Tensor):
    h, w = x.shape[:2]
    r0 = torch.clamp(offset[0].long(), 0, h - roi[0])
    c0 = torch.clamp(offset[1].long(), 0, w - roi[1])
    rows = r0 + torch.arange(roi[0], device=x.device)
    cols = c0 + torch.arange(roi[1], device=x.device)
    return x[rows[:, None], cols[None, :]]


def ray_set(camera: ops.Camera, device, roi=None, offset=None) -> Rays:
    full = torch.from_numpy(ops.pixel_directions(camera)).to(device)
    if roi is not None:
        full = crop(full, roi, offset).contiguous()
    h, w = full.shape[:2]
    sur = ops.tile_image(full, h, w) if ops.tiled(h, w) else \
        full.reshape(-1, 3)
    return Rays(full, sur.contiguous())


def _surrogate_queries(position, orientation, inv_scale, depth, rays):
    dirs = rays.surrogate
    dz = dirs[:, 2]
    depth_o = ops.to_query_order(depth)
    t = -depth_o / dz
    x = t[..., None] * dirs
    o = ops.q_apply(ops.q_invert(orientation)[..., None, :],
                    x - position[..., None, :])
    o = o / torch.sum(orientation * orientation, dim=-1)[..., None, None]
    return o * inv_scale[..., None, None], depth_o > 0, torch.abs(dz)


def _pc_queries(position, orientation, inv_scale, points, point_mask, res):
    q = orientation / torch.sqrt(torch.sum(orientation * orientation,
                                           dim=-1, keepdim=True))
    obj = ops.q_apply(ops.q_invert(q)[..., None, :],
                      points - position[..., None, :])
    obj = obj * inv_scale[..., None, None]
    _, _, inside = ops.base_and_frac(obj, res)
    return obj, torch.logical_and(inside, point_mask != 0)


class RenderPC(torch.autograd.Function):
    """Depth ``(B, Hr, Wr)`` and pc values ``(B, M)`` forward; the surrogate
    and pc queries through one sample backward."""

    @staticmethod
    def forward(ctx, sdf, position, orientation, inv_scale, points,
                point_mask, rays, threshold):
        with torch.no_grad():
            pose = pose_params(position, orientation, inv_scale)
            depth = march(sdf, rays.march, pose, threshold)
            obj, mask = _pc_queries(position, orientation, inv_scale, points,
                                    point_mask, sdf.shape[-1])
            values = ops.masked_sample(sdf, obj, mask.to(torch.float32))
        ctx.save_for_backward(sdf, position, orientation, inv_scale, points,
                              point_mask, depth)
        ctx.rays = rays
        return depth, values

    @staticmethod
    def backward(ctx, grad_depth, grad_vals):
        sdf, position, orientation, inv_scale, points, point_mask, depth = \
            ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        res = sdf.shape[-1]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(n) for x, n in zip(
                (sdf, position, orientation, inv_scale, points), needs)]
            s, p, q, i, pts = leaves
            sur, sur_mask, abs_dz = _surrogate_queries(p, q, i, depth,
                                                       ctx.rays)
            obj, pc_mask = _pc_queries(p, q, i, pts, point_mask, res)
            vals = ops.sample_masked(s, torch.cat([sur, obj], dim=-2),
                                     torch.cat([sur_mask, pc_mask], dim=-1))
            n_sur = sur.shape[-2]
            sur_val = vals[..., :n_sur] / i[..., None] * abs_dz
            wanted = [x for x, n in zip(leaves, needs) if n]
            got = iter(torch.autograd.grad(
                [sur_val, vals[..., n_sur:]],
                wanted, [ops.to_query_order(grad_depth), grad_vals],
                allow_unused=True))
            grads = []
            for x, n in zip(leaves, needs):
                g = next(got) if n else None
                grads.append(torch.zeros_like(x) if n and g is None else g)
        return (*grads, None, None, None)


def render_with_pc(sdf, position, orientation, scale, points, point_mask,
                   rays: Rays, threshold: float):
    """Depth ``(B, Hr, Wr)`` and metric pc values ``(B, M)`` of grids
    ``(B, R, R, R)`` at hypotheses' poses ``(B, 3)``, ``(B, 4)``, scales
    ``(B,)``, differentiable in all four."""
    inv_scale = 1.0 / scale
    depth, values = RenderPC.apply(sdf, position, orientation, inv_scale,
                                   points, point_mask, rays, threshold)
    return depth, values * scale[..., None]


def render_depth(sdf, position, orientation, scale, camera: ops.Camera,
                 threshold: float) -> torch.Tensor:
    """Depth ``(B, H, W)`` of grids ``(B, R, R, R)`` at poses, without a
    gradient."""
    with torch.no_grad():
        rays = torch.from_numpy(ops.pixel_directions(camera)).to(sdf.device)
        pose = pose_params(position, orientation, 1.0 / scale)
        return march(sdf, rays, pose, threshold)
