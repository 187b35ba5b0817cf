"""Differentiable depth rendering and SDF sampling (counterpart of
``sdfest_tpu/render/api.py``).

- :func:`render_depth`: the march forward and the analytic surrogate
  backward (``api.py:176-262``).
- :func:`sample_sdf_masked_extrapolating`: masked extrapolating sampling
  whose backward is one scatter (``api.py:58-124``).
- :func:`render_depth_with_pc_values`: the refinement loop's fused op, the
  march plus the pc values forward, and ONE sample-grad plus ONE scatter over
  the concatenated surrogate and pc queries backward (``api.py:288-462``).

The same code runs on both devices; only the kernels differ (CUDA tensors
launch the hand-written kernels, CPU tensors take their plain versions).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import _base_and_frac
from sdfest_torch.render import kernels
from sdfest_torch.render.plain import pixel_directions, pixel_directions_np
from sdfest_torch.utils.device import resolve_device


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# masked extrapolating sample op
# ---------------------------------------------------------------------------


class _SampleOp(torch.autograd.Function):
    """Forward: sample-grad kernel (values + residual gradients).
    Backward: scatter kernel for the grid, ``grad * cot`` for the points
    (``_sample_op_pallas``, api.py:58-98).  The mask is applied once."""

    @staticmethod
    def forward(ctx, sdf, points, mask):
        value, grad = kernels.sample_grad(sdf, points, mask)
        ctx.save_for_backward(points, mask, grad)
        ctx.res = sdf.shape[0]
        return value

    @staticmethod
    def backward(ctx, cot):
        points, mask, grad = ctx.saved_tensors
        grad_sdf = grad_points = None
        if ctx.needs_input_grad[0]:
            grad_sdf = kernels.scatter(
                points, (cot * mask).contiguous(), ctx.res
            )
        if ctx.needs_input_grad[1]:
            grad_points = grad * cot[:, None]
        return grad_sdf, grad_points, None


def sample_sdf_masked_extrapolating(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked, extrapolating trilinear samples ``(N,)``, differentiable
    w.r.t. ``sdf`` and ``points``; the mask selects and is not
    differentiated."""
    mask = mask.detach().to(torch.float32).contiguous()
    sdf, points = sdf.contiguous(), points.contiguous()
    if torch.is_grad_enabled() and (sdf.requires_grad or points.requires_grad):
        return _SampleOp.apply(sdf, points, mask)
    return kernels.sample(sdf, points, mask)


# ---------------------------------------------------------------------------
# march and surrogate backward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _tiled_directions(camera: Camera, device: torch.device) -> torch.Tensor:
    """Ray directions ``(H*W, 3)`` in 16x16 tile-major order (camera
    constant, cached on the device)."""
    h, w = camera.height, camera.width
    d = torch.from_numpy(pixel_directions_np(camera))
    return kernels.tile_image(d, h, w).contiguous().to(device)


def _tiled(camera: Camera) -> bool:
    return camera.height % kernels.TILE == 0 and camera.width % kernels.TILE == 0


def _surrogate_queries(position, orientation, inv_scale, depth, camera):
    """Object-frame queries, mask and ``|d_z|`` of the depth surrogate, in
    tile order when the raster allows (``api.py:339-364``) and raster order
    otherwise, plus the function that brings a raster into that order."""
    h, w = depth.shape
    if _tiled(camera):
        dirs = _tiled_directions(camera, depth.device)
        order = lambda x: kernels.tile_image(x[..., None], h, w).reshape(-1)
    else:
        dirs = pixel_directions(camera, depth.device)
        order = lambda x: x.reshape(-1)
    dz = dirs[:, 2]
    depth_o = order(depth)
    t = -depth_o / dz
    x = t[:, None] * dirs
    o = quaternion.apply(quaternion.invert(orientation), x - position)
    o = o / torch.sum(orientation * orientation)
    return o * inv_scale, depth_o > 0, torch.abs(dz), order


def _render_forward(sdf, position, orientation, inv_scale, static):
    camera, threshold, max_steps, culling, adaptive = static
    dirs = pixel_directions(camera, sdf.device)
    pose = kernels.pose_params(position, orientation, inv_scale)
    depth = kernels.march(sdf.contiguous(), dirs, pose, threshold, max_steps,
                          culling, adaptive)
    return depth.reshape(camera.height, camera.width)


def _leaf(x: torch.Tensor, needs: bool) -> torch.Tensor:
    return x.detach().requires_grad_(needs)


def _grads(outputs, cotangents, leaves, needs):
    wanted = [x for x, n in zip(leaves, needs) if n]
    if not wanted:
        return [None] * len(leaves)
    got = iter(torch.autograd.grad(outputs, wanted, cotangents,
                                   allow_unused=True))
    out = []
    for x, n in zip(leaves, needs):
        g = next(got) if n else None
        out.append(torch.zeros_like(x) if n and g is None else g)
    return out


class _RenderDepth(torch.autograd.Function):
    """March forward; surrogate VJP backward (``_render_pallas``)."""

    @staticmethod
    def forward(ctx, sdf, position, orientation, inv_scale, static):
        depth = _render_forward(sdf, position, orientation, inv_scale, static)
        ctx.save_for_backward(sdf, position, orientation, inv_scale, depth)
        ctx.camera = static[0]
        return depth

    @staticmethod
    def backward(ctx, grad_depth):
        sdf, position, orientation, inv_scale, depth = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            s, p, q, i = (_leaf(x, n) for x, n in zip(
                (sdf, position, orientation, inv_scale), needs))
            sur, mask, abs_dz, order = _surrogate_queries(
                p, q, i, depth, ctx.camera
            )
            vals = sample_sdf_masked_extrapolating(s, sur, mask)
            sur_val = vals / i * abs_dz
            grads = _grads([sur_val], [order(grad_depth)], [s, p, q, i],
                           needs)
        return (*grads, None)


def render_depth(
    sdf,
    position,
    orientation,
    inv_scale,
    camera: Camera,
    threshold: float = 0.0,
    max_steps: int = 500,
    culling: bool = True,
    adaptive: bool = True,
    device="cuda",
) -> torch.Tensor:
    """Render the depth image ``(H, W)`` of a posed, scaled, voxelized SDF.

    Conventions of ``sdfest_tpu.render.render_depth``: the SDF pose is in
    the camera frame (OpenGL: the camera looks down -z, y up), the raster's
    first row is up, misses are 0.  Differentiable w.r.t. ``sdf``,
    ``position``, ``orientation`` and ``inv_scale`` through the analytic
    surrogate.  ``culling``/``adaptive`` select the march's coarse-bound
    steps and per-ray over-relaxation; with both off it is the plain march
    of the JAX package's XLA backend.  Runs on ``device`` ("cuda" unless the
    caller asks for "cpu"); CUDA requested and absent raises.  ROI,
    relaxed and bf16 marching are not ported yet.
    """
    device = resolve_device(device)
    static = (camera, float(threshold), int(max_steps), bool(culling),
              bool(adaptive))
    return _RenderDepth.apply(
        _f32(sdf, device), _f32(position, device), _f32(orientation, device),
        _f32(inv_scale, device), static,
    )


# ---------------------------------------------------------------------------
# fused render + pc values
# ---------------------------------------------------------------------------


def _pc_object_points(position, orientation, inv_scale, points, point_mask,
                      res):
    """Object-frame pc queries and their validity (the pc-loss transform,
    ``api.py:270-285``; the quaternion is normalized explicitly)."""
    q = orientation / torch.sqrt(torch.sum(orientation * orientation))
    obj = quaternion.apply(quaternion.invert(q), points - position)
    obj = obj * inv_scale
    _, _, inside = _base_and_frac(obj, res)
    return obj, torch.logical_and(inside, point_mask != 0)


class _RenderPC(torch.autograd.Function):
    """Forward: march + sample kernels.  Backward: the surrogate and pc
    queries concatenated, one sample-grad + one scatter (``_render_pc_bwd``,
    api.py:320-385)."""

    @staticmethod
    def forward(ctx, sdf, position, orientation, inv_scale, points,
                point_mask, static):
        depth = _render_forward(sdf, position, orientation, inv_scale, static)
        obj, mask = _pc_object_points(
            position, orientation, inv_scale, points, point_mask, sdf.shape[0]
        )
        values = kernels.sample(sdf.contiguous(), obj.contiguous(),
                                mask.to(torch.float32))
        ctx.save_for_backward(sdf, position, orientation, inv_scale, points,
                              point_mask, depth)
        ctx.camera = static[0]
        return depth, values

    @staticmethod
    def backward(ctx, grad_depth, grad_vals):
        (sdf, position, orientation, inv_scale, points, point_mask,
         depth) = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        res = sdf.shape[0]
        with torch.enable_grad():
            s, p, q, i, pts = (_leaf(x, n) for x, n in zip(
                (sdf, position, orientation, inv_scale, points), needs))
            sur, sur_mask, abs_dz, order = _surrogate_queries(
                p, q, i, depth, ctx.camera
            )
            obj, pc_mask = _pc_object_points(p, q, i, pts, point_mask, res)
            vals = sample_sdf_masked_extrapolating(
                s, torch.cat([sur, obj], dim=0),
                torch.cat([sur_mask, pc_mask], dim=0),
            )
            n_sur = sur.shape[0]
            sur_val = vals[:n_sur] / i * abs_dz
            grads = _grads(
                [sur_val, vals[n_sur:]], [order(grad_depth), grad_vals],
                [s, p, q, i, pts], needs,
            )
        return (*grads, None, None)


def render_depth_with_pc_values(
    sdf,
    position,
    orientation,
    scale,
    points,
    point_mask,
    camera: Camera,
    threshold: float = 0.0,
    max_steps: int = 500,
    culling: bool = True,
    adaptive: bool = True,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a depth image AND sample the SDF at observed points, fused.

    Returns ``(depth (H, W), pc_values (M,))``; the pc values are the
    metric distances of ``sdfest_tpu.pipeline.losses.pc_loss`` (trilinear
    value at the posed points times ``scale``, 0 outside the volume or the
    mask).  The backward runs one sample-grad and one scatter for both.
    """
    device = resolve_device(device)
    scale = _f32(scale, device)
    inv_scale = 1.0 / scale
    static = (camera, float(threshold), int(max_steps), bool(culling),
              bool(adaptive))
    depth, values = _RenderPC.apply(
        _f32(sdf, device), _f32(position, device), _f32(orientation, device),
        inv_scale, _f32(points, device),
        torch.as_tensor(point_mask, device=device), static,
    )
    return depth, values * scale
