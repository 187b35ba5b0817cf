"""Differentiable depth rendering and SDF sampling (counterpart of
``sdfest_tpu/render/api.py``).

- :func:`render_depth`: the march forward and the analytic surrogate
  backward (``api.py:176-262``).
- :func:`sample_sdf_masked_extrapolating`: masked extrapolating sampling
  whose backward is one scatter (``api.py:58-124``).
- :func:`render_depth_with_pc_values`: the refinement loop's fused op, the
  march plus the pc values forward, and ONE sample-grad plus ONE scatter over
  the concatenated surrogate and pc queries backward (``api.py:288-462``).
- :func:`render_depth_warm`: the temporal-coherence render, the warm/aux
  corridor march forward (per-ray warm start and skip in, corridor fields
  out) and the same surrogate backward (``api.py:470-540``).
- :func:`ray_set`: the rays of a full-frame or ROI render (``_roi_dirs``);
  an ROI render marches only the crop's rays.

The same code runs on both devices; only the kernels differ (CUDA tensors
launch the hand-written kernels, CPU tensors take their plain versions).

Hypotheses.  Every op takes a batch of hypotheses: a grid ``(B, R, R, R)``
with poses ``(B, 3)``, ``(B, 4)`` and scales ``(B,)`` renders the shared
rays once per hypothesis and gives depth ``(B, H, W)`` (and pc values
``(B, M)`` of the shared cloud), through ONE launch of each kernel forward
and one sample-grad and one scatter backward, for all hypotheses.  Each
quaternion is normalized on its own.  An unbatched call is the batch of
one.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import _base_and_frac
from sdfest_torch.render import kernels
from sdfest_torch.render.plain import (
    WARM_OUTPUTS,
    pixel_directions,
    pixel_directions_np,
    ray_interval,
)
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
        ctx.res = sdf.shape[-1]
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
            grad_points = grad * cot[..., None]
        return grad_sdf, grad_points, None


def sample_sdf_masked_extrapolating(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked, extrapolating trilinear samples ``(N,)`` (or ``(B, N)`` of a
    batch of grids ``(B, R, R, R)`` and rows ``(B, N, 3)``), differentiable
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


def _tiled(h: int, w: int) -> bool:
    return h % kernels.TILE == 0 and w % kernels.TILE == 0


def crop(x: torch.Tensor, roi: Tuple[int, int],
         roi_offset: torch.Tensor) -> torch.Tensor:
    """The ``(Hr, Wr, ...)`` crop of ``x (H, W, ...)`` at ``roi_offset``.

    ``roi_offset`` is an integer ``(2,)`` ``[row, col]`` tensor on ``x``'s
    device.  It is clamped so that the crop lies in the frame, as
    ``jax.lax.dynamic_slice`` clamps, and applied as an index gather, so
    it is never read on the host.
    """
    h, w = x.shape[:2]
    if roi[0] > h or roi[1] > w:
        raise ValueError(f"roi {tuple(roi)} does not fit the {h}x{w} frame")
    dev = x.device
    r0 = torch.clamp(roi_offset[0].long(), 0, h - roi[0])
    c0 = torch.clamp(roi_offset[1].long(), 0, w - roi[1])
    rows = r0 + torch.arange(roi[0], device=dev)
    cols = c0 + torch.arange(roi[1], device=dev)
    return x[rows[:, None], cols[None, :]]


class Rays(NamedTuple):
    """The rays of one render, in the two orders the fused op reads.

    ``march``: ``(Hr, Wr, 3)`` in raster order, the march kernel's input.
    ``surrogate``: ``(Hr*Wr, 3)`` in the surrogate's query order, 16x16
    tile-major when both dims are multiples of 16, raster otherwise.
    """

    march: torch.Tensor
    surrogate: torch.Tensor

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.march.shape[:2])

    def order(self, x: torch.Tensor) -> torch.Tensor:
        """Rasters ``(..., Hr, Wr)``, flat in the surrogate's query order
        ``(..., Hr*Wr)``."""
        h, w = self.shape
        lead = x.shape[:-2]
        if _tiled(h, w):
            t = kernels.TILE
            x = x.reshape(*lead, h // t, t, w // t, t).transpose(-3, -2)
        return x.reshape(*lead, h * w)


def ray_set(camera: Camera, device, roi: Optional[Tuple[int, int]] = None,
            roi_offset: Optional[torch.Tensor] = None) -> Rays:
    """The rays of a render of ``camera``, or of its ``roi=(Hr, Wr)`` crop at
    ``roi_offset`` (``_roi_dirs``, ``sdfest_tpu/render/api.py:229-245``).

    Full frame: the cached camera constants, no launch.  ROI: a crop of the
    cached full-frame directions, gathered on the device; the refinement
    loop builds it once per phase and passes it to every iteration.
    """
    device = torch.device(device)
    h, w = camera.height, camera.width
    full = pixel_directions(camera, device).reshape(h, w, 3)
    if roi is None:
        sur = _tiled_directions(camera, device) if _tiled(h, w) else (
            pixel_directions(camera, device))
        return Rays(full, sur)
    roi = (int(roi[0]), int(roi[1]))
    if roi_offset is None:
        roi_offset = torch.zeros(2, dtype=torch.int32, device=device)
    march = crop(full, roi, roi_offset).contiguous()
    sur = kernels.tile_image(march, *roi) if _tiled(*roi) else (
        march.reshape(-1, 3))
    return Rays(march, sur.contiguous())


def _surrogate_queries(position, orientation, inv_scale, depth, rays):
    """Object-frame queries ``(..., N, 3)``, mask ``(..., N)`` and ``|d_z|``
    ``(N,)`` of the depth surrogate in the ray set's query order
    (``api.py:339-364``), for a pose ``(3,)``, ``(4,)``, ``()`` and depth
    ``(Hr, Wr)``, or hypotheses' ``(B, 3)``, ``(B, 4)``, ``(B,)`` and
    ``(B, Hr, Wr)``; each quaternion's ``|q|^2`` divides its own queries."""
    dirs = rays.surrogate
    dz = dirs[:, 2]
    depth_o = rays.order(depth)
    t = -depth_o / dz
    x = t[..., None] * dirs
    o = quaternion.apply(quaternion.invert(orientation)[..., None, :],
                         x - position[..., None, :])
    o = o / torch.sum(orientation * orientation, dim=-1)[..., None, None]
    return o * inv_scale[..., None, None], depth_o > 0, torch.abs(dz)


def _render_forward(sdf, position, orientation, inv_scale, static):
    rays, threshold, max_steps, culling, adaptive, relaxation, bf16 = static
    pose = kernels.pose_params(position, orientation, inv_scale)
    return kernels.march(sdf.contiguous(), rays.march, pose, threshold,
                         max_steps, culling, adaptive, relaxation=relaxation,
                         bf16=bf16)


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
        ctx.rays = static[0]
        return depth

    @staticmethod
    def backward(ctx, grad_depth):
        return (*_surrogate_backward(ctx, grad_depth), None)


def _surrogate_backward(ctx, grad_depth):
    """Gradients of ``(sdf, position, orientation, inv_scale)`` through the
    depth surrogate: one sample-grad and one scatter over the ray set."""
    sdf, position, orientation, inv_scale, depth = ctx.saved_tensors
    needs = ctx.needs_input_grad[:4]
    rays = ctx.rays
    with torch.enable_grad():
        s, p, q, i = (_leaf(x, n) for x, n in zip(
            (sdf, position, orientation, inv_scale), needs))
        sur, mask, abs_dz = _surrogate_queries(p, q, i, depth, rays)
        vals = sample_sdf_masked_extrapolating(s, sur, mask)
        sur_val = vals / i[..., None] * abs_dz
        return _grads([sur_val], [rays.order(grad_depth)], [s, p, q, i],
                      needs)


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
    roi: Optional[Tuple[int, int]] = None,
    roi_offset=None,
    relaxation: float = 1.0,
    bf16: bool = False,
) -> torch.Tensor:
    """Render the depth image ``(H, W)`` of a posed, scaled, voxelized SDF.

    Conventions of ``sdfest_tpu.render.render_depth``: the SDF pose is in
    the camera frame (OpenGL: the camera looks down -z, y up), the raster's
    first row is up, misses are 0.  Differentiable w.r.t. ``sdf``,
    ``position``, ``orientation`` and ``inv_scale`` through the analytic
    surrogate.  ``culling``/``adaptive`` select the march's coarse-bound
    steps and per-ray over-relaxation; with both off it is the plain march
    of the JAX package's XLA backend.  ``relaxation > 1`` takes the relaxed
    march (Keinert's over-stepping with revert, ``adaptive`` ignored).
    ``bf16`` gates every fine step with a bf16 sample and its certified
    error (``csrc/march.cu``); it acts only with culling, and there turns
    ``adaptive`` off, as ``bf16`` does in the JAX package.
    Runs on ``device`` ("cuda" unless the caller asks for "cpu"); CUDA
    requested and absent raises.

    ``roi=(Hr, Wr)`` + ``roi_offset`` (an integer ``[row, col]``, zeros
    when None) render only that crop of the frame: the march runs on the
    crop's rays, so the ``(Hr, Wr)`` result equals the same crop of the
    full render bit for bit.
    """
    device = resolve_device(device)
    if roi_offset is not None:
        roi_offset = torch.as_tensor(roi_offset, device=device)
    static = (ray_set(camera, device, roi, roi_offset), float(threshold),
              int(max_steps), bool(culling), bool(adaptive),
              float(relaxation), bool(bf16))
    return _RenderDepth.apply(*_posed(sdf, position, orientation, inv_scale,
                                      device), static)


def _posed(sdf, position, orientation, scale, device):
    """``sdf``, ``position``, ``orientation`` and ``scale`` as float32
    tensors on ``device``, shaped ``(R, R, R)``, ``(3,)``, ``(4,)``, ``()``
    or, for a grid ``(B, R, R, R)``, ``(B, 3)``, ``(B, 4)``, ``(B,)``."""
    sdf = _f32(sdf, device)
    lead = sdf.shape[:-3]
    return (sdf, _f32(position, device).reshape(*lead, 3),
            _f32(orientation, device).reshape(*lead, 4),
            _f32(scale, device).reshape(lead))


# ---------------------------------------------------------------------------
# fused render + pc values
# ---------------------------------------------------------------------------


def _pc_object_points(position, orientation, inv_scale, points, point_mask,
                      res):
    """Object-frame pc queries ``(..., M, 3)`` of points ``(M, 3)`` and their
    validity ``(..., M)`` (the pc-loss transform, ``api.py:270-285``) for a
    pose or hypotheses' poses (leading dims as in
    :func:`_surrogate_queries`); each quaternion is normalized on its
    own."""
    q = orientation / torch.sqrt(torch.sum(orientation * orientation,
                                           dim=-1, keepdim=True))
    obj = quaternion.apply(quaternion.invert(q)[..., None, :],
                           points - position[..., None, :])
    obj = obj * inv_scale[..., None, None]
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
            position, orientation, inv_scale, points, point_mask,
            sdf.shape[-1]
        )
        values = kernels.sample(sdf.contiguous(), obj.contiguous(),
                                mask.to(torch.float32))
        ctx.save_for_backward(sdf, position, orientation, inv_scale, points,
                              point_mask, depth)
        ctx.rays = static[0]
        return depth, values

    @staticmethod
    def backward(ctx, grad_depth, grad_vals):
        (sdf, position, orientation, inv_scale, points, point_mask,
         depth) = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        res = sdf.shape[-1]
        with torch.enable_grad():
            s, p, q, i, pts = (_leaf(x, n) for x, n in zip(
                (sdf, position, orientation, inv_scale, points), needs))
            sur, sur_mask, abs_dz = _surrogate_queries(
                p, q, i, depth, ctx.rays
            )
            obj, pc_mask = _pc_object_points(p, q, i, pts, point_mask, res)
            vals = sample_sdf_masked_extrapolating(
                s, torch.cat([sur, obj], dim=-2),
                torch.cat([sur_mask, pc_mask], dim=-1),
            )
            n_sur = sur.shape[-2]
            sur_val = vals[..., :n_sur] / i[..., None] * abs_dz
            grads = _grads(
                [sur_val, vals[..., n_sur:]], [ctx.rays.order(grad_depth),
                                               grad_vals],
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
    roi: Optional[Tuple[int, int]] = None,
    roi_offset=None,
    rays: Optional[Rays] = None,
    relaxation: float = 1.0,
    bf16: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a depth image AND sample the SDF at observed points, fused.

    Returns ``(depth (H, W), pc_values (M,))``; the pc values are the
    metric distances of ``sdfest_tpu.pipeline.losses.pc_loss`` (trilinear
    value at the posed points times ``scale``, 0 outside the volume or the
    mask).  The backward runs one sample-grad and one scatter for both.

    ``roi=(Hr, Wr)`` + ``roi_offset`` render only that crop (``depth`` is
    ``(Hr, Wr)``, the same crop of the full render bit for bit); the pc
    values do not change (``api.py:416-420``).  ``rays`` passes the
    :func:`ray_set` of ``(camera, roi, roi_offset)`` instead, built once by
    a caller that renders the same crop many times.  ``relaxation`` and
    ``bf16`` as in :func:`render_depth`.

    Hypotheses: a grid ``(B, R, R, R)`` with ``position (B, 3)``,
    ``orientation (B, 4)`` and ``scale (B,)`` gives ``depth (B, Hr, Wr)``
    and ``pc_values (B, M)`` of the shared ``points``, from one launch of
    each kernel.
    """
    device = resolve_device(device)
    sdf, position, orientation, scale = _posed(sdf, position, orientation,
                                               scale, device)
    inv_scale = 1.0 / scale
    if rays is None:
        if roi_offset is not None:
            roi_offset = torch.as_tensor(roi_offset, device=device)
        rays = ray_set(camera, device, roi, roi_offset)
    elif roi is not None or roi_offset is not None:
        raise ValueError("pass either roi/roi_offset or a prebuilt ray set")
    static = (rays, float(threshold), int(max_steps), bool(culling),
              bool(adaptive), float(relaxation), bool(bf16))
    depth, values = _RenderPC.apply(
        sdf, position, orientation, inv_scale, _f32(points, device),
        torch.as_tensor(point_mask, device=device), static,
    )
    return depth, values * scale[..., None]


# ---------------------------------------------------------------------------
# temporal-coherence warm render
# ---------------------------------------------------------------------------


class _RenderDepthWarm(torch.autograd.Function):
    """Forward: the warm/aux corridor march kernel.  Backward: the surrogate
    VJP of :class:`_RenderDepth` over the full-frame ray set
    (``_render_pallas_warm``); the corridor outputs carry no gradient."""

    @staticmethod
    def forward(ctx, sdf, position, orientation, inv_scale, t_init, skip,
                static):
        rays, pose, threshold, max_steps = static
        outs = kernels.march_warm(sdf.contiguous(), rays.march, pose, t_init,
                                  skip, threshold, max_steps)
        ctx.save_for_backward(sdf, position, orientation, inv_scale, outs[0])
        ctx.rays = rays
        ctx.mark_non_differentiable(*outs[1:])
        return outs

    @staticmethod
    def backward(ctx, grad_depth, *_):
        return (*_surrogate_backward(ctx, grad_depth), None, None, None)


def render_depth_warm(
    sdf,
    position,
    orientation,
    inv_scale,
    t_init,
    skip,
    camera: Camera,
    threshold: float = 0.0,
    max_steps: int = 500,
    device="cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Depth render with per-ray temporal-coherence state (the counterpart
    of ``sdfest_tpu.render.api.render_depth_warm``).

    The march is the culling march with relaxation 1 (no adaptive
    over-relaxation).  Rays with ``t_init >= 0`` (``(H, W)``) start at
    ``max(t_min, t_init)`` instead of the box entry; rays with ``skip > 0``
    are not marched (depth 0).  Differentiable w.r.t. ``sdf``, ``position``,
    ``orientation`` and ``inv_scale`` through the surrogate of
    :func:`render_depth`.

    Returns ``(depth (H, W), aux)``: ``aux`` holds the ``(H, W)`` corridor
    fields ``t``, ``v0``, ``min_dip``, ``v_last``, ``t_last`` (see
    ``csrc/march.cu``) and the ray setup ``t0`` (the actual start),
    ``t_min``, ``t_max`` (the box interval), none of them differentiable.
    Hypotheses: a grid ``(B, R, R, R)`` with poses ``(B, ...)`` and
    ``t_init``/``skip`` ``(B, H, W)`` gives ``(B, H, W)`` everywhere, from
    one launch of the warm march.
    """
    device = resolve_device(device)
    rays = ray_set(camera, device)
    args = _posed(sdf, position, orientation, inv_scale, device)
    lead = args[0].shape[:-3]
    t_init = _f32(t_init, device).contiguous()
    skip = _f32(skip, device).contiguous()
    with torch.no_grad():
        pose = kernels.pose_params(*args[1:])
        _, t_min, t_max = (x.reshape(*lead, *rays.shape) for x in
                           ray_interval(rays.march.reshape(-1, 3), pose))
        t0 = torch.where(t_init >= 0.0, torch.maximum(t_min, t_init), t_min)
    outs = _RenderDepthWarm.apply(
        *args, t_init, skip, (rays, pose, float(threshold), int(max_steps)))
    aux = dict(zip(WARM_OUTPUTS[1:], outs[1:]), t0=t0, t_min=t_min,
               t_max=t_max)
    return outs[0], aux
