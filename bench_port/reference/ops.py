"""Plain geometry of the reference: quaternions (scalar last), the pinhole
camera, trilinear sampling on a ``[-1, 1]^3`` grid, depth lifting and the
16x16 tile order.

A frozen copy of the formulas the estimate and the VAE trainer are
specified by, written term by term in the same order, so that the same
inputs round the same way.  Nothing here imports the measured program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16


# ---------------------------------------------------------------------------
# quaternions (x, y, z, w)
# ---------------------------------------------------------------------------


def q_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = torch.unbind(q1, dim=-1)
    bx, by, bz, bw = torch.unbind(q2, dim=-1)
    ox = aw * bx + ax * bw + ay * bz - az * by
    oy = aw * by - ax * bz + ay * bw + az * bx
    oz = aw * bz + ax * by - ay * bx + az * bw
    ow = aw * bw - ax * bx - ay * by - az * bz
    ox, oy, oz, ow = torch.broadcast_tensors(ox, oy, oz, ow)
    return torch.stack((ox, oy, oz, ow), dim=-1)


def q_invert(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def q_apply(q: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    p = torch.cat([points, torch.zeros_like(points[..., :1])], dim=-1)
    return q_multiply(q_multiply(q, p), q_invert(q))[..., :3]


def q_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def q_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = torch.unbind(q, dim=-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def q_from_uniforms(u: torch.Tensor) -> torch.Tensor:
    """Shoemake's uniform rotations from uniforms ``(..., 3)``."""
    u1, u2, u3 = torch.unbind(u, dim=-1)
    two_pi = 2.0 * math.pi
    return torch.stack([torch.sqrt(1.0 - u1) * torch.sin(two_pi * u2),
                        torch.sqrt(1.0 - u1) * torch.cos(two_pi * u2),
                        torch.sqrt(u1) * torch.sin(two_pi * u3),
                        torch.sqrt(u1) * torch.cos(two_pi * u3)], dim=-1)


def q_random(shape: tuple, generator, device) -> torch.Tensor:
    return q_from_uniforms(torch.rand(*shape, 3, generator=generator,
                                      device=device))


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    s: float = 0.0
    pixel_center: float = 0.0

    def params(self, pixel_center: float):
        return (self.fx, self.fy, self.cx - self.pixel_center + pixel_center,
                self.cy - self.pixel_center + pixel_center)

    def strided(self, factor: int) -> "Camera":
        pc = self.pixel_center
        return dataclasses.replace(
            self, width=self.width // factor, height=self.height // factor,
            fx=self.fx / factor, fy=self.fy / factor,
            cx=(self.cx - pc) / factor + pc, cy=(self.cy - pc) / factor + pc)


def pixel_directions(camera: Camera) -> np.ndarray:
    """Unit ray directions ``(H, W, 3)`` at pixel centres (OpenGL: -z
    forward, y up), in float64 rounded once to float32."""
    fx, fy, cx, cy = camera.params(0.5)
    rows, cols = np.mgrid[0:camera.height, 0:camera.width].astype(np.float64)
    dx = (cols + 0.5 - cx) / fx
    dy = -(rows + 0.5 - cy) / fy
    inv = 1.0 / np.sqrt(dx * dx + dy * dy + 1.0)
    return np.stack([dx * inv, dy * inv, -inv], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# tile order
# ---------------------------------------------------------------------------


def tile_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(H, W, ...)`` -> ``(H*W, ...)`` in 16x16 tile-major order."""
    trailing = x.shape[2:]
    x = x.reshape(h // TILE, TILE, w // TILE, TILE, *trailing)
    return x.transpose(1, 2).reshape(-1, *trailing)


def tiled(h: int, w: int) -> bool:
    return h % TILE == 0 and w % TILE == 0


def to_query_order(x: torch.Tensor) -> torch.Tensor:
    """Rasters ``(..., H, W)`` flat in the surrogate's query order."""
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    if tiled(h, w):
        x = x.reshape(*lead, h // TILE, TILE, w // TILE, TILE).transpose(
            -3, -2)
    return x.reshape(*lead, h * w)


# ---------------------------------------------------------------------------
# trilinear sampling on [-1, 1]^3, extrapolating
# ---------------------------------------------------------------------------


def base_and_frac(points: torch.Tensor, res: int):
    grid_size = 2.0 / (res - 1)
    c = torch.floor((points + 1.0) * (res - 1) * 0.5)
    inside = torch.logical_and(torch.amin(c, dim=-1) >= 0,
                               torch.amax(c, dim=-1) <= res - 2)
    base = torch.clamp(c, 0, res - 2)
    origin = base * grid_size - 1.0
    # a tensor divisor: a true division (a Python number would multiply by
    # its reciprocal on CUDA)
    frac = (points - origin) / torch.tensor(grid_size, dtype=points.dtype,
                                            device=points.device)
    return base.long(), frac, inside


def _corner_offsets(res: int, device) -> torch.Tensor:
    return torch.tensor([[[0, 1], [res, res + 1]],
                         [[res * res, res * res + 1],
                          [res * res + res, res * res + res + 1]]],
                        dtype=torch.long, device=device)


def _flat_base(base: torch.Tensor, res: int) -> torch.Tensor:
    return (base[..., 0] * res + base[..., 1]) * res + base[..., 2]


def _corners(sdf: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    res = sdf.shape[-1]
    idx = _flat_base(base, res)[..., None, None, None] + _corner_offsets(
        res, sdf.device)
    return sdf.reshape(-1)[idx]


def _lerp(c: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c0 = c[..., 0, :, :] * (1 - fx)[..., None, None] + c[..., 1, :, :] * fx[
        ..., None, None]
    c00 = c0[..., 0, :] * (1 - fy)[..., None] + c0[..., 1, :] * fy[..., None]
    return c00[..., 0] * (1 - fz) + c00[..., 1] * fz


def sample(sdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinear values ``(...,)`` of one grid ``(R, R, R)`` at points
    ``(..., 3)``, extrapolating outside the volume."""
    base, frac, _ = base_and_frac(points, sdf.shape[-1])
    return _lerp(_corners(sdf, base), frac)


def sample_value_and_grad(sdf: torch.Tensor, points: torch.Tensor):
    """Value ``(N,)`` and its gradient ``(N, 3)`` in the point, closed
    form."""
    res = sdf.shape[-1]
    base, frac, _ = base_and_frac(points, res)
    c = _corners(sdf, base)
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1 - fx, fx], dim=-1)
    wy = torch.stack([1 - fy, fy], dim=-1)
    wz = torch.stack([1 - fz, fz], dim=-1)
    c0 = (c * wx[..., :, None, None]).sum(-3)
    c00 = (c0 * wy[..., :, None]).sum(-2)
    value = (c00 * wz).sum(-1)
    inv_cell = (res - 1) * 0.5
    dx = ((c[..., 1, :, :] - c[..., 0, :, :]) * wy[..., :, None]
          * wz[..., None, :]).sum((-2, -1))
    dy = ((c0[..., 1, :] - c0[..., 0, :]) * wz).sum(-1)
    dz = c00[..., 1] - c00[..., 0]
    return value, torch.stack([dx, dy, dz], dim=-1) * inv_cell


def trilinear_weights(points: torch.Tensor, res: int):
    """Corner indices ``(N, 8)`` and weights ``(N, 8)`` (``dx*4+dy*2+dz``)."""
    base, frac, _ = base_and_frac(points, res)
    idx = _flat_base(base, res)[:, None] + _corner_offsets(
        res, points.device).reshape(1, 8)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    wx = torch.cat([1 - fx, fx], dim=1)
    wy = torch.cat([1 - fy, fy], dim=1)
    wz = torch.cat([1 - fz, fz], dim=1)
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return idx, w.reshape(-1, 8)


def masked_sample_grad(sdf, points, mask):
    """Masked value and point gradient of each hypothesis's rows: grids
    ``(B, R, R, R)``, rows ``(B, N, 3)``, mask ``(B, N)``."""
    vals, grads = [], []
    for b in range(sdf.shape[0]):
        v, g = sample_value_and_grad(sdf[b], points[b])
        keep = mask[b] != 0
        vals.append(torch.where(keep, v * mask[b], torch.zeros_like(v)))
        grads.append(torch.where(keep[:, None], g * mask[b][:, None],
                                 torch.zeros_like(g)))
    return torch.stack(vals), torch.stack(grads)


def masked_sample(sdf, points, mask):
    out = []
    for b in range(sdf.shape[0]):
        v = sample(sdf[b], points[b])
        out.append(torch.where(mask[b] != 0, v * mask[b],
                               torch.zeros_like(v)))
    return torch.stack(out)


def scatter(points, cotangents, res):
    """The grid gradient of sampling: each row's 8 corner weights times its
    cotangent, added into ``(B, R, R, R)``.  Each cell adds its
    contributions ``((wx * wy) * wz) * cot`` one after another in increasing
    row index: the contributions are made on the grid's device and added on
    the CPU, whose ``index_add_`` adds serially (on the card it would add
    with atomics in no fixed order)."""
    out = []
    for b in range(points.shape[0]):
        idx, w = trilinear_weights(points[b], res)
        contrib = (w * cotangents[b][:, None]).reshape(-1).cpu()
        g = torch.zeros(res ** 3, dtype=contrib.dtype)
        g.index_add_(0, idx.reshape(-1).to(torch.int32).cpu(), contrib)
        out.append(g.reshape(res, res, res))
    return torch.stack(out).to(points.device)


class SampleOp(torch.autograd.Function):
    """Masked extrapolating samples of grids ``(B, R, R, R)`` at rows
    ``(B, N, 3)``: values forward; the scatter into the grid and the
    point gradient backward."""

    @staticmethod
    def forward(ctx, sdf, points, mask):
        value, grad = masked_sample_grad(sdf, points, mask)
        ctx.save_for_backward(points, mask, grad)
        ctx.res = sdf.shape[-1]
        return value

    @staticmethod
    def backward(ctx, cot):
        points, mask, grad = ctx.saved_tensors
        g_sdf = g_pts = None
        if ctx.needs_input_grad[0]:
            g_sdf = scatter(points, cot * mask, ctx.res)
        if ctx.needs_input_grad[1]:
            g_pts = grad * cot[..., None]
        return g_sdf, g_pts, None


def sample_masked(sdf, points, mask):
    mask = mask.detach().to(torch.float32)
    if torch.is_grad_enabled() and (sdf.requires_grad
                                    or points.requires_grad):
        return SampleOp.apply(sdf, points, mask)
    return masked_sample(sdf, points, mask)


# ---------------------------------------------------------------------------
# depth lifting
# ---------------------------------------------------------------------------


def lift(depth: torch.Tensor, camera: Camera, order: str = "raster",
         pixel_offset: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points ``(..., H*W, 3)`` (OpenGL) and validity of depth ``(..., H,
    W)``; ``order="tile"`` puts one image's rows in 16x16 tile order."""
    fx, fy, cx, cy = camera.params(0.0)
    h, w = depth.shape[-2:]
    lead = depth.shape[:-2]
    dev = depth.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    if pixel_offset is not None:
        rows = rows + pixel_offset[0].to(torch.float32)
        cols = cols + pixel_offset[1].to(torch.float32)
    rows, cols = rows.expand(h, w), cols.expand(h, w)
    z = depth.to(torch.float32)
    x = (cols - cx) * z / fx
    y = -(rows - cy) * z / fy
    valid = depth != 0
    points = torch.stack([x, y, -z], dim=-1)
    if order == "tile" and not lead and tiled(h, w):
        return (tile_image(points, h, w),
                tile_image(valid[..., None], h, w).reshape(h * w))
    return points.reshape(*lead, h * w, 3), valid.reshape(*lead, h * w)


def normalize_masked(points: torch.Tensor, mask: torch.Tensor):
    w = mask.to(points.dtype)[..., None]
    denom = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    centroids = torch.sum(points * w, dim=-2, keepdim=True) / denom
    return points - centroids, centroids.squeeze(-2)


def subsample(points: torch.Tensor, mask: torch.Tensor, u: torch.Tensor):
    """Rows of ``points (M, 3)`` picked by inverse CDF over the valid rows
    with uniforms ``u (P,)``."""
    m = points.shape[-2]
    cnt = torch.cumsum(mask.to(torch.int64), dim=-1)
    n_valid = cnt[..., -1:]
    ranks = torch.floor(u * n_valid).to(torch.int64) + 1
    idx = torch.clamp(torch.searchsorted(cnt, ranks, side="left"), 0, m - 1)
    return torch.gather(points, -2, idx[..., None].expand(*idx.shape, 3))


# ---------------------------------------------------------------------------
# the decoder's resize
# ---------------------------------------------------------------------------


def _resize_matrix(n: int, m: int, device, dtype) -> torch.Tensor:
    """The ``(m, n)`` matrix of a half-pixel linear resize along one axis."""
    npd = np.float64 if dtype == torch.float64 else np.float32
    one, half = npd(1), npd(0.5)
    scale = npd(n) / npd(m)
    src = scale * (np.arange(m).astype(npd) + half) - half
    src = np.where(src < 0, npd(0), src).astype(npd)
    i0 = src.astype(np.int64)
    l1 = (src - i0.astype(npd)).astype(npd)
    mat = np.zeros((m, n), npd)
    rows = np.arange(m)
    np.add.at(mat, (rows, i0), one - l1)
    np.add.at(mat, (rows, np.minimum(i0 + 1, n - 1)), l1)
    return torch.from_numpy(mat).to(device)


class Resize(torch.autograd.Function):
    """Trilinear half-pixel upsampling; its adjoint as three products with
    the transposed per-axis matrices (a fixed summation order)."""

    @staticmethod
    def forward(ctx, volume, out_size):
        ctx.n = volume.shape[-1]
        return F.interpolate(volume, size=(out_size,) * 3, mode="trilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        n, lead, m = ctx.n, grad.shape[:2], grad.shape[-1]
        mat_t = _resize_matrix(n, m, grad.device, grad.dtype).t()
        out = grad
        for _ in range(3):
            out = torch.mm(mat_t, out.reshape(-1, m).t())
        return out.reshape(n, n, n, -1).permute(3, 0, 1, 2).reshape(
            *lead, n, n, n), None
