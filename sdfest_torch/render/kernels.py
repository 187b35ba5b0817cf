"""The four CUDA kernels of the port, their plain PyTorch twins and launch
counts.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches the hand-written kernel from ``sdfest_torch/csrc/`` or
raises: there is no fallback.  ``<wrapper>.launches`` counts the kernel's
launches (a plain integer, reset by assigning 0).

| wrapper       | CUDA source          | replaces (pallas_kernel.py)              |
|---------------|----------------------|------------------------------------------|
| ``march``       | ``csrc/march.cu``       | ``render_depth_pallas_fwd`` (:1607)       |
| ``sample``      | ``csrc/sample.cu``      | ``sample_sdf_pallas`` (:2104)             |
| ``sample_grad`` | ``csrc/sample_grad.cu`` | ``sample_sdf_grad_pallas`` (:2168)        |
| ``scatter``     | ``csrc/scatter.cu``     | ``scatter_sdf_grad_pallas`` (:2304)       |

What bounds each kernel on the H100 and what its design does about it is
noted at the top of its source.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.interpolation import (
    sample_sdf,
    sample_sdf_value_and_grad,
    trilinear_weights,
)
from sdfest_torch.render import _build
from sdfest_torch.render.plain import NC, coarse_min_table, march_plain

TILE = 16  # pixel tile edge of the tile-major query order

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "march": ("sdfest_march", [_P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P]),
    "sample": ("sdfest_sample", [_P, _P, _P, _P, _I, _I, _P]),
    "sample_grad": ("sdfest_sample_grad", [_P, _P, _P, _P, _P, _I, _I, _P]),
    "scatter": ("sdfest_scatter", [_P, _P, _P, _I, _I, _P]),
}
_FUNCS = {}


def _function(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (take the plain version)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "CUDA kernels take contiguous float32 tensors, got "
                f"{t.dtype} contiguous={t.is_contiguous()}"
            )
    return False


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _function(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")


def _check_grid(sdf: torch.Tensor) -> int:
    res = sdf.shape[0]
    if sdf.shape != (res, res, res):
        raise ValueError(f"expected a cubic grid, got {tuple(sdf.shape)}")
    return res


def _check_points(points: torch.Tensor, *rows: torch.Tensor) -> int:
    n = points.shape[0]
    if points.shape != (n, 3) or any(r.shape != (n,) for r in rows):
        raise ValueError("expected points (N, 3) with (N,) companions")
    return n


# ---------------------------------------------------------------------------
# tile order and pose
# ---------------------------------------------------------------------------


def tile_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(H, W, ...)`` -> ``(H*W, ...)`` in 16x16 tile-major order."""
    trailing = x.shape[2:]
    x = x.reshape(h // TILE, TILE, w // TILE, TILE, *trailing)
    return x.transpose(1, 2).reshape(-1, *trailing)


def untile_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`tile_image` for flat ``(H*W,)`` tensors."""
    x = x.reshape(h // TILE, w // TILE, TILE, TILE)
    return x.transpose(1, 2).reshape(h, w)


def pose_params(
    position: torch.Tensor, orientation: torch.Tensor, inv_scale: torch.Tensor
) -> torch.Tensor:
    """The march's pose operand ``[rot (9), origin_o (3), inv_scale,
    scale]``, computed on the pose's device (no host round trip)."""
    rot = quaternion.to_rotation_matrix(orientation)
    origin_o = rot.T @ (-position)
    inv_scale = inv_scale.reshape(1)
    return torch.cat(
        [rot.reshape(9), origin_o, inv_scale, 1.0 / inv_scale]
    ).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# march
# ---------------------------------------------------------------------------


def march(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    threshold: float,
    max_steps: int,
    culling: bool = True,
    adaptive: bool = True,
    coarse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sphere-trace the depth of rays ``dirs (..., 3)``, shaped like their
    leading dims (``csrc/march.cu``; plain version
    :func:`sdfest_torch.render.plain.march_plain`).

    The rays are any set: a full frame ``(H, W, 3)`` or the crop of an ROI
    render (:func:`sdfest_torch.render.api.ray_set`); each ray depends on
    nothing but its own direction, so an ROI render equals the crop of the
    full render bit for bit.  ``march.rasters`` counts the launches per
    leading shape of ``dirs``.  ``coarse`` may pass a precomputed
    :func:`coarse_min_table` of ``sdf`` (built here when culling and not
    given)."""
    res = _check_grid(sdf)
    if dirs.ndim < 2 or dirs.shape[-1] != 3:
        raise ValueError("expected ray directions (..., 3)")
    raster = tuple(dirs.shape[:-1])
    flat = dirs.reshape(-1, 3)
    n = flat.shape[0]
    if pose.shape != (14,):
        raise ValueError("pose must be [rot (9), origin_o (3), inv_s, s]")
    if _on_cpu(sdf, dirs, pose):
        return march_plain(sdf, flat, pose, threshold, max_steps, culling,
                           adaptive).reshape(raster)
    if culling and coarse is None:
        coarse = coarse_min_table(sdf)
    if culling and (coarse.shape != (NC, NC, NC) or not coarse.is_contiguous()
                    or coarse.device != sdf.device):
        raise ValueError("coarse table must be a contiguous (16, 16, 16) "
                         "tensor on the grid's device")
    depth = torch.empty(raster, dtype=torch.float32, device=sdf.device)
    if n:
        _launch(
            "march", sdf.device, sdf.data_ptr(),
            coarse.data_ptr() if culling else None, flat.data_ptr(),
            pose.data_ptr(), depth.data_ptr(), n, res, float(threshold),
            int(max_steps), int(bool(culling)), int(bool(adaptive)),
        )
        march.launches += 1
        march.rasters[raster] = march.rasters.get(raster, 0) + 1
    return depth


march.launches = 0
march.rasters = {}


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def sample_plain(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked extrapolating trilinear values; masked rows give 0."""
    value = sample_sdf(sdf, points)
    return torch.where(mask != 0, value * mask, torch.zeros_like(value))


def sample(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Values ``(N,)`` at points ``(N, 3)`` times ``mask (N,)``
    (``csrc/sample.cu``; plain version :func:`sample_plain`)."""
    res = _check_grid(sdf)
    n = _check_points(points, mask)
    if _on_cpu(sdf, points, mask):
        return sample_plain(sdf, points, mask)
    out = torch.empty(n, dtype=torch.float32, device=sdf.device)
    if n:
        _launch("sample", sdf.device, sdf.data_ptr(), points.data_ptr(),
                mask.data_ptr(), out.data_ptr(), n, res)
        sample.launches += 1
    return out


sample.launches = 0


def sample_grad_plain(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked value and gradient w.r.t. the normalized point."""
    value, grad = sample_sdf_value_and_grad(sdf, points)
    keep = mask != 0
    value = torch.where(keep, value * mask, torch.zeros_like(value))
    grad = torch.where(keep[:, None], grad * mask[:, None],
                       torch.zeros_like(grad))
    return value, grad


def sample_grad(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value ``(N,)`` and spatial gradient ``(N, 3)``, each times the mask
    once (``csrc/sample_grad.cu``; plain version :func:`sample_grad_plain`)."""
    res = _check_grid(sdf)
    n = _check_points(points, mask)
    if _on_cpu(sdf, points, mask):
        return sample_grad_plain(sdf, points, mask)
    value = torch.empty(n, dtype=torch.float32, device=sdf.device)
    grad = torch.empty((n, 3), dtype=torch.float32, device=sdf.device)
    if n:
        _launch("sample_grad", sdf.device, sdf.data_ptr(), points.data_ptr(),
                mask.data_ptr(), value.data_ptr(), grad.data_ptr(), n, res)
        sample_grad.launches += 1
    return value, grad


sample_grad.launches = 0


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------


def scatter_plain(
    points: torch.Tensor, cotangents: torch.Tensor, res: int
) -> torch.Tensor:
    """Gradient of sampling w.r.t. the grid: corner weights x cotangent."""
    idx, w = trilinear_weights(points, res)
    grad = torch.zeros(res ** 3, dtype=cotangents.dtype,
                       device=cotangents.device)
    grad.index_add_(0, idx.reshape(-1), (w * cotangents[:, None]).reshape(-1))
    return grad.reshape(res, res, res)


def scatter(
    points: torch.Tensor, cotangents: torch.Tensor, res: int
) -> torch.Tensor:
    """``(res, res, res)`` accumulation of each point's 8 corner weights
    times its cotangent (``csrc/scatter.cu``; plain version
    :func:`scatter_plain`).  On CUDA the sums use float atomics and are not
    deterministic in their last bits."""
    n = _check_points(points, cotangents)
    if _on_cpu(points, cotangents):
        return scatter_plain(points, cotangents, res)
    grad = torch.zeros((res, res, res), dtype=torch.float32,
                       device=points.device)
    if n:
        _launch("scatter", points.device, points.data_ptr(),
                cotangents.data_ptr(), grad.data_ptr(), n, res)
        scatter.launches += 1
    return grad


scatter.launches = 0

KERNELS = {"march": march, "sample": sample, "sample_grad": sample_grad,
           "scatter": scatter}


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (and clear the march's launch
    count per raster)."""
    for fn in KERNELS.values():
        fn.launches = 0
    march.rasters = {}


def launches() -> dict:
    """Current launch count of every kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}
