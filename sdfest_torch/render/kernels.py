"""The five CUDA kernels of the port, their plain PyTorch twins and launch
counts.

Each wrapper takes its plain version for tensors on the CPU, and for CUDA
tensors launches the hand-written kernel from ``sdfest_torch/csrc/`` or
raises: there is no fallback.  ``<wrapper>.launches`` counts the kernel's
launches (a plain integer, reset by assigning 0).  A wrapper called while a
CUDA graph captures counts its launch once, at capture; the graph cache
(:mod:`sdfest_torch.utils.graphs`) adds a graph's counts on every replay
(:func:`add_counts`).

| wrapper         | CUDA source             | replaces (pallas_kernel.py)    |
|-----------------|-------------------------|--------------------------------|
| ``march``       | ``csrc/march.cu``       | ``render_depth_pallas_fwd``    |
|                 |                         | (:1607): v2, plain, relaxed,   |
|                 |                         | ROI and bf16-verified          |
|                 |                         | (:1296, :1445) branches        |
| ``march_warm``  | ``csrc/march.cu``       | the same, warm/aux branch      |
|                 |                         | (:657) and its bf16 branch     |
|                 |                         | (:777)                         |
| ``sample``      | ``csrc/sample.cu``      | ``sample_sdf_pallas`` (:2104)  |
| ``sample_grad`` | ``csrc/sample_grad.cu`` | ``sample_sdf_grad_pallas``     |
|                 |                         | (:2168)                        |
| ``scatter``     | ``csrc/scatter.cu``     | ``scatter_sdf_grad_pallas``    |
|                 |                         | (:2304)                        |

Every branch of the TPU kernels has its counterpart.  The bf16 branches are
template instances of the march kernels; ``march.bf16_launches`` and
``march_warm.bf16_launches`` count their launches.

Hypotheses.  Every wrapper takes a leading hypothesis dim ``B`` on its
per-hypothesis operands (grid ``(B, R, R, R)``, pose ``(B, 14)``, rows
``(B, N, 3)``/``(B, N)``, warm inputs ``(B, ...)``) and serves all of them
with ONE launch of its kernel (the hypothesis is ``blockIdx.z``); the rays
of a march are shared.  An unbatched call is the launch with one
hypothesis.  ``<wrapper>.launches`` counts launches, and
``<wrapper>.hypotheses`` the hypotheses they served (so
``hypotheses / launches`` is the batch per launch).  On the CPU a batched
call runs the plain version once per hypothesis.

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
from sdfest_torch.render.plain import (
    NC,
    coarse_min_table,
    coarse_pair_table,
    march_plain,
    march_warm_plain,
    per_hypothesis,
)

TILE = 16  # pixel tile edge of the tile-major query order

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# wrapper -> (library, C entry, argument types)
_SIGNATURES = {
    "march": ("march", "sdfest_march",
              [_P] * 6 + [_I] * 5 + [_F, _I, _I, _I, _F, _I, _P]),
    "march_warm": ("march", "sdfest_march_warm",
                   [_P] * 13 + [_I] * 5 + [_F, _I, _I, _P]),
    "sample": ("sample", "sdfest_sample", [_P] * 4 + [_I] * 3 + [_P]),
    "sample_grad": ("sample_grad", "sdfest_sample_grad",
                    [_P] * 5 + [_I] * 3 + [_P]),
    "scatter": ("scatter", "sdfest_scatter", [_P] * 4 + [_I] * 3 + [_P]),
}
_FUNCS = {}


def _function(name: str):
    fn = _FUNCS.get(name)
    if fn is None:
        library, symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.library(library), symbol)
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


def _check_grid(sdf: torch.Tensor) -> Tuple[int, tuple]:
    """``(res, lead)`` of a grid ``(R, R, R)`` (``lead = ()``) or a batch of
    hypotheses' grids ``(B, R, R, R)`` (``lead = (B,)``)."""
    res = sdf.shape[-1]
    lead = tuple(sdf.shape[:-3])
    if sdf.ndim not in (3, 4) or sdf.shape[-3:] != (res, res, res):
        raise ValueError("expected a cubic grid (R, R, R) or a batch of "
                         f"them (B, R, R, R), got {tuple(sdf.shape)}")
    return res, lead


def _batch(lead: tuple) -> int:
    return lead[0] if lead else 1


def _check_points(lead: tuple, points: torch.Tensor, *rows: torch.Tensor
                  ) -> int:
    n = points.shape[-2] if points.ndim >= 2 else -1
    if points.shape != (*lead, n, 3) or any(r.shape != (*lead, n)
                                           for r in rows):
        raise ValueError(f"expected points {(*lead, 'N', 3)} with "
                         f"{(*lead, 'N')} companions")
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
    scale]`` of a pose, or ``(B, 14)`` of hypotheses' poses ``(B, 3)``,
    ``(B, 4)``, ``(B,)``, computed on the pose's device (no host round
    trip).  ``origin_o = R^T (-position)`` is written out elementwise, so a
    hypothesis's row does not depend on the batch around it."""
    lead = position.shape[:-1]
    rot = quaternion.to_rotation_matrix(orientation)
    p = -position
    origin_o = (rot[..., 0, :] * p[..., 0:1] + rot[..., 1, :] * p[..., 1:2]
                + rot[..., 2, :] * p[..., 2:3])
    inv_scale = inv_scale.reshape(*lead, 1)
    return torch.cat(
        [rot.reshape(*lead, 9), origin_o, inv_scale, 1.0 / inv_scale], dim=-1
    ).to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# march
# ---------------------------------------------------------------------------


def _rays(dirs: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
    if dirs.ndim < 2 or dirs.shape[-1] != 3:
        raise ValueError("expected ray directions (..., 3)")
    return tuple(dirs.shape[:-1]), dirs.reshape(-1, 3)


def march_geometry(raster: tuple, tiles: bool = True
                   ) -> Tuple[int, int, Tuple[int, ...]]:
    """The march kernel's launch over rays of leading shape ``raster``:
    ``(h, w, blocks)``.

    With ``tiles`` (a culling march), a raster ``(..., H, W)`` is the image
    ``(h, w) = (prod(...) * H, W)``, and each block is one ``TILE x TILE``
    tile of it, ``blocks = (ceil(w / TILE), ceil(h / TILE))``, the ragged
    edge masked in the kernel.  A flat ``(N,)`` ray set, or any set without
    ``tiles``, has ``h = 0, w = N`` and 1-D blocks of ``TILE * TILE``
    consecutive rays: without a table to skip, tiles only cost time (the
    plain march, PERF.md section 6)."""
    n = 1
    for d in raster:
        n *= int(d)
    if len(raster) == 1 or not tiles:
        return 0, n, (-(-n // (TILE * TILE)),)
    w = int(raster[-1])
    h = n // w if w else 0
    return h, w, (-(-w // TILE), -(-h // TILE))


def _check_pose(pose: torch.Tensor, lead: tuple) -> None:
    if pose.shape != (*lead, 14):
        raise ValueError("pose must be [rot (9), origin_o (3), inv_s, s], "
                         "one per hypothesis of the grid")


def _coarse_for(sdf: torch.Tensor, coarse: Optional[torch.Tensor],
                bf16: bool = False) -> torch.Tensor:
    """The march's coarse table: :func:`coarse_min_table`, or with ``bf16``
    :func:`coarse_pair_table` (built here when not given), one per
    hypothesis of the grid.  Every hypothesis's table must be 16-byte
    aligned, the source of the kernel's TMA copy: a contiguous batch of
    16 KiB (32 KiB) tables on an aligned base is."""
    if coarse is None:
        coarse = coarse_pair_table(sdf) if bf16 else coarse_min_table(sdf)
    shape = (*sdf.shape[:-3], NC, NC, NC, *((2,) if bf16 else ()))
    if (coarse.shape != shape or not coarse.is_contiguous()
            or coarse.device != sdf.device):
        raise ValueError(f"coarse table must be a contiguous {shape} tensor "
                         "on the grid's device")
    if coarse.data_ptr() % 16:
        raise ValueError("the coarse table must be 16-byte aligned")
    return coarse


def _bf16_grid(sdf: torch.Tensor, sdf_bf16: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """The bf16 copy of the grid (rounded to nearest even, as
    ``__float2bfloat16_rn``), made here when not given."""
    if sdf_bf16 is None:
        return sdf.to(torch.bfloat16)
    if (sdf_bf16.dtype != torch.bfloat16 or sdf_bf16.shape != sdf.shape
            or not sdf_bf16.is_contiguous() or sdf_bf16.device != sdf.device):
        raise ValueError("sdf_bf16 must be a contiguous bfloat16 copy of the "
                         "grid on its device")
    return sdf_bf16


def march(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    threshold: float,
    max_steps: int,
    culling: bool = True,
    adaptive: bool = True,
    coarse: Optional[torch.Tensor] = None,
    relaxation: float = 1.0,
    bf16: bool = False,
    sdf_bf16: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sphere-trace the depth of rays ``dirs (..., 3)``, shaped like their
    leading dims (``csrc/march.cu``; plain version
    :func:`sdfest_torch.render.plain.march_plain`).

    The rays are any set: a full frame ``(H, W, 3)`` or the crop of an ROI
    render (:func:`sdfest_torch.render.api.ray_set`); each ray depends on
    nothing but its own direction, so an ROI render equals the crop of the
    full render bit for bit.  A culling march over a raster launches one
    block per 16x16 tile (:func:`march_geometry`), and a tile copies the
    coarse table into shared memory only when one of its rays meets the
    box; a march without culling, or over a flat ``(N, 3)`` set, launches
    1-D blocks of 256 rays.
    ``relaxation > 1`` selects the relaxed march (``adaptive`` is then
    ignored).  ``bf16`` gates the fine steps with a
    bf16 sample; as in the JAX package it acts only with culling and there
    turns ``adaptive`` off, so bf16 without culling is the fp32 march.
    ``march.rasters`` counts the launches per leading shape of ``dirs``,
    ``march.bf16_launches`` those of the bf16 instances (included in
    ``march.launches``).  ``coarse`` may pass the precomputed table of
    :func:`_coarse_for` and ``sdf_bf16`` the bf16 grid (built here when
    needed and not given).

    Hypotheses: a grid ``(B, R, R, R)`` with poses ``(B, 14)`` marches the
    shared rays once per hypothesis in ONE launch and gives ``(B, ...)``
    (``coarse`` and ``sdf_bf16`` then also per hypothesis)."""
    res, lead = _check_grid(sdf)
    raster, flat = _rays(dirs)
    _check_pose(pose, lead)
    bf16 = bool(bf16 and culling)
    if _on_cpu(sdf, dirs, pose):
        return march_plain(sdf, flat, pose, threshold, max_steps, culling,
                           adaptive, relaxation=relaxation,
                           bf16=bf16).reshape(*lead, *raster)
    if culling:
        coarse = _coarse_for(sdf, coarse, bf16)
    grid_b = _bf16_grid(sdf, sdf_bf16) if bf16 else None
    depth = torch.empty((*lead, *raster), dtype=torch.float32,
                        device=sdf.device)
    n = flat.shape[0]
    h, w, blocks = march_geometry(raster, tiles=bool(culling))
    _check_launch(raster, n, h, blocks, lead)
    if n:
        _launch(
            "march", sdf.device, sdf.data_ptr(),
            grid_b.data_ptr() if bf16 else None,
            coarse.data_ptr() if culling else None, flat.data_ptr(),
            pose.data_ptr(), depth.data_ptr(), n, h, w, _batch(lead), res,
            float(threshold), int(max_steps), int(bool(culling)),
            int(bool(adaptive) and not bf16), float(relaxation), int(bf16),
        )
        _count(march, lead)
        march.bf16_launches += bf16
        march.rasters[raster] = march.rasters.get(raster, 0) + 1
    return depth


def _check_launch(raster: tuple, n: int, h: int, blocks: tuple,
                  lead: tuple) -> None:
    if (n >= 2 ** 31 or (h and blocks[1] > 65535)
            or _batch(lead) > 65535 or _batch(lead) * n >= 2 ** 31):
        raise ValueError(f"too many rays for one launch: {lead} x {raster}")


def _count(wrapper, lead: tuple) -> None:
    """One launch of ``wrapper``'s kernel, serving the hypotheses of
    ``lead``."""
    wrapper.launches += 1
    wrapper.hypotheses += _batch(lead)


march.launches = march.hypotheses = 0
march.bf16_launches = 0
march.rasters = {}


def march_warm(
    sdf: torch.Tensor,
    dirs: torch.Tensor,
    pose: torch.Tensor,
    t_init: torch.Tensor,
    skip: torch.Tensor,
    threshold: float,
    max_steps: int,
    coarse: Optional[torch.Tensor] = None,
    bf16: bool = False,
    sdf_bf16: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The warm/aux corridor march of rays ``dirs (..., 3)`` with per-ray
    ``t_init`` and ``skip`` shaped like the rays' leading dims
    (``march_warm_kernel`` in ``csrc/march.cu``; plain version
    :func:`sdfest_torch.render.plain.march_warm_plain`).

    Returns ``(depth, t, v0, min_dip, v_last, t_last)``, each shaped like
    ``t_init``.  The launch is the culling march's
    (:func:`march_geometry`): a raster in 16x16 tiles, of which only those
    with a marching ray (hit, start before the exit, not skipped) copy the
    coarse table; a flat ``(N, 3)`` set in 1-D blocks.  ``bf16`` gates the
    fine steps with a bf16 sample (the
    branch of ``render_depth_pallas_fwd(aux=True, bf16=True)``; no pipeline
    path takes it, as the JAX package's ``render_depth_warm`` passes no
    bf16); ``march_warm.bf16_launches`` counts its launches.  ``coarse``
    and ``sdf_bf16`` as in :func:`march`.  Hypotheses as in :func:`march`:
    a grid ``(B, R, R, R)``, poses ``(B, 14)`` and ``t_init``/``skip``
    ``(B, ...)`` give ``(B, ...)`` outputs from one launch."""
    res, lead = _check_grid(sdf)
    raster, flat = _rays(dirs)
    _check_pose(pose, lead)
    if t_init.shape != (*lead, *raster) or skip.shape != t_init.shape:
        raise ValueError("t_init and skip must be shaped like the rays, one "
                         "set per hypothesis")
    bf16 = bool(bf16)
    if _on_cpu(sdf, dirs, pose, t_init, skip):
        n = flat.shape[0]
        return tuple(x.reshape(*lead, *raster) for x in march_warm_plain(
            sdf, flat, pose, t_init.reshape(*lead, n),
            skip.reshape(*lead, n), threshold, max_steps, bf16=bf16))
    coarse = _coarse_for(sdf, coarse, bf16)
    grid_b = _bf16_grid(sdf, sdf_bf16) if bf16 else None
    outs = torch.empty((6, *lead, *raster), dtype=torch.float32,
                       device=sdf.device)
    n = flat.shape[0]
    h, w, blocks = march_geometry(raster)
    _check_launch(raster, n, h, blocks, lead)
    if _batch(lead) * res ** 3 >= 2 ** 31:  # the kernel's 32-bit cell index
        raise ValueError(f"too many grid values for one launch: {lead} x "
                         f"{res}^3")
    if n:
        _launch(
            "march_warm", sdf.device, sdf.data_ptr(),
            grid_b.data_ptr() if bf16 else None, coarse.data_ptr(),
            flat.data_ptr(), pose.data_ptr(), t_init.data_ptr(),
            skip.data_ptr(), *(o.data_ptr() for o in outs), n, h, w,
            _batch(lead), res, float(threshold), int(max_steps), int(bf16),
        )
        _count(march_warm, lead)
        march_warm.bf16_launches += bf16
    return tuple(outs)


march_warm.launches = march_warm.hypotheses = 0
march_warm.bf16_launches = 0


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def sample_plain(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked extrapolating trilinear values; masked rows give 0.  A grid
    ``(B, R, R, R)`` with rows ``(B, N, 3)``/``(B, N)``: each hypothesis
    alone."""
    if sdf.ndim == 4:
        return per_hypothesis(sdf.shape[0], lambda b: sample_plain(
            sdf[b], points[b], mask[b]))
    value = sample_sdf(sdf, points)
    return torch.where(mask != 0, value * mask, torch.zeros_like(value))


def sample_blocks(n: int) -> int:
    """The sample kernel's launch over ``n`` rows: one thread per row,
    thread ``k`` of block ``b`` on row ``b * TILE * TILE + k``, in this
    many blocks of ``TILE * TILE`` threads."""
    return -(-n // (TILE * TILE))


def sample(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Values ``(N,)`` at points ``(N, 3)`` times ``mask (N,)``
    (``csrc/sample.cu``; plain version :func:`sample_plain`).  On CUDA one
    thread per row (:func:`sample_blocks`) loads its point and its mask
    together.  A grid ``(B, R, R, R)`` with rows ``(B, N, 3)``/``(B, N)``
    gives ``(B, N)`` from one launch."""
    res, lead = _check_grid(sdf)
    n = _check_points(lead, points, mask)
    if _on_cpu(sdf, points, mask):
        return sample_plain(sdf, points, mask)
    _check_rows(n, 3, lead)
    out = torch.empty((*lead, n), dtype=torch.float32, device=sdf.device)
    if n:
        _launch("sample", sdf.device, sdf.data_ptr(), points.data_ptr(),
                mask.data_ptr(), out.data_ptr(), n, _batch(lead), res)
        _count(sample, lead)
    return out


def _check_rows(n: int, width: int, lead: tuple) -> None:
    if width * n >= 2 ** 31 or _batch(lead) > 65535:
        raise ValueError(f"too many rows for one launch: {lead} x {n}")


sample.launches = sample.hypotheses = 0


def sample_grad_plain(
    sdf: torch.Tensor, points: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked value and gradient w.r.t. the normalized point (batched as
    :func:`sample_plain`)."""
    if sdf.ndim == 4:
        return per_hypothesis(sdf.shape[0], lambda b: sample_grad_plain(
            sdf[b], points[b], mask[b]))
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
    once (``csrc/sample_grad.cu``; plain version :func:`sample_grad_plain`).
    Batched as :func:`sample`: ``(B, N)`` and ``(B, N, 3)`` from one
    launch."""
    res, lead = _check_grid(sdf)
    n = _check_points(lead, points, mask)
    if _on_cpu(sdf, points, mask):
        return sample_grad_plain(sdf, points, mask)
    _check_rows(n, 3, lead)
    value = torch.empty((*lead, n), dtype=torch.float32, device=sdf.device)
    grad = torch.empty((*lead, n, 3), dtype=torch.float32, device=sdf.device)
    if n:
        _launch("sample_grad", sdf.device, sdf.data_ptr(), points.data_ptr(),
                mask.data_ptr(), value.data_ptr(), grad.data_ptr(), n,
                _batch(lead), res)
        _count(sample_grad, lead)
    return value, grad


sample_grad.launches = sample_grad.hypotheses = 0


# ---------------------------------------------------------------------------
# scatter
# ---------------------------------------------------------------------------


def scatter_plain(
    points: torch.Tensor, cotangents: torch.Tensor, res: int
) -> torch.Tensor:
    """Gradient of sampling w.r.t. the grid: corner weights x cotangent
    (rows ``(B, N, 3)``/``(B, N)``: one grid per hypothesis).  Each
    contribution is ``((wx * wy) * wz) * cot``, and a cell adds its
    contributions in increasing row index (``index_add_`` on the CPU adds
    serially): the order the kernel keeps."""
    if points.ndim == 3:
        return per_hypothesis(points.shape[0], lambda b: scatter_plain(
            points[b], cotangents[b], res))
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
    :func:`scatter_plain`).  On CUDA the rows with a nonzero cotangent are
    bucketed by base cell and sorted by row index, and one thread per cell
    adds its contributions in increasing row index, without float atomics:
    the grid equals :func:`scatter_plain` on CPU copies of the inputs bit
    for bit, run after run.  Rows ``(B, N, 3)``/``(B, N)`` give ``(B, res,
    res, res)`` from one call (one count); each hypothesis's grid is the
    one its rows give alone."""
    lead = tuple(points.shape[:-2])
    if len(lead) > 1:
        raise ValueError("expected points (N, 3) or (B, N, 3)")
    n = _check_points(lead, points, cotangents)
    if _on_cpu(points, cotangents):
        return scatter_plain(points, cotangents, res)
    _check_rows(n, 1, lead)
    if not n:
        return torch.zeros((*lead, res, res, res), dtype=torch.float32,
                           device=points.device)
    grad = torch.empty((*lead, res, res, res), dtype=torch.float32,
                       device=points.device)
    # the sorted rows' float4s, counts, totals, starts, arrivals and the
    # row list (csrc/scatter.cu)
    batch = _batch(lead)
    scratch = torch.empty(batch * (2 * res ** 3 + 6 * n + 1),
                          dtype=torch.int32, device=points.device)
    _launch("scatter", points.device, points.data_ptr(),
            cotangents.data_ptr(), grad.data_ptr(), scratch.data_ptr(), n,
            batch, res)
    _count(scatter, lead)
    return grad


scatter.launches = scatter.hypotheses = 0

KERNELS = {"march": march, "march_warm": march_warm, "sample": sample,
           "sample_grad": sample_grad, "scatter": scatter}


def reset_launches() -> None:
    """Set every kernel's launch and hypothesis counts to 0 (and the
    marches' counts of bf16 launches and the march's launch count per
    raster)."""
    for fn in KERNELS.values():
        fn.launches = fn.hypotheses = 0
    march.bf16_launches = march_warm.bf16_launches = 0
    march.rasters = {}


def launches() -> dict:
    """Current launch count of every kernel."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def hypotheses() -> dict:
    """Hypotheses served by every kernel's launches since the reset."""
    return {name: fn.hypotheses for name, fn in KERNELS.items()}


def counts() -> dict:
    """Every count the wrappers keep: launches and hypotheses per kernel,
    the marches' bf16 launches and the march's launches per raster."""
    m, w = KERNELS["march"], KERNELS["march_warm"]
    return {
        "launches": launches(), "hypotheses": hypotheses(),
        "bf16_launches": {"march": m.bf16_launches,
                          "march_warm": w.bf16_launches},
        "rasters": dict(m.rasters)}


def set_counts(state: dict) -> None:
    """Set every count to ``state`` (a :func:`counts`)."""
    for name, fn in KERNELS.items():
        fn.launches = state["launches"][name]
        fn.hypotheses = state["hypotheses"][name]
        if name in state["bf16_launches"]:
            fn.bf16_launches = state["bf16_launches"][name]
    KERNELS["march"].rasters = dict(state["rasters"])


def count_difference(after: dict, before: dict) -> dict:
    """The counts made between two :func:`counts` (the launches of a
    captured graph, :mod:`sdfest_torch.utils.graphs`)."""
    out = {k: {n: after[k][n] - before[k].get(n, 0) for n in after[k]}
           for k in after}
    out["rasters"] = {r: c for r, c in out["rasters"].items() if c}
    return out


def add_counts(delta: dict) -> None:
    """Add a :func:`count_difference` to the counts: one replay of a
    captured graph launches every kernel its capture launched."""
    for name, fn in KERNELS.items():
        fn.launches += delta["launches"][name]
        fn.hypotheses += delta["hypotheses"][name]
        if name in delta["bf16_launches"]:
            fn.bf16_launches += delta["bf16_launches"][name]
    rasters = KERNELS["march"].rasters
    for raster, c in delta["rasters"].items():
        rasters[raster] = rasters.get(raster, 0) + c
