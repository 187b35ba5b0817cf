"""Temporal-coherence warm rendering for iterative refinement (counterpart
of ``sdfest_tpu/render/warm.py``).

Between two refinement iterations the scene changes by one optimizer step,
so the previous march is reused conservatively:

- previously-hit rays warm-start at ``t_prev - 1.5 * motion``, where
  ``motion`` (:func:`motion_bound`) bounds how far any surface point can
  have moved;
- previously-missed rays are skipped while the accumulated motion stays
  below their corridor clearance: the 1-Lipschitz lower bound of the field
  along their last full march (the corridor's minimum dip, and its entry
  and tail clearances against the growth of the box interval);
- every other ray marches again from the box entry and refreshes its
  corridor.

A periodic full refresh (``full_refresh`` every
``temporal_refresh_interval`` iterations) caps what the bound does not
cover.  Everything here is device tensor ops: no value is read on the
host.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from sdfest_torch.ops.camera import Camera
from sdfest_torch.render import kernels
from sdfest_torch.render.api import ray_set, render_depth_warm
from sdfest_torch.render.plain import ray_interval
from sdfest_torch.utils.device import resolve_device

WARM_VIEW_KEYS = ("t", "hit", "t0", "v0", "min_dip", "v_last", "t_last",
                  "macc")


def init_warm_views(n_views: int, height: int, width: int, device="cuda"
                    ) -> Dict[str, torch.Tensor]:
    """Zero-initialized per-view warm state (forces a full first march)."""
    device = resolve_device(device)
    return {k: torch.zeros((n_views, height, width), dtype=torch.float32,
                           device=device) for k in WARM_VIEW_KEYS}


def motion_bound(
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    sdf: torch.Tensor,
    prev: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Conservative bound of the surface's displacement since ``prev``.

    A point ``x = p + s R(q) u`` (``|u| <= sqrt(3)``) of the posed surface
    moves by at most ``|dp| + 2 sqrt(3) |ds| + 2 sqrt(3) s |dq|``; a change
    of the (1-Lipschitz) field moves its zero set by at most ``s
    max|dSDF|``.  ``orientation`` is normalized; no gradient flows.
    """
    with torch.no_grad():
        dp = torch.linalg.norm(position - prev["position"])
        # q and -q are the same rotation
        dq = torch.minimum(
            torch.linalg.norm(orientation - prev["orientation"]),
            torch.linalg.norm(orientation + prev["orientation"]),
        )
        ds = torch.abs(scale - prev["scale"])
        dsdf = torch.amax(torch.abs(sdf - prev["sdf"]))
        s_max = torch.maximum(scale, prev["scale"])
        sqrt3 = math.sqrt(3.0)
        return (dp + 2.0 * sqrt3 * ds + 2.0 * sqrt3 * s_max * dq
                + s_max * dsdf)


def warm_inputs(
    view_warm: Dict[str, torch.Tensor],
    rays: torch.Tensor,
    pose: torch.Tensor,
    motion: torch.Tensor,
    full_refresh: bool,
    threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(t_init, skip, macc)`` of the next warm march: per-ray warm start
    (``-1``: from the box entry) and skip flag of the rays ``(H, W, 3)`` at
    the new ``pose`` (:func:`sdfest_torch.render.kernels.pose_params`), and
    the motion accumulated since each ray last marched."""
    w = view_warm
    with torch.no_grad():
        _, t_min_new, t_max_new = (x.reshape(rays.shape[:2]) for x in
                                   ray_interval(rays.reshape(-1, 3), pose))
        macc_new = w["macc"] + motion
        if full_refresh:
            return (torch.full_like(macc_new, -1.0),
                    torch.zeros_like(macc_new), macc_new)
        clearance = torch.minimum(
            w["min_dip"],
            torch.minimum(
                w["v0"] - torch.clamp(w["t0"] - t_min_new, min=0.0),
                w["v_last"] - torch.clamp(t_max_new - w["t_last"], min=0.0),
            ),
        )
        can_skip = ((w["hit"] == 0.0) & (w["v0"] > 0.0)
                    & (macc_new + threshold * t_max_new + 1e-4 < clearance))
        t_init = torch.where(
            w["hit"] > 0.0,
            torch.clamp(w["t"] - 1.5 * motion - 1e-4, min=0.0),
            torch.full_like(macc_new, -1.0),
        )
        return t_init, can_skip.to(torch.float32), macc_new


def warm_render_step(
    sdf: torch.Tensor,
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    view_warm: Dict[str, torch.Tensor],
    motion: torch.Tensor,
    full_refresh: bool,
    camera: Camera,
    threshold: float,
    max_steps: int = 500,
    device="cuda",
):
    """One temporally-coherent render; returns ``(depth, new warm state)``.

    ``view_warm`` holds the :data:`WARM_VIEW_KEYS` rasters ``(H, W)`` of one
    view; ``motion`` is this iteration's :func:`motion_bound`.  The pose is
    in the camera frame; the depth is differentiable w.r.t. the SDF and the
    pose through the surrogate of :func:`render_depth_warm`.
    """
    device = resolve_device(device)
    w = view_warm
    with torch.no_grad():
        pose = kernels.pose_params(position, orientation, 1.0 / scale)
    t_init, skip, macc_new = warm_inputs(
        w, ray_set(camera, device).march, pose, motion, full_refresh,
        threshold)
    depth, aux = render_depth_warm(
        sdf, position, orientation, 1.0 / scale, t_init, skip, camera=camera,
        threshold=threshold, max_steps=max_steps, device=device,
    )
    with torch.no_grad():
        marched = skip <= 0.0
        new_warm = {
            "hit": torch.where(marched, (depth > 0).to(torch.float32),
                               w["hit"]),
            "macc": torch.where(marched, torch.zeros_like(macc_new),
                                macc_new),
        }
        for k in ("t", "t0", "v0", "min_dip", "v_last", "t_last"):
            new_warm[k] = torch.where(marched, aux[k], w[k])
    return depth, {k: new_warm[k] for k in WARM_VIEW_KEYS}
