"""The benchmark's inputs, made on the device from the seed: procedural mug
and bowl SDF grids (the shape families the committed models were trained
on), object poses drawn from a configuration's generated-view
distribution, and their depth frames, rendered by the reference's march.

The family generators are a plain-torch rewrite of the repository's
``utils/scenes.py`` formulas (capped cylinders, a torus handle, spherical
shells cut by a plane; unions as ``min``, subtractions as ``max(a, -b)``),
batched over shapes.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from bench_port.reference import ops, render

MUG_BOUNDS = {
    "body_radius": (0.40, 0.56), "body_half_height": (0.42, 0.62),
    "wall": (0.055, 0.11), "bottom": (0.05, 0.14), "taper": (-0.12, 0.18),
    "handle_ring": (0.20, 0.30), "handle_tube": (0.05, 0.09),
    "handle_y": (-0.08, 0.12), "handle_gap": (0.04, 0.12),
}
BOWL_BOUNDS = {
    "radius": (0.58, 0.80), "wall": (0.06, 0.12), "bottom": (0.06, 0.16),
    "rim": (0.10, 0.42), "squash": (0.55, 1.0),
}


def _uniform(n, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _params(bounds: Dict, n: int, gen, device) -> Dict[str, torch.Tensor]:
    return {k: _uniform(n, lo, hi, gen, device)
            for k, (lo, hi) in bounds.items()}


def _coords(res: int, device):
    c = torch.linspace(-1.0, 1.0, res, device=device)
    return torch.meshgrid(c, c, c, indexing="ij")


def _capped_cylinder(px, py, pz, radius, half_h):
    d_r = torch.sqrt(px * px + pz * pz) - radius
    d_y = torch.abs(py) - half_h
    outside = torch.sqrt(torch.clamp(d_r, min=0.0) ** 2
                         + torch.clamp(d_y, min=0.0) ** 2)
    return outside + torch.clamp(torch.maximum(d_r, d_y), max=0.0)


def mug_grids(n: int, gen: torch.Generator, device, res: int = 64
              ) -> torch.Tensor:
    """``n`` mug-family SDF grids ``(n, res, res, res)``."""
    p = _params(MUG_BOUNDS, n, gen, device)
    # keep the handle inside the grid with a ~2-voxel margin
    overhang = (p["body_radius"] + p["handle_gap"] + p["handle_ring"]
                + p["handle_tube"])
    p["handle_ring"] = p["handle_ring"] - torch.clamp(overhang - 0.94,
                                                      min=0.0)
    out = []
    x, y, z = _coords(res, device)
    for i in range(n):
        q = {k: v[i] for k, v in p.items()}
        r_scale = 1.0 + q["taper"] * (y / (2.0 * q["body_half_height"]))
        body = _capped_cylinder(x, y, z, q["body_radius"] * r_scale,
                                q["body_half_height"])
        cavity = _capped_cylinder(x, y - q["bottom"], z,
                                  (q["body_radius"] - q["wall"]) * r_scale,
                                  q["body_half_height"])
        vessel = torch.maximum(body, -cavity)
        tx, ty = x - (q["body_radius"] + q["handle_gap"]), y - q["handle_y"]
        ring = torch.sqrt(tx * tx + ty * ty) - q["handle_ring"]
        handle = torch.sqrt(ring * ring + z * z) - q["handle_tube"]
        out.append(torch.minimum(vessel, handle))
    return torch.stack(out).contiguous()


def bowl_grids(n: int, gen: torch.Generator, device, res: int = 64
               ) -> torch.Tensor:
    """``n`` bowl-family SDF grids ``(n, res, res, res)``."""
    p = _params(BOWL_BOUNDS, n, gen, device)
    out = []
    x, y, z = _coords(res, device)
    for i in range(n):
        q = {k: v[i] for k, v in p.items()}
        ys = y / q["squash"]
        outer = torch.sqrt(x * x + ys * ys + z * z) - q["radius"]
        yc = (y - q["bottom"]) / q["squash"]
        cavity = torch.sqrt(x * x + yc * yc + z * z) - (q["radius"]
                                                        - q["wall"])
        bowl = torch.maximum(torch.maximum(outer, -cavity), y - q["rim"])
        out.append(bowl * torch.clamp(q["squash"], max=1.0))
    return torch.stack(out).contiguous()


FAMILIES = {"mug": mug_grids, "bowl": bowl_grids}


def camera_of(config: Dict) -> ops.Camera:
    return ops.Camera(**config["camera"])


def draw_poses(views: Dict, camera: ops.Camera, n: int, gen, device
               ) -> Dict[str, torch.Tensor]:
    """Poses ``position (n, 3)``, ``orientation (n, 4)``, ``scale (n,)`` of
    a generated-view distribution.  The depths ``z`` are the same stratified
    set for every seed (the midpoints of ``n`` equal slices of ``[z_min,
    z_max]``, in a seeded order), so a seed changes shapes, orientations,
    image positions and order, and not the mix of object sizes on screen."""
    cf = views.get("center_frac", 1.0)
    z_set = views["z_min"] + (torch.arange(n, device=device) + 0.5) / n * (
        views["z_max"] - views["z_min"])
    z = z_set[torch.randperm(n, generator=gen, device=device)]
    x_pix = _uniform(n, -cf * camera.width / 2, cf * camera.width / 2, gen,
                     device)
    y_pix = _uniform(n, -cf * camera.height / 2, cf * camera.height / 2, gen,
                     device)
    q = ops.q_random((n,), gen, device)
    scale = (views["extent_mean"] + views["extent_std"] * torch.randn(
        n, generator=gen, device=device)) / 2.0
    position = torch.stack([x_pix / camera.fx * z, y_pix / camera.fy * z, -z],
                           dim=-1)
    return {"position": position, "orientation": q, "scale": scale}


def make_frames(config: Dict, traffic: Dict, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """The cell's pool of distinct frames: ``depth (n, H, W)``, ``mask``,
    the true poses and the grids they show."""
    n = int(traffic["pool"])
    gen = torch.Generator(device=device).manual_seed(seed)
    views = config["views"]
    grids = FAMILIES[views["family"]](n, gen, device)
    camera = camera_of(config["estimation"])
    poses = draw_poses(views, camera, n, gen, device)
    depth = render.render_depth(grids, poses["position"],
                                poses["orientation"], poses["scale"], camera,
                                views["render_threshold"])
    return {"depth": depth.contiguous(), "mask": depth > 0, "grids": grids,
            **poses}


def hypothesis_starts(truth: Dict[str, torch.Tensor], i: int, hyp: Dict,
                      latent_size: int, gen, device) -> Dict[str, torch.Tensor]:
    """``N`` refinement starts ``(N, 1, ...)`` around frame ``i``'s true
    pose: Gaussian position noise, a rotation by a uniform angle up to
    ``max_angle_deg`` about a uniform axis, a log-normal scale factor and a
    Gaussian latent (the traffic file's parameters)."""
    n = int(hyp["hypotheses"])
    pos = truth["position"][i] + hyp["position_std"] * torch.randn(
        n, 3, generator=gen, device=device)
    axis = torch.randn(n, 3, generator=gen, device=device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    angle = torch.rand(n, generator=gen, device=device) * math.radians(
        hyp["max_angle_deg"])
    dq = torch.cat([axis * torch.sin(angle / 2)[:, None],
                    torch.cos(angle / 2)[:, None]], dim=-1)
    q = ops.q_normalize(ops.q_multiply(dq, truth["orientation"][i]))
    scale = truth["scale"][i] * torch.exp(hyp["log_scale_std"] * torch.randn(
        n, generator=gen, device=device))
    latent = hyp["latent_std"] * torch.randn(n, latent_size, generator=gen,
                                             device=device)
    return {"position": pos[:, None], "orientation": q[:, None],
            "scale": scale[:, None], "latent": latent[:, None]}


def frame_seeds(seed: int, n: int) -> List[int]:
    """Per-call generator seeds (distinct, reproducible from the seed)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 62, (n,), generator=g).tolist()
