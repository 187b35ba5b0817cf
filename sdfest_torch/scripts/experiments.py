"""Render-and-recover experiment (counterpart of
``sdfest_tpu/scripts/experiments.py``).

Render a reference depth image of an SDF, perturb the pose and scale, then
optimize them back with Adam (lr 2e-3) through the differentiable renderer
(:func:`sdfest_torch.render.render_depth`: the march forward, the surrogate
backward through the sample-grad kernel; the SDF is fixed, so no grid
gradient is scattered), renormalizing the quaternion after every step, and
report the convergence (and optionally save a figure).

Usage:
  python -m sdfest_torch.scripts.experiments --sdf <grid.npy> \\
      [--iterations 200] [--device cuda] [--plain] [--out fig.png]

Without ``--sdf`` a synthetic sphere SDF is used.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import losses as L
from sdfest_torch.render import render_depth
from sdfest_torch.utils.device import resolve_device


def sphere_sdf(res: int = 64, radius: float = 0.5) -> np.ndarray:
    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - radius).astype(np.float32)


def offset_experiment(
    sdf,
    camera: Camera,
    iterations: int = 200,
    device="cuda",
    threshold: float = 0.005,
    seed: int = 0,
    position_noise: Optional[np.ndarray] = None,
    plain: bool = False,
) -> dict:
    """Perturb pose/scale and optimize back; returns the error trajectory.

    The start's position is the truth plus ``0.04 * position_noise``
    (standard normals ``(3,)``, drawn from a generator seeded with ``seed``
    when None; tests pass the JAX package's draw).  ``plain`` turns off the
    march's culling and adaptive relaxation: the JAX package's XLA march
    (its ``backend="xla"``).
    """
    dev = resolve_device(device)
    sdf = torch.as_tensor(np.asarray(sdf), dtype=torch.float32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    true_state = {"position": f32([0.02, -0.01, -0.5]),
                  "orientation": f32([0.0, 0.0, 0.0, 1.0]),
                  "scale": f32(0.2)}

    def render(s):
        return render_depth(sdf, s["position"], s["orientation"],
                            1.0 / s["scale"], camera=camera,
                            threshold=threshold, culling=not plain,
                            adaptive=not plain, device=dev)

    with torch.no_grad():
        target = render(true_state)
    print(f"reference render: {int((target > 0).sum())} hit pixels")

    if position_noise is None:
        position_noise = torch.randn(
            3, generator=torch.Generator().manual_seed(seed))
    q0 = f32([0.05, -0.03, 0.02, 1.0])
    state = {
        "position": true_state["position"]
        + 0.04 * torch.as_tensor(position_noise, dtype=torch.float32,
                                 device=dev),
        "orientation": q0 / torch.linalg.norm(q0),
        "scale": true_state["scale"] * 1.15,
    }
    params = {k: v.clone().requires_grad_(True) for k, v in state.items()}
    optimizer = torch.optim.Adam(params.values(), lr=2e-3)
    losses = torch.empty(iterations, device=dev)
    for i in range(iterations):
        optimizer.zero_grad(set_to_none=True)
        loss = L.depth_l1_loss(target, render(params))
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            params["orientation"] /= torch.linalg.norm(params["orientation"])
            losses[i] = loss.detach()
    final = {k: v.detach() for k, v in params.items()}

    pos_err0 = float(torch.linalg.norm(state["position"]
                                       - true_state["position"]))
    pos_err1 = float(torch.linalg.norm(final["position"]
                                       - true_state["position"]))
    scale_err0 = abs(float(state["scale"] - true_state["scale"]))
    scale_err1 = abs(float(final["scale"] - true_state["scale"]))
    losses = losses.cpu().numpy()
    print(f"loss: {float(losses[0]):.5f} -> {float(losses[-1]):.5f}")
    print(f"position error: {pos_err0:.4f} -> {pos_err1:.4f}")
    print(f"scale error: {scale_err0:.4f} -> {scale_err1:.4f}")
    with torch.no_grad():
        final_render = render(final).cpu().numpy()
    return {
        "losses": losses,
        "target": target.cpu().numpy(),
        "final_render": final_render,
        "position_error": (pos_err0, pos_err1),
        "scale_error": (scale_err0, scale_err1),
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Render-and-recover "
                                     "experiment.")
    parser.add_argument("--sdf", default=None, help="path to a .npy SDF grid")
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--out", default=None)
    parser.add_argument("--plain", action="store_true",
                        help="march without culling and adaptive "
                        "relaxation")
    args = parser.parse_args(argv)

    sdf = np.load(args.sdf) if args.sdf else sphere_sdf()
    camera = Camera(
        width=args.width, height=args.height, fx=args.width / 2,
        fy=args.width / 2, cx=args.width / 2, cy=args.height / 2,
        pixel_center=0.5,
    )
    result = offset_experiment(sdf, camera, args.iterations, args.device,
                               plain=args.plain)
    if args.out:
        from sdfest_torch.ops.sdf_vis import agg_pyplot

        plt = agg_pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(result["target"])
        axes[0].set_title("reference")
        axes[1].imshow(result["final_render"])
        axes[1].set_title("recovered")
        axes[2].plot(result["losses"])
        axes[2].set_yscale("log")
        axes[2].set_title("loss")
        fig.tight_layout()
        fig.savefig(args.out)
        print(f"Figure saved to {args.out}")


if __name__ == "__main__":
    main()
