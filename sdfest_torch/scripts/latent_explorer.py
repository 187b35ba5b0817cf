"""Latent-space exploration for trained shape VAEs, headless (counterpart of
``sdfest_tpu/scripts/latent_explorer.py``): per-dimension latent sweeps,
interpolation between two encoded shapes, keyframed animations rendered
with the port's depth renderer (one march launch per frame on the card),
and mesh/SDF/figure export, driven from the command line.

Usage:
  python -m sdfest_torch.scripts.latent_explorer --config <vae.yaml> \\
      --out_folder out [--sweep_dim 0] [--interpolate a.npy b.npy] \\
      [--steps 7] [--animate k0.npy k1.npy ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sdfest_torch.models.vae import create_vae_from_config, fp32_convolutions
from sdfest_torch.ops import sdf_vis
from sdfest_torch.ops.sdf_utils import mesh_from_sdf
from sdfest_torch.pipeline.synthetic import save_obj
from sdfest_torch.utils import weights as weight_utils
from sdfest_torch.utils.config import load_config_from_args
from sdfest_torch.utils.device import resolve_device

# the animation's camera and pose (the JAX package's)
ANIMATION_CAMERA = dict(width=320, height=240, fx=280, fy=280, cx=160, cy=120)
ANIMATION_POSITION = (0.0, 0.0, -0.45)
ANIMATION_HALF_WIDTH = 0.18
ANIMATION_THRESHOLD = 0.002


class LatentExplorer:
    """Decode/inspect the latent space of a trained SDF VAE on ``device``
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, config: dict, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.res = config.get("sdf_size", 64)
        self.vae = weight_utils.load_vae_params(
            config, create_vae_from_config(config)).to(self.device).eval()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.array(x, dtype=np.float32),
                               device=self.device)

    def decode(self, z: np.ndarray) -> np.ndarray:
        """Latents ``(B, L)`` -> SDFs ``(B, 1, D, D, D)``."""
        with torch.no_grad(), fp32_convolutions():
            return self.vae.decode(self._tensor(z)).cpu().numpy()

    def encode(self, sdf: np.ndarray) -> np.ndarray:
        """The posterior mean of one SDF volume ``(D, D, D)``."""
        with torch.no_grad(), fp32_convolutions():
            means, _ = self.vae.encode_mean(self._tensor(sdf)[None, None])
        return means.cpu().numpy()[0]

    def sweep(self, dim: int, values: np.ndarray, base: np.ndarray = None):
        """Decode a sweep over one latent dimension; returns
        ``(len(values), D, D, D)``."""
        latent_size = self.config["latent_size"]
        base = np.zeros(latent_size) if base is None else base
        zs = np.tile(base, (len(values), 1))
        zs[:, dim] = values
        return self.decode(zs)[:, 0]

    def interpolate(self, sdf_a: np.ndarray, sdf_b: np.ndarray, steps: int):
        """Latent interpolation between two encoded shapes."""
        za, zb = self.encode(sdf_a), self.encode(sdf_b)
        ts = np.linspace(0.0, 1.0, steps)
        zs = np.stack([(1 - t) * za + t * zb for t in ts])
        return self.decode(zs)[:, 0]

    def load_keyframe(self, path: str) -> np.ndarray:
        """A keyframe latent from a .npy file: a latent vector, or an SDF
        volume which is encoded first (the reference visualizer's 'capture
        current latent' keyframes)."""
        arr = np.load(path)
        if arr.ndim >= 3:
            return self.encode(np.squeeze(arr))
        return arr.reshape(-1)

    def animate(self, keyframes, frames_per_segment: int, turn: float = 0.0):
        """Decode + render a keyframed latent animation.

        Piecewise-linear interpolation through ``keyframes`` (latent
        vectors), ``frames_per_segment`` frames per segment; each frame is
        rendered with the port's depth renderer (one march launch on the
        card) and normal-shaded.  ``turn`` additionally rotates the shape
        by that many turns over the whole animation.  Returns a list of
        (H, W) images.
        """
        from sdfest_torch.ops.camera import Camera
        from sdfest_torch.render import render_depth

        zs = []
        for a, b in zip(keyframes[:-1], keyframes[1:]):
            for t in np.linspace(0.0, 1.0, frames_per_segment, endpoint=False):
                zs.append((1 - t) * a + t * b)
        zs.append(keyframes[-1])
        sdfs = self.decode(np.stack(zs))[:, 0]
        camera = Camera(**ANIMATION_CAMERA)
        position = self._tensor(ANIMATION_POSITION)
        frames = []
        for i, sdf in enumerate(sdfs):
            angle = np.pi * turn * 2.0 * i / max(len(sdfs) - 1, 1)
            q = self._tensor([0.0, np.sin(angle / 2), 0.0, np.cos(angle / 2)])
            with torch.no_grad():
                depth = render_depth(
                    self._tensor(sdf), position, q,
                    1.0 / ANIMATION_HALF_WIDTH, camera=camera,
                    threshold=ANIMATION_THRESHOLD, device=self.device)
            frames.append(sdf_vis.shade_depth(depth.cpu().numpy()))
        return frames


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Explore a VAE latent space.")
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument("--out_folder", default="latent_explorer_out")
    parser.add_argument("--sweep_dim", type=int, default=None)
    parser.add_argument("--sweep_range", type=float, default=2.0)
    parser.add_argument("--interpolate", nargs=2, default=None)
    parser.add_argument("--steps", type=int, default=7)
    parser.add_argument("--export_mesh", action="store_true")
    parser.add_argument(
        "--animate", nargs="+", default=None, metavar="KEYFRAME",
        help="keyframed latent animation: >= 2 .npy files, each a latent "
        "vector or an SDF volume (encoded first); piecewise-linear "
        "interpolation, shaded-render frames, mp4 export",
    )
    parser.add_argument("--frames_per_segment", type=int, default=15)
    parser.add_argument("--fps", type=int, default=15)
    parser.add_argument(
        "--turntable", type=float, default=0.5,
        help="turns of rotation over the whole animation",
    )
    parser.add_argument("--device", default="cuda")
    config = load_config_from_args(parser, argv)
    args, _ = parser.parse_known_args(argv)

    explorer = LatentExplorer(config, device=args.device)
    os.makedirs(args.out_folder, exist_ok=True)

    if args.sweep_dim is not None:
        values = np.linspace(-args.sweep_range, args.sweep_range, args.steps)
        sdfs = explorer.sweep(args.sweep_dim, values)
        fig = sdf_vis.visualize_sdf_batch(sdfs, max_cols=args.steps)
        path = os.path.join(args.out_folder, f"sweep_dim{args.sweep_dim}.png")
        fig.savefig(path)
        print(f"Sweep figure saved to {path}")
        if args.export_mesh:
            for i, sdf in enumerate(sdfs):
                mesh = mesh_from_sdf(sdf, 0.0, complete_mesh=True)
                if mesh is not None:
                    save_obj(
                        os.path.join(args.out_folder, f"sweep_{i}.obj"),
                        mesh.vertices, mesh.faces,
                    )

    if args.interpolate is not None:
        sdf_a = np.load(args.interpolate[0])
        sdf_b = np.load(args.interpolate[1])
        sdfs = explorer.interpolate(sdf_a, sdf_b, args.steps)
        fig = sdf_vis.visualize_sdf_batch(sdfs, max_cols=args.steps)
        path = os.path.join(args.out_folder, "interpolation.png")
        fig.savefig(path)
        print(f"Interpolation figure saved to {path}")
        np.save(os.path.join(args.out_folder, "interpolation_sdfs.npy"), sdfs)

    if args.animate is not None:
        if len(args.animate) < 2:
            raise SystemExit("--animate needs at least 2 keyframe files")
        keyframes = [explorer.load_keyframe(p) for p in args.animate]
        frames = explorer.animate(
            keyframes, args.frames_per_segment, turn=args.turntable
        )
        out = os.path.join(args.out_folder, "animation.mp4")
        sdf_vis.save_depth_animation(
            frames, out, fps=args.fps, cmap="gray", vmax=1.0
        )


if __name__ == "__main__":
    main()
