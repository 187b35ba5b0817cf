"""Play back the pipeline's optimization logs ("flight recorder";
counterpart of ``sdfest_tpu/scripts/play_log.py``).

Loads the pickled step log that :class:`sdfest_torch.pipeline.pipeline.
SDFPipeline` writes with ``log_path=...`` (or one of the JAX package's: both
hold numpy only, in the same keys and shapes), re-renders the estimate of
selected iterations through ``generate_depth`` (one march launch each on the
card), plots the loss / inlier trajectories, exports an animation and
exports per-step meshes.  Animation modes: ``depth`` (estimated depth),
``error`` (|estimate - input| on the overlap) and ``mesh`` (a normal-shaded
render of the estimated surface).

matplotlib is imported only by the functions that draw (the card's machine
has none): :func:`load_log`, :func:`_render_frames` and
:func:`export_meshes` run on the card, the plots and the movie on the CPU
side.

Usage:
  python -m sdfest_torch.scripts.play_log --log <log.pkl> [--out out.mp4]
        [--stride 1] [--mode depth|error|mesh] [--export_meshes DIR]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def load_log(path: str) -> dict:
    """Load a pipeline step log; returns {"config":..., "log": {...}}."""
    with open(path, "rb") as f:
        return pickle.load(f)


def plot_trajectories(log: dict, out_path: str) -> None:
    """Loss / inlier-ratio / state trajectories over iterations."""
    from sdfest_torch.ops.sdf_vis import agg_pyplot

    plt = agg_pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    axes[0, 0].plot(log["loss"], label="total")
    axes[0, 0].plot(log["loss_depth"], label="depth")
    axes[0, 0].plot(log["loss_pc"], label="pc")
    axes[0, 0].set_yscale("log")
    axes[0, 0].set_title("losses")
    axes[0, 0].legend()
    axes[0, 1].plot(log["inlier_ratio"])
    axes[0, 1].set_title("inlier ratio")
    axes[1, 0].plot(np.asarray(log["position"])[:, 0, :])
    axes[1, 0].set_title("position (x, y, z)")
    axes[1, 1].plot(np.asarray(log["scale"])[:, 0])
    axes[1, 1].set_title("scale")
    for ax in axes.flat:
        ax.set_xlabel("iteration")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    print(f"Trajectory plot saved to {out_path}")


def _pipeline_for(data: dict, pipeline, device):
    from sdfest_torch.pipeline.pipeline import SDFPipeline

    return SDFPipeline(data["config"], device=device) if (
        pipeline is None) else pipeline


def _render_frames(data: dict, stride: int, pipeline=None, device="cuda"):
    """Re-render logged states; returns (pipeline, depth frames, indices).

    Builds a pipeline of the log's config on ``device`` unless one is
    given; each frame is one ``generate_depth`` (one march launch on the
    card), moved to the host as numpy."""
    pipeline = _pipeline_for(data, pipeline, device)
    log = data["log"]
    frames, indices = [], []
    for i in range(0, len(log["loss"]), stride):
        depth = pipeline.generate_depth(
            log["position"][i][0], log["orientation"][i][0],
            log["scale"][i][0], log["latent"][i],
        )
        frames.append(depth.cpu().numpy())
        indices.append(i)
    return pipeline, frames, indices


def export_animation(
    data: dict,
    out_path: str,
    stride: int = 1,
    fps: int = 30,
    mode: str = "depth",
    pipeline=None,
    device="cuda",
) -> None:
    """Export an mp4 of the optimization (the upstream play_log toggles).

    Modes: ``depth`` (estimated depth), ``error`` (|estimate - input| on
    the overlap, requires a log with ``depth_input``), ``mesh`` (normal-
    shaded render of the estimated surface).  Pass ``pipeline`` to reuse an
    already-constructed pipeline (the in-pipeline ``animation_path`` export
    does).  Without a movie writer the frames go to ``<out>_frames.npz``.
    """
    from sdfest_torch.ops.sdf_vis import save_depth_animation, shade_depth

    if mode not in ("depth", "error", "mesh"):
        raise ValueError(f"Unknown animation mode {mode}")
    if mode == "error" and "depth_input" not in data["log"]:
        raise ValueError(
            "error mode needs a log with depth_input (written by "
            "pipelines from this version on)"
        )
    _, frames, indices = _render_frames(data, stride, pipeline=pipeline,
                                        device=device)
    titles = [f"iteration {i}" for i in indices]
    if mode == "depth":
        save_depth_animation(frames, out_path, fps=fps, titles=titles)
    elif mode == "error":
        inp = np.asarray(data["log"]["depth_input"])[-1]
        err = [
            np.where((f > 0) & (inp > 0), np.abs(f - inp), 0.0)
            for f in frames
        ]
        save_depth_animation(err, out_path, fps=fps, titles=titles,
                             cmap="inferno")
    else:
        shaded = [shade_depth(f) for f in frames]
        save_depth_animation(shaded, out_path, fps=fps, titles=titles,
                             cmap="gray", vmax=1.0)


def export_meshes(data: dict, out_dir: str, stride: int = 1, pipeline=None,
                  device="cuda") -> None:
    """Write per-step extracted meshes (the upstream play_log's precomputed
    mesh sequence) as numbered .obj files."""
    from sdfest_torch.pipeline.synthetic import save_obj

    pipeline = _pipeline_for(data, pipeline, device)
    log = data["log"]
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i in range(0, len(log["loss"]), stride):
        mesh = pipeline.generate_mesh(log["latent"][i], log["scale"][i][0],
                                      complete_mesh=True)
        if mesh is None:
            continue
        save_obj(
            os.path.join(out_dir, f"{i:05d}.obj"),
            mesh.get_transformed_vertices(),
            mesh.faces,
        )
        count += 1
    print(f"{count} meshes written to {out_dir}")


def main() -> None:
    parser = argparse.ArgumentParser(description="Play back optimization logs.")
    parser.add_argument("--log", required=True)
    parser.add_argument("--out", default=None)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--mode", default="depth",
                        choices=("depth", "error", "mesh"))
    parser.add_argument("--export_meshes", metavar="DIR", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    data = load_log(args.log)
    plot_trajectories(data["log"], (args.out or args.log) + ".trajectories.png")
    if args.out:
        export_animation(data, args.out, stride=args.stride, fps=args.fps,
                         mode=args.mode, device=args.device)
    if args.export_meshes:
        export_meshes(data, args.export_meshes, stride=args.stride,
                      device=args.device)


if __name__ == "__main__":
    main()
