"""Matplotlib visualizations of SDF volumes and depth images (host-side;
counterpart of ``sdfest_tpu/ops/sdf_vis.py``).

Slice grids and contours of SDF volumes, a shaded depth render of an
extracted isosurface through the numpy z-buffer rasterizer, and depth-image
animations.  matplotlib is imported inside the functions that draw, so the
module imports where matplotlib is absent (the card's machine has none);
:func:`shade_depth` needs numpy only.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def agg_pyplot():
    """matplotlib's pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def visualize_sdf_slices(sdf: np.ndarray, n_slices: int = 4, axis: int = 0):
    """Figure with evenly spaced slices of an SDF volume (zero contour drawn)."""
    plt = agg_pyplot()
    fig, axes = plt.subplots(1, n_slices, figsize=(3 * n_slices, 3))
    res = sdf.shape[axis]
    for i, ax in enumerate(np.atleast_1d(axes)):
        idx = int((i + 0.5) * res / n_slices)
        sl = np.take(sdf, idx, axis=axis)
        vmax = max(abs(float(sl.min())), abs(float(sl.max())), 1e-6)
        ax.imshow(sl, cmap="seismic", vmin=-vmax, vmax=vmax)
        if sl.min() < 0 < sl.max():
            ax.contour(sl, levels=[0.0], colors="k", linewidths=1)
        ax.set_title(f"slice {idx}")
        ax.axis("off")
    fig.tight_layout()
    return fig


def visualize_sdf_reconstruction(sdf: np.ndarray, recon: np.ndarray):
    """Input vs reconstruction center slices along each axis."""
    plt = agg_pyplot()
    fig, axes = plt.subplots(2, 3, figsize=(9, 6))
    for axis in range(3):
        for row, volume in enumerate((sdf, recon)):
            sl = np.take(volume, volume.shape[axis] // 2, axis=axis)
            vmax = max(abs(float(sl.min())), abs(float(sl.max())), 1e-6)
            ax = axes[row, axis]
            ax.imshow(sl, cmap="seismic", vmin=-vmax, vmax=vmax)
            if sl.min() < 0 < sl.max():
                ax.contour(sl, levels=[0.0], colors="k", linewidths=1)
            ax.set_title(("input" if row == 0 else "recon") + f" axis {axis}")
            ax.axis("off")
    fig.tight_layout()
    return fig


def visualize_sdf_batch(sdfs: np.ndarray, max_cols: int = 4):
    """Center slices of a batch of SDFs, one column per sample."""
    n = min(len(sdfs), max_cols)
    plt = agg_pyplot()
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    for i, ax in enumerate(np.atleast_1d(axes)[:n]):
        sl = sdfs[i][sdfs[i].shape[0] // 2]
        vmax = max(abs(float(sl.min())), abs(float(sl.max())), 1e-6)
        ax.imshow(sl, cmap="seismic", vmin=-vmax, vmax=vmax)
        if sl.min() < 0 < sl.max():
            ax.contour(sl, levels=[0.0], colors="k", linewidths=1)
        ax.axis("off")
    fig.tight_layout()
    return fig


def shade_depth(depth: np.ndarray) -> np.ndarray:
    """Lambertian-shaded image of a depth map (normals from depth gradient).

    Produces a mesh-render look without a GL stack: surface normals are
    estimated from the depth gradients and lit by a fixed headlight +
    ambient term; background (depth 0) stays black.
    """
    valid = depth > 0
    gy, gx = np.gradient(depth)
    # normal ~ (-gx, -gy, 1) normalized; headlight along +z
    norm = np.sqrt(gx * gx + gy * gy + 1.0)
    ndotl = 1.0 / norm
    shaded = np.where(valid, 0.25 + 0.75 * ndotl, 0.0)
    return shaded


def save_depth_animation(
    frames,
    out_path: str,
    fps: int = 30,
    titles=None,
    cmap: str = "viridis",
    vmin: float = 0.0,
    vmax: Optional[float] = None,
) -> None:
    """Write an image-sequence animation (mp4 via matplotlib/ffmpeg).

    Headless counterpart of the upstream visualizer's ffmpeg export.  When
    no movie writer is available the frames are saved as a compressed ``.npz``
    instead so the export never hard-fails.
    """
    plt = agg_pyplot()
    from matplotlib import animation

    if vmax is None:
        vmax = max(float(np.max(f)) for f in frames) or 1.0
    fig, ax = plt.subplots()
    im = ax.imshow(frames[0], vmin=vmin, vmax=vmax, cmap=cmap)
    ax.axis("off")

    def update(i):
        im.set_data(frames[i])
        if titles is not None:
            ax.set_title(titles[i])
        return [im]

    ani = animation.FuncAnimation(fig, update, frames=len(frames))
    try:
        ani.save(out_path, fps=fps)
        print(f"Animation saved to {out_path}")
    except Exception as e:  # no ffmpeg: keep the data
        fallback = out_path.rsplit(".", 1)[0] + "_frames.npz"
        np.savez_compressed(fallback, frames=np.stack(frames))
        print(f"movie export failed ({e}); frames saved to {fallback}")
    finally:
        plt.close(fig)


def plot_mesh(
    mesh,
    camera_distance: float = 0.5,
    plot_object=None,
    transform: Optional[np.ndarray] = None,
):
    """Shaded depth render of a mesh (z-buffer rasterizer), as a figure/axes."""
    from sdfest_torch.ops.camera import Camera
    from sdfest_torch.pipeline.synthetic import rasterize_depth

    camera = Camera(width=320, height=240, fx=280, fy=280, cx=160, cy=120)
    vertices = mesh.get_transformed_vertices()
    if transform is not None:
        hom = np.hstack([vertices, np.ones((len(vertices), 1))])
        vertices = (transform @ hom.T).T[:, :3]
    vertices = vertices + np.array([0.0, 0.0, camera_distance])
    depth = rasterize_depth(vertices, mesh.faces, camera)
    shaded = np.where(depth > 0, depth.max() - depth, 0.0)
    if plot_object is None:
        _, plot_object = agg_pyplot().subplots()
    plot_object.imshow(shaded, cmap="gray")
    plot_object.axis("off")
    return plot_object
