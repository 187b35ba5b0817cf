"""Miscellaneous utilities (counterpart of ``sdfest_tpu/utils/misc.py``):
``str_to_object`` resolves a class or function from a string (the caller's
scope first, then a fully-qualified lookup), ``str_to_tsdf`` parses a
config's ``tsdf`` value, and ``visualize_sample`` plots a training sample's
point set with its ground-truth oriented box and axes (matplotlib, imported
inside the function: the card's machine has none).
"""
from __future__ import annotations

import inspect
from pydoc import locate
from typing import Any, Optional, Union

import numpy as np


def str_to_object(name: str) -> Any:
    """Resolve a name in the caller's scope, else a fully qualified name
    (``pydoc.locate``); None when neither finds it."""
    frame = inspect.currentframe().f_back
    try:
        if name in frame.f_locals:
            return frame.f_locals[name]
        if name in frame.f_globals:
            return frame.f_globals[name]
    finally:
        del frame
    return locate(name)


def str_to_tsdf(x) -> Union[bool, float]:
    """A config's ``tsdf`` value: False, or the truncation distance as a
    float; falsy strings (``"false"``, ``"no"``, ``"0"``, ...) are False, so
    dotted command-line overrides (strings) and YAML values (bools, floats)
    both parse."""
    if isinstance(x, bool):
        return False if not x else float(x)
    if isinstance(x, (int, float)):
        return float(x)
    if str(x).lower() in ("no", "false", "f", "n", "0"):
        return False
    return float(x)


def visualize_sample(sample: dict, show: bool = False,
                     path: Optional[str] = None):
    """Plot a sample's point set with its ground-truth box and object axes.

    Args:
        sample: Dict with ``pointset`` (N, 3), ``position`` (3,),
            ``quaternion`` (4,) and ``scale`` (scalar or (3,) extents/2).
        show: Call ``plt.show()``.
        path: Optional path to save the figure.
    Returns:
        The matplotlib figure.
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.spatial.transform import Rotation

    points = np.asarray(sample["pointset"])
    position = np.asarray(sample["position"])
    quat = np.array(sample["quaternion"], dtype=np.float64)
    scale = np.asarray(sample["scale"])
    half_extents = (
        scale if scale.ndim == 1 else np.array([scale, scale, scale])
    ).reshape(3)

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    sub = points[:: max(len(points) // 1000, 1)]
    ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=1, alpha=0.5)

    rot = Rotation.from_quat(quat).as_matrix()
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    ) * half_extents
    corners = corners @ rot.T + position
    edges = [
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ]
    for a, b in edges:
        ax.plot(*zip(corners[a], corners[b]), color="r", linewidth=0.8)
    for axis, color in zip(np.eye(3) * half_extents.max(), "rgb"):
        tip = position + rot @ axis
        ax.plot(*zip(position, tip), color=color, linewidth=2)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    if path:
        fig.savefig(path)
    if show:
        plt.show()
    return fig
