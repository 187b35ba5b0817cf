"""Evaluation metrics for pose and shape estimation (host-side numpy/scipy;
a copy of ``sdfest_tpu/pipeline/metrics.py``).

These run in the evaluation path, outside the refinement loop, so KD-trees
and convex hulls stay on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.spatial
from scipy.spatial.transform import Rotation


def correct_thresh(
    position_gt: np.ndarray,
    position_prediction: np.ndarray,
    orientation_gt: Rotation,
    orientation_prediction: Rotation,
    extent_gt: Optional[np.ndarray] = None,
    extent_prediction: Optional[np.ndarray] = None,
    points_gt: Optional[np.ndarray] = None,
    points_prediction: Optional[np.ndarray] = None,
    position_threshold: Optional[float] = None,
    degree_threshold: Optional[float] = None,
    iou_3d_threshold: Optional[float] = None,
    fscore_threshold: Optional[float] = None,
    rotational_symmetry_axis: Optional[int] = None,
) -> int:
    """Classify a pose/shape prediction as correct (1) or incorrect (0).

    A prediction is correct when every *provided* threshold is satisfied:
    position error (meters), orientation error (degrees, optionally ignoring
    rotation about ``rotational_symmetry_axis``), oriented-box 3D IoU
    (implemented here via exact convex intersection — the reference raises
    NotImplementedError, estimation/metrics.py:73-74), and reconstruction
    F-score at 1cm.  For symmetric objects the IoU is maximized over
    rotations of the ground-truth box about its symmetry axis (NOCS
    convention).
    """
    if position_threshold is not None:
        if np.linalg.norm(position_gt - position_prediction) > position_threshold:
            return 0
    if degree_threshold is not None:
        deg_error = degree_error(
            orientation_gt, orientation_prediction, rotational_symmetry_axis
        )
        if deg_error > degree_threshold:
            return 0
    if iou_3d_threshold is not None:
        if extent_gt is None or extent_prediction is None:
            raise ValueError("3D IoU requires extent_gt and extent_prediction.")
        iou = symmetric_box_iou(
            extent_gt,
            position_gt,
            orientation_gt,
            extent_prediction,
            position_prediction,
            orientation_prediction,
            rotational_symmetry_axis,
        )
        if iou < iou_3d_threshold:
            return 0
    if fscore_threshold is not None:
        fscore = reconstruction_fscore(points_gt, points_prediction, 0.01)
        if fscore < fscore_threshold:
            return 0
    return 1


def degree_error(
    orientation_gt: Rotation,
    orientation_prediction: Rotation,
    rotational_symmetry_axis: Optional[int] = None,
) -> float:
    """Orientation error in degrees, optionally modulo a symmetry axis.

    With ``rotational_symmetry_axis`` set, the error is the angle between
    the two mapped symmetry axes (rotation about the axis is free) — the
    NOCS convention for bottle / bowl / can.
    """
    if rotational_symmetry_axis is not None:
        axis = np.zeros(3)
        axis[rotational_symmetry_axis] = 1.0
        p1 = orientation_gt.apply(axis)
        p2 = orientation_prediction.apply(axis)
        rad_error = np.arccos(np.clip(p1 @ p2, -1.0, 1.0))
    else:
        rad_error = (orientation_gt * orientation_prediction.inv()).magnitude()
    return float(np.rad2deg(rad_error))


def symmetric_box_iou(
    extent_gt: np.ndarray,
    position_gt: np.ndarray,
    orientation_gt: Rotation,
    extent_prediction: np.ndarray,
    position_prediction: np.ndarray,
    orientation_prediction: Rotation,
    rotational_symmetry_axis: Optional[int] = None,
) -> float:
    """Oriented-box 3D IoU, maximized over ground-truth symmetry rotations.

    For symmetric objects the IoU is maximized over 60 rotations of the
    ground-truth box about its symmetry axis (NOCS convention); otherwise
    this is exactly :func:`box_iou_3d`.
    """
    if rotational_symmetry_axis is None:
        return box_iou_3d(
            extent_gt,
            position_gt,
            orientation_gt,
            extent_prediction,
            position_prediction,
            orientation_prediction,
        )
    return max(
        box_iou_3d(
            extent_gt,
            position_gt,
            orientation_gt
            * Rotation.from_rotvec(angle * np.eye(3)[rotational_symmetry_axis]),
            extent_prediction,
            position_prediction,
            orientation_prediction,
        )
        for angle in np.linspace(0.0, 2 * np.pi, 60, endpoint=False)
    )


def _box_corners(extents: np.ndarray, position: np.ndarray, rot: Rotation):
    half = np.asarray(extents, np.float64) / 2.0
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float64,
    )
    return rot.apply(signs * half) + np.asarray(position, np.float64)


_BOX_EDGES = [
    (a, b)
    for a in range(8)
    for b in range(a + 1, 8)
    if bin(a ^ b).count("1") == 1  # corners differing in exactly one axis
]


def _clip_points_in_box(points, position, rot, half, eps=1e-9):
    local = rot.inv().apply(points - position)
    inside = np.all(np.abs(local) <= half + eps, axis=1)
    return points[inside]


def _edge_face_intersections(corners_a, position_b, rot_b, half_b):
    """Intersections of box A's edges with box B's boundary planes, inside B."""
    points = []
    local = rot_b.inv().apply(corners_a - position_b)
    for i, j in _BOX_EDGES:
        p, q = local[i], local[j]
        d = q - p
        for axis in range(3):
            if abs(d[axis]) < 1e-12:
                continue
            for side in (-half_b[axis], half_b[axis]):
                t = (side - p[axis]) / d[axis]
                if 0.0 <= t <= 1.0:
                    x = p + t * d
                    if np.all(np.abs(x) <= half_b + 1e-9):
                        points.append(rot_b.apply(x) + position_b)
    return points


def box_iou_3d(
    extents_1: np.ndarray,
    position_1: np.ndarray,
    orientation_1: Rotation,
    extents_2: np.ndarray,
    position_2: np.ndarray,
    orientation_2: Rotation,
) -> float:
    """Exact 3D IoU of two oriented boxes (convex intersection volume).

    The intersection of two convex polytopes is convex; its vertices are a
    subset of {A-corners inside B} + {B-corners inside A} + {A-edge x B-face
    intersection points inside B} + {B-edge x A-face points inside A}, so
    the intersection volume is the convex hull volume of those candidates.
    Implemented beyond the reference (estimation/metrics.py:73-74 raises
    NotImplementedError).
    """
    half_1 = np.asarray(extents_1, np.float64) / 2.0
    half_2 = np.asarray(extents_2, np.float64) / 2.0
    vol_1 = float(np.prod(2 * half_1))
    vol_2 = float(np.prod(2 * half_2))
    if vol_1 <= 0.0 or vol_2 <= 0.0:
        return 0.0
    c1 = _box_corners(extents_1, position_1, orientation_1)
    c2 = _box_corners(extents_2, position_2, orientation_2)
    candidates = [
        _clip_points_in_box(c1, position_2, orientation_2, half_2),
        _clip_points_in_box(c2, position_1, orientation_1, half_1),
        np.asarray(
            _edge_face_intersections(c1, position_2, orientation_2, half_2)
        ).reshape(-1, 3),
        np.asarray(
            _edge_face_intersections(c2, position_1, orientation_1, half_1)
        ).reshape(-1, 3),
    ]
    points = np.concatenate(candidates, axis=0)
    if len(points) < 4:
        return 0.0
    try:
        inter = float(scipy.spatial.ConvexHull(points).volume)
    except scipy.spatial.QhullError:
        return 0.0  # degenerate (coplanar) intersection has zero volume
    return inter / (vol_1 + vol_2 - inter)


def mean_accuracy(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Mean distance from reconstructed points to closest ground-truth point."""
    d, _ = scipy.spatial.KDTree(points_gt).query(points_rec, p=p_norm)
    return float(np.mean(d) / extent(points_gt)) if normalize else float(np.mean(d))


def mean_completeness(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Mean distance from ground-truth points to closest reconstructed point."""
    d, _ = scipy.spatial.KDTree(points_rec).query(points_gt, p=p_norm)
    return float(np.mean(d) / extent(points_gt)) if normalize else float(np.mean(d))


def symmetric_chamfer(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Arithmetic mean of accuracy and completeness (symmetric chamfer)."""
    return (
        mean_completeness(points_gt, points_rec, p_norm=p_norm, normalize=normalize)
        + mean_accuracy(points_gt, points_rec, p_norm=p_norm, normalize=normalize)
    ) / 2


def completeness_thresh(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    threshold: float,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Ratio of ground-truth points within ``threshold`` of a reconstruction point."""
    d, _ = scipy.spatial.KDTree(points_rec).query(points_gt, p=p_norm)
    if normalize:
        d = d / extent(points_gt)
    return float(np.sum(d < threshold) / points_gt.shape[0])


def accuracy_thresh(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    threshold: float,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Ratio of reconstructed points within ``threshold`` of a ground-truth point."""
    d, _ = scipy.spatial.KDTree(points_gt).query(points_rec, p=p_norm)
    if normalize:
        d = d / extent(points_gt)
    return float(np.sum(d < threshold) / points_rec.shape[0])


def reconstruction_fscore(
    points_gt: np.ndarray,
    points_rec: np.ndarray,
    threshold: float,
    p_norm: int = 2,
    normalize: bool = False,
) -> float:
    """Harmonic mean of thresholded accuracy (precision) and completeness (recall)."""
    recall = completeness_thresh(
        points_gt, points_rec, threshold, p_norm=p_norm, normalize=normalize
    )
    precision = accuracy_thresh(
        points_gt, points_rec, threshold, p_norm=p_norm, normalize=normalize
    )
    if recall < 1e-7 or precision < 1e-7:
        return 0.0
    return 2.0 / (1.0 / recall + 1.0 / precision)


def extent(points: np.ndarray) -> float:
    """Largest Euclidean distance between any two points of the set."""
    try:
        hull = scipy.spatial.ConvexHull(points)
        candidates = points[hull.vertices]
    except Exception:
        candidates = points
    return float(
        np.max(scipy.spatial.distance_matrix(candidates, candidates))
    )
