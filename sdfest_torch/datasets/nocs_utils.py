"""Similarity-transform estimation for NOCS-style correspondences (numpy;
the port's copy of ``sdfest_tpu/datasets/nocs_utils.py``).

Outlier-robust (RANSAC over 5-point samples) estimation of an
isotropic-scale + rotation + translation transform between corresponding
point sets via the Umeyama closed form (the reference's
``initialization/datasets/nocs_utils.py``).  Host-side: this runs once per
dataset sample during preprocessing, outside the refinement loop.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class PoseEstimationError(Exception):
    """Raised when pose estimation encounters degenerate inputs."""


def estimate_similarity_transform(
    source: np.ndarray,
    target: np.ndarray,
    verbose: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple:
    """Estimate a similarity transform from corresponding point sets.

    The returned values satisfy (ignoring the homogeneous coordinate)
    ``transform @ source_points == scale * rotation @ source_points +
    position``.

    Args:
        source: Source points, shape (N, 3).
        target: Corresponding target points, shape (N, 3).
        verbose: Print diagnostic information.
        rng: Optional PRNG for the RANSAC sampling (deterministic tests).
    Returns:
        Tuple of (position (3,), rotation_matrix (3, 3), scale (float),
        transform (4, 4)); all None when estimation fails (too few points
        or low inlier ratio).
    """
    if len(source) < 5 or len(target) < 5:
        print("Pose estimation failed. Not enough point correspondences:",
              len(source))
        return None, None, None, None
    if rng is None:
        rng = np.random.default_rng()

    source = np.asarray(source, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)

    # auto thresholds from source/target magnitude heuristics (as reference)
    target_norm = np.mean(np.linalg.norm(target, axis=1))
    source_norm = np.mean(np.linalg.norm(source, axis=1))
    ratio_ts = target_norm / source_norm
    ratio_st = source_norm / target_norm
    pass_threshold = max(ratio_st, ratio_ts) * 0.01
    stop_threshold = pass_threshold / 100
    n_iter = 100
    if verbose:
        print("Pass threshold:", pass_threshold)
        print("Stop threshold:", stop_threshold)

    best_residual = np.inf
    best_inlier_ratio = 0.0
    best_inlier_idx = np.arange(len(source))
    for _ in range(n_iter):
        rand_idx = rng.choice(len(source), size=5, replace=False)
        try:
            _, _, _, transform = umeyama(source[rand_idx], target[rand_idx])
        except PoseEstimationError:
            continue
        residual, inlier_ratio, inlier_idx = _evaluate_model(
            transform, source, target, pass_threshold
        )
        if residual < best_residual:
            best_residual = residual
            best_inlier_ratio = inlier_ratio
            best_inlier_idx = inlier_idx
        if best_residual < stop_threshold:
            break

    if best_inlier_ratio < 0.1:
        print("Pose estimation failed. Small inlier ratio:", best_inlier_ratio)
        return None, None, None, None

    scales, rotation, position, transform = umeyama(
        source[best_inlier_idx], target[best_inlier_idx]
    )
    if verbose:
        print("BestInlierRatio:", best_inlier_ratio)
        print("Rotation:\n", rotation)
        print("Position:\n", position)
        print("Scales:", scales)
    return position, rotation, scales[0], transform


def _evaluate_model(
    transform: np.ndarray,
    source: np.ndarray,
    target: np.ndarray,
    pass_threshold: float,
) -> Tuple[float, float, np.ndarray]:
    """Residual norm, inlier ratio and inlier indices of a candidate model."""
    transformed = source @ transform[:3, :3].T + transform[:3, 3]
    residual_vec = np.linalg.norm(target - transformed, axis=1)
    residual = float(np.linalg.norm(residual_vec))
    inlier_idx = np.nonzero(residual_vec < pass_threshold)[0]
    inlier_ratio = len(inlier_idx) / len(source)
    return residual, inlier_ratio, inlier_idx


def umeyama(source: np.ndarray, target: np.ndarray) -> Tuple:
    """Least-squares similarity transform (Umeyama 1991), closed form.

    Args:
        source: Source points, shape (M, 3).
        target: Target points, shape (M, 3).
    Returns:
        Tuple (scales (3,), rotation (3, 3), translation (3,),
        transform (4, 4)) with ``scale * rotation @ p + translation``
        equivalent to ``transform @ p_hom``.
    """
    source = np.asarray(source, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if np.isnan(source).any() or np.isnan(target).any():
        raise RuntimeError("There are NaNs in the input.")
    n_points = source.shape[0]
    source_centroid = source.mean(axis=0)
    target_centroid = target.mean(axis=0)
    centered_source = source - source_centroid
    centered_target = target - target_centroid

    cov = centered_target.T @ centered_source / n_points
    u, diag_values, vh = np.linalg.svd(cov, full_matrices=True)
    s = np.eye(3)
    if np.linalg.det(cov) < 0.0:
        s[-1, -1] = -1
    rotation = u @ s @ vh

    var_p = centered_source.var(axis=0, ddof=0).sum()
    if var_p == 0:
        raise PoseEstimationError("0 variance in sampled points.")
    scale_fact = float(np.trace(s @ np.diag(diag_values)) / var_p)
    scales = np.array([scale_fact] * 3)
    translation = target_centroid - scale_fact * rotation @ source_centroid

    transform = np.identity(4)
    transform[:3, :3] = scale_fact * rotation
    transform[:3, 3] = translation
    return scales, rotation, translation, transform
