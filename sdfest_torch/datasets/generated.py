"""Generated training views: VAE latent -> decoded SDF -> posed render ->
mask and blur augmentations -> point set (counterpart of
``sdfest_tpu/datasets/generated.py``).

A batch is two steps.  :meth:`SDFVAEViewDataset.draw` takes every random
number from one ``torch.Generator``: the latents, the depth ``z``, the pixel
centre, the quaternion, the scale, the mask-noise warp and fill, the blur
switch, the normalization noise and the subsample's uniforms.
:meth:`SDFVAEViewDataset.views_from_draws` is deterministic: ONE decoder
call for all B latents, ONE march launch for all B views (the grids
``(B, R, R, R)`` with poses ``(B, 3)``, ``(B, 4)``, ``(B,)``, as
``refine_batch`` renders hypotheses), then the augmentations and the lift
on the whole batch.  The JAX package maps a single-sample function over the
batch instead; tests feed its draws into the port.

Like the JAX package, the x position is drawn symmetric in the image width
(the reference draws ``U(-width/2, height/2)`` pixels).  The mask warp is
the JAX package's two-pass version (the source row looked up at the
destination column, then the source column), which differs from a direct
nearest-neighbour gather by at most one pixel here and there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid, quat_to_index
from sdfest_torch.render.api import render_depth
from sdfest_torch.utils.device import resolve_device

DEFAULT_CONFIG: Dict[str, Any] = {
    "width": 640,
    "height": 480,
    "fov_deg": 90,
    "render_threshold": 0.004,
    "normalize_pose": None,
    "orientation_repr": "quaternion",
    "orientation_grid_resolution": None,
    "mask_noise": False,
    "mask_noise_min": 0.1,
    "mask_noise_max": 2.0,
    "norm_noise": False,
    "norm_noise_min": -0.2,
    "norm_noise_max": 0.2,
    "scale_to_unit_ball": False,
    "gaussian_noise_probability": 0.0,
    "gaussian_noise_kernel_size": 5,
    "gaussian_noise_kernel_std": 1,
    "num_points": 2500,
    # fraction of the image over which object centres are drawn
    "center_frac": 1.0,
    "pointcloud": True,
    "relaxation": 1.0,  # > 1: the relaxed march
    "coarse_culling": True,
}


def gaussian_kernel_1d(std: float, kernel_size: int) -> np.ndarray:
    """The 1-D factor of the reference's Gaussian blur kernel (scipy's
    filter is separable)."""
    if kernel_size % 2 != 1:
        raise ValueError("Kernel size should be odd.")
    from scipy.ndimage import gaussian_filter1d

    impulse = np.zeros(kernel_size)
    impulse[kernel_size // 2] = 1
    return gaussian_filter1d(impulse, std).astype(np.float32)


def separable_blur(x: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """A SAME zero-padded 2-D correlation of ``x (..., H, W)`` with
    ``outer(weights, weights)``, as the JAX package's two passes of shifted
    slices add it up (rows first, taps in order)."""
    k = len(weights)
    r = k // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, r, r))
    rows = float(weights[0]) * xp[..., 0:h, :]
    for i in range(1, k):
        rows = rows + float(weights[i]) * xp[..., i:i + h, :]
    rp = F.pad(rows, (r, r, 0, 0))
    out = float(weights[0]) * rp[..., :, 0:w]
    for i in range(1, k):
        out = out + float(weights[i]) * rp[..., :, i:i + w]
    return out


def any_within(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Whether any pixel of ``x (B, H, W)`` (bool) in the ``kernel_size``
    square around each pixel is set."""
    r = kernel_size // 2
    return F.max_pool2d(x[:, None].to(torch.float32), kernel_size, stride=1,
                        padding=r)[:, 0] > 0


def affine_warp_mask(mask: torch.Tensor, angle: torch.Tensor,
                     tx: torch.Tensor, ty: torch.Tensor, s: torch.Tensor
                     ) -> torch.Tensor:
    """Warp binary masks ``(B, H, W)`` by small affine maps about the image
    centre (rotation ``angle`` in radians, translation ``(tx, ty)`` pixels,
    scale ``s``, each ``(B,)``), nearest neighbour, as
    ``_affine_warp_mask`` (``generated.py:120``) computes it: the source row
    is looked up at the destination column, then the source column in
    that; a displacement past the JAX package's static shift range reads
    nothing."""
    b, h, w = mask.shape
    dev = mask.device
    cos = (torch.cos(angle) * s)[:, None, None]
    sin = (torch.sin(angle) * s)[:, None, None]
    ss = (s * s)[:, None, None]
    tx, ty = tx[:, None, None], ty[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    src_c = (cos * (cols - tx) + sin * (rows - ty)) / ss + cx
    src_r = (-sin * (cols - tx) + cos * (rows - ty)) / ss + cy
    src_ri = torch.clamp(torch.round(src_r), 0, h - 1).to(torch.int64)
    src_ci = torch.clamp(torch.round(src_c), 0, w - 1).to(torch.int64)
    inside = (src_r >= 0) & (src_r <= h - 1) & (src_c >= 0) & (src_c <= w - 1)
    # the JAX package's static shift ranges (rotation <= 1 degree,
    # translation <= 1%, scale within 0.1%)
    diag = float(np.hypot(cx + 1, cy + 1))
    d_rows = int(np.ceil(0.01746 * diag + 0.01 * h + 0.001 * diag)) + 1
    d_cols = int(np.ceil(0.01746 * diag + 0.01 * w + 0.001 * diag)) + 1
    rows_i = torch.arange(h, device=dev)[:, None]
    cols_i = torch.arange(w, device=dev)[None, :]
    m = mask.to(torch.uint8)
    tmp = torch.gather(m, 1, src_ri) * (
        torch.abs(src_ri - rows_i) <= d_rows)
    warped = torch.gather(tmp, 2, src_ci) * (
        torch.abs(src_ci - cols_i) <= d_cols)
    return (warped != 0) & inside


def _uniform(shape, lo: float, hi: float, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(*shape, generator=generator,
                                       device=device)


class SDFVAEViewDataset:
    """Generator of synthetic pose-estimation training batches.

    Usage::

        dataset = SDFVAEViewDataset(config, vae.decoder, device="cuda")
        batch = dataset.sample_batch(32, generator)

    Batch entries: ``depth`` (B, H, W), ``pointset`` (B, N, 3),
    ``latent_shape`` (B, L), ``position`` (B, 3), ``orientation`` (B, 4) or
    (B,) cell indices, ``quaternion`` (B, 4), ``scale`` (B,), ``valid``
    (B,), all on the dataset's device.  The decoder is used frozen.
    """

    def __init__(self, config: dict, decoder: torch.nn.Module,
                 device="cuda") -> None:
        merged = dict(DEFAULT_CONFIG)
        merged.update({k: v for k, v in config.items() if v is not None})
        self.config = merged
        self.device = resolve_device(device)
        self.decoder = decoder
        self.latent_size = decoder.latent_size
        f = merged["width"] / math.tan(
            merged["fov_deg"] * math.pi / 180.0 / 2.0) / 2
        self.camera = Camera(
            width=merged["width"], height=merged["height"], fx=f, fy=f,
            cx=merged["width"] / 2, cy=merged["height"] / 2,
            pixel_center=0.5)
        self._orientation_repr = merged["orientation_repr"]
        if self._orientation_repr not in ("quaternion", "discretized"):
            raise NotImplementedError(
                f"Orientation representation {self._orientation_repr} "
                "unsupported.")
        self.grid = (SO3Grid(merged["orientation_grid_resolution"])
                     if self._orientation_repr == "discretized" else None)
        self._kernel_1d = gaussian_kernel_1d(
            merged["gaussian_noise_kernel_std"],
            merged["gaussian_noise_kernel_size"])

    def draw(self, batch_size: int,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Every random number of a batch, as the values the JAX package
        derives from its keys (``generated.py:231-331``)."""
        cfg, cam = self.config, self.camera
        b, dev, g = batch_size, self.device, generator
        cf = cfg["center_frac"]
        return {
            "latent": torch.randn(b, self.latent_size, generator=g,
                                  device=dev),
            "z": _uniform((b,), cfg["z_min"], cfg["z_max"], g, dev),
            "x_pix": _uniform((b,), -cf * cam.width / 2, cf * cam.width / 2,
                              g, dev),
            "y_pix": _uniform((b,), -cf * cam.height / 2,
                              cf * cam.height / 2, g, dev),
            "quaternion": quaternion.random_uniform((b,), g, dev),
            "scale": (cfg["extent_mean"] + cfg["extent_std"] * torch.randn(
                b, generator=g, device=dev)) / 2.0,
            "warp_angle": torch.rand(b, generator=g, device=dev)
            * math.pi / 180.0,
            "warp_tx": _uniform((b,), -0.01, 0.01, g, dev) * cam.width,
            "warp_ty": _uniform((b,), -0.01, 0.01, g, dev) * cam.height,
            "warp_scale": _uniform((b,), 0.999, 1.001, g, dev),
            "fill": _uniform((b,), cfg["mask_noise_min"],
                             cfg["mask_noise_max"], g, dev),
            "blur": torch.rand(b, generator=g, device=dev),
            "norm_noise": _uniform((b, 3), cfg["norm_noise_min"],
                                   cfg["norm_noise_max"], g, dev),
            "subsample": torch.rand(b, cfg["num_points"], generator=g,
                                    device=dev),
        }

    def position(self, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Object positions ``(B, 3)`` in the camera frame."""
        z = draws["z"]
        return torch.stack([draws["x_pix"] / self.camera.fx * z,
                            draws["y_pix"] / self.camera.fy * z, -z], dim=-1)

    @torch.no_grad()
    def render(self, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Depth ``(B, H, W)`` of the decoded latents at the drawn poses:
        one decoder call and one march launch for the batch."""
        cfg = self.config
        sdf = self.decoder(draws["latent"])[:, 0].contiguous()
        return render_depth(
            sdf, self.position(draws), draws["quaternion"],
            1.0 / draws["scale"], camera=self.camera,
            threshold=cfg["render_threshold"],
            relaxation=cfg["relaxation"], culling=cfg["coarse_culling"],
            device=self.device)

    @torch.no_grad()
    def views_from_depth(self, depth: torch.Tensor,
                         draws: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """The augmentations, the lift and the labels of rendered depth
        ``(B, H, W)`` (``generated.py:269-333`` on the whole batch)."""
        cfg = self.config
        position, scale = self.position(draws), draws["scale"]
        exact_mask = depth != 0
        if cfg["mask_noise"]:
            final_mask = affine_warp_mask(
                exact_mask, draws["warp_angle"], draws["warp_tx"],
                draws["warp_ty"], draws["warp_scale"])
            depth = torch.where(exact_mask, depth,
                                draws["fill"][:, None, None])
        else:
            final_mask = exact_mask
        if cfg["gaussian_noise_probability"] > 0.0:
            apply = (draws["blur"] < cfg["gaussian_noise_probability"])[
                :, None, None]
            touched = any_within(depth == 0, len(self._kernel_1d))
            depth = torch.where(apply & ~touched,
                                separable_blur(depth, self._kernel_1d),
                                depth)
        depth = torch.where(final_mask, depth, torch.zeros_like(depth))

        sample: Dict[str, torch.Tensor] = {}
        if cfg["pointcloud"]:
            points, valid = pointset.depth_to_pointcloud_dense(depth,
                                                               self.camera)
            if cfg["normalize_pose"]:
                points, centroid = pointset.normalize_points_masked(points,
                                                                    valid)
                position = position - centroid
                if cfg["norm_noise"]:
                    position = position + draws["norm_noise"]
                    points = points + draws["norm_noise"][:, None, :]
                if cfg["scale_to_unit_ball"]:
                    norms = torch.where(valid, torch.linalg.norm(points,
                                                                 dim=-1), 0.0)
                    max_distance = torch.clamp(torch.amax(norms, dim=-1),
                                               min=1e-9)
                    points = points / max_distance[:, None, None]
                    scale = scale / max_distance
            sample["pointset"], any_valid = pointset.subsample_with_uniforms(
                points, valid, draws["subsample"])
        else:
            any_valid = torch.any(depth.flatten(1) != 0, dim=-1)
        quat = draws["quaternion"]
        sample["depth"] = depth
        sample["latent_shape"] = draws["latent"]
        sample["position"] = position
        sample["quaternion"] = quat
        sample["orientation"] = (
            quat_to_index(quat, cfg["orientation_grid_resolution"])
            if self.grid is not None else quat)
        sample["scale"] = scale
        sample["valid"] = any_valid
        return sample

    def views_from_draws(self, draws: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
        """A batch from its draws: :meth:`render`, then
        :meth:`views_from_depth`."""
        return self.views_from_depth(self.render(draws), draws)

    def sample_batch(self, batch_size: int,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """A fresh batch of ``batch_size`` views."""
        return self.views_from_draws(self.draw(batch_size, generator))
