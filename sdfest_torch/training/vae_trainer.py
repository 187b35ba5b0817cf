"""Shape-VAE trainer (counterpart of ``sdfest_tpu/training/vae_trainer.py``).

The loss of ``VAETrainer._loss`` (``vae_trainer.py:68-125``), summed over
the batch as the reference sums it:

- L1/L2 reconstruction errors split at ``|sdf| < 0.1`` (near/far), each
  with its own weight;
- the KLD, weighted only after ``WARM_UP_ITERATIONS``;
- TSDF: inputs clamped after the warm-up, outputs clamped where both
  target and output lie outside the band;
- the render-based pc loss (``:127-175``): each *input* grid is rendered
  from a random orientation at distance 5 (no gradient), the depth lifted
  to points, and the *reconstruction* sampled there; the loss is the sum of
  squared values over the points inside the volume.

On the card the pc loss is one march launch for the batch (grids ``(B, R,
R, R)``, one pose each), the sample-grad kernel forward and the scatter
kernel backward, one launch each for the batch (``render/api.py``'s
``_SampleOp``): the scatter's output is the gradient of the decoder's
output grid.  The optimizer is ``torch.optim.Adam`` with optax's defaults.
Randomness: ``eps`` and the pc quaternions are arguments of :meth:`loss`
and :meth:`step`, or drawn from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from sdfest_torch.models.vae import create_vae_from_config, fp32_convolutions
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import _base_and_frac
from sdfest_torch.render.api import (
    render_depth,
    sample_sdf_masked_extrapolating,
)
from sdfest_torch.utils.device import resolve_device

PC_DISTANCE = 5.0  # the pc render's camera distance (grid units)
PC_THRESHOLD = 0.01


class VAETrainer:
    """Trainer of :class:`sdfest_torch.models.vae.SDFVAE` on ``device``
    ("cuda" unless the caller asks for "cpu")."""

    WARM_UP_ITERATIONS = 1000

    def __init__(self, config: Dict[str, Any], device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.vae = create_vae_from_config(config).to(self.device)
        self.tsdf = self.vae.tsdf
        self.resolution = self.vae.sdf_size
        w = config.get("pc_render_width", 640)
        h = config.get("pc_render_height", 480)
        f = config.get("pc_render_f", w / 2)
        self.camera = Camera(width=w, height=h, fx=f, fy=f, cx=w / 2,
                             cy=h / 2, pixel_center=0.5)
        self.optimizer = torch.optim.Adam(
            self.vae.parameters(), lr=config.get("learning_rate", 1e-3))
        self.iteration = 0

    # -- state -------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.vae.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "iteration": self.iteration}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.vae.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])

    # -- loss --------------------------------------------------------------

    def pc_depth(self, x: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
        """Depth ``(B, H, W)`` of the input grids ``x (B, 1, R, R, R)``
        rendered at distance 5 from orientations ``quats (B, 4)``: one march
        launch, no gradient."""
        b = x.shape[0]
        with torch.no_grad():
            position = x.new_tensor([0.0, 0.0, -PC_DISTANCE]).expand(b, 3)
            return render_depth(x[:, 0].contiguous(), position, quats,
                                x.new_ones(b), camera=self.camera,
                                threshold=PC_THRESHOLD, device=self.device)

    def pc_loss(self, recon: torch.Tensor, depth: torch.Tensor,
                quats: torch.Tensor) -> torch.Tensor:
        """Sum over the batch of the squared values of ``recon (B, 1, R, R,
        R)`` at the lifted ``depth (B, H, W)`` points inside the volume:
        one sample-grad launch forward, one scatter launch backward."""
        points, valid = pointset.depth_to_pointcloud_dense(depth,
                                                           self.camera)
        p = points.new_tensor([0.0, 0.0, -PC_DISTANCE])
        q = quaternion.invert(quaternion.normalize(quats))[:, None, :]
        obj = quaternion.apply(q, points - p)
        _, _, inside = _base_and_frac(obj, recon.shape[-1])
        values = sample_sdf_masked_extrapolating(
            recon[:, 0], obj, torch.logical_and(inside, valid))
        return torch.sum(values ** 2)

    def loss(self, batch_sdf: torch.Tensor, iteration: int,
             eps: Optional[torch.Tensor] = None,
             quats: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             pc_depth: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The total loss and its terms on ``batch_sdf (B, 1, R, R, R)``.

        ``eps (B, L)`` and ``quats (B, 4)`` default to draws from
        ``generator``; ``pc_depth`` replaces the pc render (tests feed the
        JAX package's depth).
        """
        cfg = self.config
        warm = iteration > self.WARM_UP_ITERATIONS
        x = batch_sdf
        eps = None if eps is None else eps.to(x.device)
        quats = None if quats is None else quats.to(x.device)
        if self.tsdf is not False and warm:
            x = torch.clamp(x, -self.tsdf, self.tsdf)
        recon, mean, log_var, _ = self.vae(x, eps=eps, generator=generator)
        if self.tsdf is not False and warm:
            both_outside = ((torch.abs(x) >= self.tsdf)
                            & (torch.abs(recon) >= self.tsdf))
            recon = torch.where(both_outside,
                                torch.clamp(recon, -self.tsdf, self.tsdf),
                                recon)

        l1_error = torch.abs(recon - x)
        l2_error = l1_error ** 2
        near = torch.abs(x) < 0.1
        zero = torch.zeros((), device=x.device)
        loss_l2_small = torch.sum(torch.where(near, l2_error, zero))
        loss_l2_large = torch.sum(torch.where(near, zero, l2_error))
        loss_l1_small = torch.sum(torch.where(near, l1_error, zero))
        loss_l1_large = torch.sum(torch.where(near, zero, l1_error))

        pc_weight = cfg.get("pc_weight", 0.0)
        if pc_weight > 0.0:
            if quats is None:
                quats = quaternion.random_uniform((x.shape[0],), generator,
                                                  x.device)
            if pc_depth is None:
                pc_depth = self.pc_depth(x, quats)
            loss_pc = self.pc_loss(recon, pc_depth, quats)
        else:
            loss_pc = zero

        loss_kld = -0.5 * torch.sum(1 + log_var - mean ** 2
                                    - torch.exp(log_var))
        kld_weight = cfg.get("kld_weight", 1.0) if warm else 0.0
        loss = (
            cfg.get("l2_small_weight", 1.0) * loss_l2_small
            + cfg.get("l2_large_weight", 1.0) * loss_l2_large
            + cfg.get("l1_small_weight", 0.0) * loss_l1_small
            + cfg.get("l1_large_weight", 0.0) * loss_l1_large
            + pc_weight * loss_pc
            + kld_weight * loss_kld
        )
        metrics = {
            "loss": loss, "loss_l2_small": loss_l2_small,
            "loss_l2_large": loss_l2_large, "loss_l1_small": loss_l1_small,
            "loss_l1_large": loss_l1_large, "loss_pc": loss_pc,
            "loss_kld": loss_kld,
        }
        return loss, metrics

    def step(self, batch_sdf: torch.Tensor,
             eps: Optional[torch.Tensor] = None,
             quats: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             ) -> Dict[str, torch.Tensor]:
        """One Adam step on ``batch_sdf``; returns the loss terms (0-d
        tensors on the device, detached) and advances the iteration."""
        self.vae.train()
        self.optimizer.zero_grad(set_to_none=True)
        batch_sdf = batch_sdf.to(self.device, torch.float32)
        # the backward's convolutions in fp32 too (fp32_convolutions)
        with fp32_convolutions():
            loss, metrics = self.loss(batch_sdf, self.iteration, eps=eps,
                                      quats=quats, generator=generator)
            loss.backward()
        self.optimizer.step()
        self.iteration += 1
        return {k: v.detach() for k, v in metrics.items()}
