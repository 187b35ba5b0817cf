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
output grid.  The optimizer is optax's Adam with its count on the device
(:class:`sdfest_torch.training.optim.Adam`).  Randomness: ``eps`` and the pc
quaternions are arguments of :meth:`loss` and :meth:`step`, or drawn from a
``torch.Generator``.

Single programs (the counterpart of the jitted ``train_step`` and of
``make_chained_step``, ``vae_trainer.py:210-250``): on the card
:meth:`train_step` runs one step, and the function of
:meth:`make_chained_step` K steps on a dataset held on the card, as one
captured CUDA graph each (:mod:`sdfest_torch.utils.graphs`; inside
``graphs.eager()`` and on the CPU the same body runs eagerly).  Every random
number of a dispatch is drawn before it, in the eager order, and the warm-up
switch is computed on the device from an int32 iteration counter kept beside
the Python ``iteration``, so a chain that crosses iteration 1000 switches
inside the dispatch.

Data parallelism (``step(..., group=)``, the counterpart of the JAX step's
``axis_name``): each rank steps on its block of the batch, draws from a
generator folded with its rank, and the gradients and loss terms are summed
over the group with ``all_reduce`` (the losses are batch sums, so the sum
is the global batch's), as ``vae_trainer.py:178-197`` ``psum``s them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from sdfest_torch.models.vae import create_vae_from_config, fp32_convolutions
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import _base_and_frac
from sdfest_torch.parallel.mesh import all_reduce_sum_, fold_in
from sdfest_torch.render.api import (
    render_depth,
    sample_sdf_masked_extrapolating,
)
from sdfest_torch.training.optim import Adam
from sdfest_torch.utils import graphs
from sdfest_torch.utils.device import device_cache, resolve_device

PC_DISTANCE = 5.0  # the pc render's camera distance (grid units)
PC_THRESHOLD = 0.01


@device_cache(maxsize=4)
def _pc_position(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The pc render's camera position ``(3,)``, made once per device (a
    captured step reads it in place)."""
    return torch.tensor([0.0, 0.0, -PC_DISTANCE], dtype=dtype, device=device)


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
        self.optimizer = Adam(self.vae.parameters(),
                              lr=config.get("learning_rate", 1e-3))
        # the iteration on the device (the warm-up switch reads it there)
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._iteration = 0
        self.graphs = graphs.GraphCache(
            warm_up_runs=graphs.TRAIN_WARM_UP_RUNS)

    # -- state -------------------------------------------------------------

    @property
    def iteration(self) -> int:
        """The steps taken (the checkpoints' iteration); setting it sets
        the device counter too."""
        return self._iteration

    @iteration.setter
    def iteration(self, value: int) -> None:
        self._iteration = int(value)
        self._count.fill_(self._iteration)

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
            position = _pc_position(x.device, x.dtype).expand(b, 3)
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
        p = _pc_position(points.device, points.dtype)
        q = quaternion.invert(quaternion.normalize(quats))[:, None, :]
        obj = quaternion.apply(q, points - p)
        _, _, inside = _base_and_frac(obj, recon.shape[-1])
        values = sample_sdf_masked_extrapolating(
            recon[:, 0], obj, torch.logical_and(inside, valid))
        return torch.sum(values ** 2)

    def loss(self, batch_sdf: torch.Tensor, iteration,
             eps: Optional[torch.Tensor] = None,
             quats: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             pc_depth: Optional[torch.Tensor] = None,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The total loss and its terms on ``batch_sdf (B, 1, R, R, R)``.

        ``iteration`` is an int or an int32 0-d tensor on the device (the
        warm-up switch is selected there, as the JAX package's
        ``jnp.where``).  ``eps (B, L)`` and ``quats (B, 4)`` default to
        draws from ``generator``; ``pc_depth`` replaces the pc render
        (tests feed the JAX package's depth).
        """
        cfg = self.config
        x = batch_sdf
        warm = torch.as_tensor(iteration, device=x.device) > \
            self.WARM_UP_ITERATIONS
        eps = None if eps is None else eps.to(x.device)
        quats = None if quats is None else quats.to(x.device)
        if self.tsdf is not False:
            x = torch.where(warm, torch.clamp(x, -self.tsdf, self.tsdf), x)
        recon, mean, log_var, _ = self.vae(x, eps=eps, generator=generator)
        if self.tsdf is not False:
            both_outside = ((torch.abs(x) >= self.tsdf)
                            & (torch.abs(recon) >= self.tsdf))
            recon = torch.where(warm & both_outside,
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
        kld_weight = torch.where(warm, cfg.get("kld_weight", 1.0), 0.0)
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

    def draws(self, batch_size: int, generator: Optional[torch.Generator],
              eps: Optional[torch.Tensor] = None,
              quats: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """A step's random numbers in the order the loss would draw them:
        ``eps (B, L)``, then the pc quaternions ``(B, 4)`` (None without
        the pc loss); those given are kept (moved to the device) and not
        drawn."""
        if eps is None:
            eps = torch.randn(batch_size, self.vae.latent_size,
                              generator=generator, device=self.device)
        if quats is None and self.config.get("pc_weight", 0.0) > 0.0:
            quats = quaternion.random_uniform((batch_size,), generator,
                                              self.device)
        return (eps.to(self.device),
                None if quats is None else quats.to(self.device))

    def indices(self, n: int, batch_size: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """A chained step's batch: ``batch_size`` rows of ``n`` drawn
        uniformly with replacement, on the device."""
        return torch.randint(0, n, (batch_size,), generator=generator,
                             device=self.device)

    def state_tensors(self) -> List[torch.Tensor]:
        """What a step writes in place: the parameters, buffers, Adam's
        state and the device iteration counter."""
        return (list(self.vae.parameters()) + list(self.vae.buffers())
                + self.optimizer.state_tensors() + [self._count])

    def _step(self, x: torch.Tensor, eps: torch.Tensor,
              quats: Optional[torch.Tensor],
              pc_depth: Optional[torch.Tensor] = None, group=None
              ) -> Dict[str, torch.Tensor]:
        """One Adam step on the batch ``x (B, 1, R, R, R)`` (on the device,
        float32) with its draws, at the device iteration counter, which it
        advances: the body of :meth:`step`, :meth:`train_step` and each
        step of a chain.  No host read."""
        self.vae.train()
        params = self.optimizer.params()
        # the backward's convolutions in fp32 too, with cuDNN's
        # deterministic algorithms (fp32_convolutions)
        with fp32_convolutions(deterministic=True):
            loss, metrics = self.loss(x, self._count, eps=eps, quats=quats,
                                      pc_depth=pc_depth)
            grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                             materialize_grads=True))
        if group is not None:
            all_reduce_sum_(grads, group)
            all_reduce_sum_(list(metrics.values()), group)
        # left in .grad as backward() leaves them (inside a graph: tensors
        # of its pool, which each replay rewrites)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.update(grads)
        self._count.add_(1)
        return {k: v.detach() for k, v in metrics.items()}

    def _run(self, key, body: Callable, inputs,
             resident: Sequence[torch.Tensor] = ()):
        """``body(inputs)`` as a captured graph on the card (keyed by
        ``key`` and the inputs' shapes), eagerly on the CPU or inside
        ``graphs.eager()``; returns the metrics (the caller's own)."""
        self.optimizer.init_state()
        return graphs.clone(self.graphs.call(
            key, body, inputs, self.device, state=self.state_tensors(),
            resident=resident))

    def step(self, batch_sdf: torch.Tensor,
             eps: Optional[torch.Tensor] = None,
             quats: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             pc_depth: Optional[torch.Tensor] = None,
             group=None,
             ) -> Dict[str, torch.Tensor]:
        """One eager Adam step on ``batch_sdf``; returns the loss terms
        (0-d tensors on the device, detached) and advances the iteration.

        With a process ``group`` the batch is this rank's block: the draws
        come from ``generator`` folded with the rank (``fold_in``), and the
        gradients and loss terms are summed over the group before the
        update, so every rank takes the global batch's step.  ``eps``,
        ``quats`` and ``pc_depth`` (this rank's rows) override the draws and
        the pc render.
        """
        batch_sdf = batch_sdf.to(self.device, torch.float32)
        if group is not None:
            generator = fold_in(generator, group, self.device)
        eps, quats = self.draws(batch_sdf.shape[0], generator, eps, quats)
        self.optimizer.init_state()
        metrics = self._step(batch_sdf, eps, quats, pc_depth, group)
        self._iteration += 1
        return metrics

    def train_step(self, batch_sdf: torch.Tensor,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """:meth:`step` as one captured graph on the card (the jitted
        ``train_step``): the draws from ``generator`` before it, the batch
        copied into the graph's input."""
        x = batch_sdf.to(self.device, torch.float32)
        eps, quats = self.draws(x.shape[0], generator)
        metrics = self._run(("step",), lambda a: self._step(*a),
                            (x, eps, quats))
        self._iteration += 1
        return metrics

    def make_chained_step(self, data: torch.Tensor, batch_size: int,
                          k: int) -> Callable:
        """K steps on a dataset held on the device as one captured graph
        (``make_chained_step``, ``vae_trainer.py:217-250``).

        Returns ``chained(data, generator=None)``: ``data`` is the ``(N, 1,
        R, R, R)`` float32 dataset on the device, passed on every call and
        read in place (not copied; a new tensor is a new capture); each step
        draws ``batch_size`` indices uniformly with replacement, then its
        ``eps`` and quaternions, all before the dispatch.  Returns the loss
        terms stacked on a leading ``(k,)`` axis, oldest first; no host read
        between the K steps.
        """
        def chained(data_arg: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
            n = data_arg.shape[0]
            steps = []
            for _ in range(k):
                idx = self.indices(n, batch_size, generator)
                steps.append((idx, *self.draws(batch_size, generator)))

            def body(steps):
                return graphs.stack([
                    self._step(torch.index_select(data_arg, 0, idx), eps,
                               quats) for idx, eps, quats in steps])

            metrics = self._run(("chain", batch_size, k), body, steps,
                                resident=(data_arg,))
            self._iteration += k
            return metrics

        return chained
