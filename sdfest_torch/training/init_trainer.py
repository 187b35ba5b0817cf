"""Init-network trainer (counterpart of
``sdfest_tpu/training/init_trainer.py``).

The losses of ``InitTrainer._loss`` (``init_trainer.py:53-99``): MSE on
latent, position and scale, and the quaternion loss ``1 - <q1, q2>^2`` or
the cross-entropy over the SO(3) grid cells, each with a config weight;
the BatchNorms normalize with the batch in training and move their running
statistics as flax does (:class:`sdfest_torch.models.pointnet.BatchNorm`).
Validation metrics (``:308-384``) include the geodesic error of the
decoded orientation.

The replay ring (``:181-306``): a ring of generated samples on the device
(pointsets in bf16, rounded to nearest even as JAX rounds them; labels
float32 / int64).  A replay unit writes one generation batch at the cursor,
then takes ``replay_train_steps`` optimizer steps on uniform draws (with
replacement) from the filled part of the ring, as a plain loop.

Data parallelism (``step(..., group=)``, the counterpart of the JAX step's
``axis_name``): each rank steps on its block of the batch and normalizes
with its local batch statistics; the gradients, the loss terms and the
BatchNorms' new running statistics are averaged over the group with
``all_reduce`` (JAX's ``pmean`` of ``grads``, ``metrics`` and ``updates``,
``init_trainer.py:101-131``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.ops import quaternion
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.parallel.mesh import all_reduce_mean_
from sdfest_torch.utils.device import resolve_device

LABELS = ("latent_shape", "position", "scale", "orientation")


class ReplayRing:
    """The device-resident sample ring of replay training."""

    def __init__(self, capacity: int, num_points: int, latent_size: int,
                 discretized: bool, device: torch.device):
        self.capacity = capacity
        self.device = device
        self.store = {
            "pointset": torch.zeros(capacity, num_points, 3,
                                    dtype=torch.bfloat16, device=device),
            "latent_shape": torch.zeros(capacity, latent_size,
                                        device=device),
            "position": torch.zeros(capacity, 3, device=device),
            "scale": torch.zeros(capacity, device=device),
            "orientation": (torch.zeros(capacity, dtype=torch.int64,
                                        device=device) if discretized
                            else torch.zeros(capacity, 4, device=device)),
        }
        self.cursor = 0
        self.filled = 0

    def write(self, batch: Dict[str, torch.Tensor]) -> None:
        """Write a generation batch at the cursor (``capacity`` is a
        multiple of its size, so a write never wraps)."""
        n = batch["pointset"].shape[0]
        if self.capacity % n:
            raise ValueError(f"replay capacity {self.capacity} must be a "
                             f"multiple of the generation batch {n}")
        for key, store in self.store.items():
            store[self.cursor:self.cursor + n] = batch[key].to(store.dtype)
        self.cursor = (self.cursor + n) % self.capacity
        self.filled = min(self.filled + n, self.capacity)

    def draw(self, batch_size: int, generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        """A training batch of uniform draws from the filled rows."""
        idx = torch.randint(0, self.filled, (batch_size,),
                            generator=generator, device=self.device)
        batch = {k: v[idx] for k, v in self.store.items()}
        batch["pointset"] = batch["pointset"].to(torch.float32)
        return batch


class InitTrainer:
    """Trainer of :class:`sdfest_torch.models.pose_net.SDFPoseNet` on
    ``device`` ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, init_config: Dict[str, Any], latent_size: int,
                 device="cuda"):
        self.config = init_config
        self.device = resolve_device(device)
        self.net = create_pose_net(init_config, shape_dimension=latent_size
                                   ).to(self.device)
        self.orientation_repr = init_config["head"]["orientation_repr"]
        self.grid_quats = None
        if self.orientation_repr == "discretized":
            grid = SO3Grid(init_config["head"]["orientation_grid_resolution"])
            self.grid_quats = torch.as_tensor(grid.quaternions(),
                                              dtype=torch.float32,
                                              device=self.device)
        self.optimizer = torch.optim.Adam(
            self.net.parameters(), lr=init_config.get("learning_rate", 1e-3))
        self.iteration = 0

    # -- state -------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "iteration": self.iteration}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.net.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration = int(state["iteration"])

    # -- training ----------------------------------------------------------

    def _orientation_loss(self, orientation, target) -> torch.Tensor:
        if self.orientation_repr == "quaternion":
            return quaternion.simple_quaternion_loss(orientation, target)
        return F.cross_entropy(orientation, target.to(torch.int64))

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted loss of a training-mode forward pass (the
        BatchNorms' running statistics move once)."""
        cfg = self.config
        self.net.train()
        latent, position, scale, orientation = self.net(batch["pointset"])
        loss = torch.zeros((), device=self.device)
        metrics: Dict[str, torch.Tensor] = {}
        for name, pred, weight in (
                ("latent", latent, "latent_weight"),
                ("position", position, "position_weight"),
                ("scale", scale, "scale_weight")):
            key = "latent_shape" if name == "latent" else name
            if key in batch:
                term = torch.mean((pred - batch[key]) ** 2)
                metrics[f"loss_{name}"] = term
                loss = loss + cfg.get(weight, 1.0) * term
        if "orientation" in batch:
            term = self._orientation_loss(orientation, batch["orientation"])
            metrics["loss_orientation"] = term
            loss = loss + cfg.get("orientation_weight", 1.0) * term
        metrics["loss"] = loss
        return loss, metrics

    def step(self, batch: Dict[str, torch.Tensor], group=None
             ) -> Dict[str, torch.Tensor]:
        """One Adam step; returns the loss terms (detached 0-d tensors).

        With a process ``group`` the batch is this rank's block; the
        gradients, loss terms and BatchNorm running statistics are averaged
        over the group before the update."""
        batch = {k: v.to(self.device) for k, v in batch.items()
                 if k in ("pointset",) + LABELS}
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(batch)
        loss.backward()
        if group is not None:
            all_reduce_mean_([p.grad for p in self.net.parameters()], group)
            all_reduce_mean_(list(metrics.values()), group)
            all_reduce_mean_([b for b in self.net.buffers()
                              if b.is_floating_point()], group)
        self.optimizer.step()
        self.iteration += 1
        return {k: v.detach() for k, v in metrics.items()}

    def init_replay_buffer(self, capacity: int, num_points: int,
                           latent_size: int) -> ReplayRing:
        """An empty ring of ``capacity`` samples on the device (131,072
        samples of 2,500 bf16 points are ~2 GB)."""
        return ReplayRing(capacity, num_points, latent_size,
                          self.orientation_repr == "discretized",
                          self.device)

    def replay_unit(self, ring: ReplayRing, dataset, gen_batch: int,
                    train_batch: int, t_train: int,
                    generator: Optional[torch.Generator] = None
                    ) -> List[Dict[str, torch.Tensor]]:
        """One generation batch into the ring, then ``t_train`` optimizer
        steps on ``train_batch`` draws from it; returns each step's
        metrics."""
        ring.write(dataset.sample_batch(gen_batch, generator))
        return [self.step(ring.draw(train_batch, generator))
                for _ in range(t_train)]

    # -- inference and validation -----------------------------------------

    @torch.no_grad()
    def predict(self, pointsets: torch.Tensor):
        """Inference forward pass (running BatchNorm statistics)."""
        self.net.eval()
        return self.net(pointsets.to(self.device, torch.float32))

    @torch.no_grad()
    def compute_metrics(self, batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, float]:
        """Validation metrics, including the mean geodesic orientation
        error (one host read for all of them)."""
        batch = {k: v.to(self.device) for k, v in batch.items()
                 if torch.is_tensor(v)}
        latent, position, scale, orientation = self.predict(
            batch["pointset"])
        metrics = {
            "latent_mse": torch.mean((latent - batch["latent_shape"]) ** 2),
            "position_mse": torch.mean((position - batch["position"]) ** 2),
            "scale_mse": torch.mean((scale - batch["scale"]) ** 2),
            "position_error": torch.mean(torch.linalg.norm(
                position - batch["position"], dim=-1)),
            "scale_error": torch.mean(torch.abs(scale - batch["scale"])),
        }
        if self.orientation_repr == "quaternion":
            pred_q = orientation
        else:
            pred_q = self.grid_quats[torch.argmax(orientation, dim=-1)]
            if "orientation" in batch:
                metrics["orientation_ce"] = F.cross_entropy(
                    orientation, batch["orientation"].to(torch.int64))
        metrics["geodesic_distance"] = torch.mean(
            quaternion.geodesic_distance(pred_q, batch["quaternion"]))
        values = torch.stack(list(metrics.values())).cpu().tolist()
        return dict(zip(metrics, values))
