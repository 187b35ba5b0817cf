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
float32 / int64) with its cursor and fill level as int32 device tensors.  A
replay unit writes one generation batch at the cursor, then takes
``replay_train_steps`` optimizer steps on uniform draws (with replacement)
from the filled part of the ring: row ``floor(u * filled)`` of a uniform
``u`` drawn before the step.

Single programs (the counterpart of the jitted ``train_step``,
``make_chained_step`` and ``make_replay_chained_step``, ``:133-305``): on
the card :meth:`InitTrainer.train_step` runs one step, the function of
:meth:`InitTrainer.make_chained_step` K steps of generation and training,
and that of :meth:`InitTrainer.make_replay_chained_step` K replay units, as
one captured CUDA graph each (:mod:`sdfest_torch.utils.graphs`; inside
``graphs.eager()`` and on the CPU the same body runs eagerly).  Every random
number of a dispatch (the dataset's ``draw`` of each generation batch, the
ring's row uniforms) is drawn before it, in the order the eager loop draws
them.  :meth:`InitTrainer.replay_unit` stays the plain loop of one unit.

Data parallelism (``step(..., group=)``, the counterpart of the JAX step's
``axis_name``): each rank steps on its block of the batch and normalizes
with its local batch statistics; the gradients, the loss terms and the
BatchNorms' new running statistics are averaged over the group with
``all_reduce`` (JAX's ``pmean`` of ``grads``, ``metrics`` and ``updates``,
``init_trainer.py:101-131``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.ops import quaternion
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.parallel.mesh import all_reduce_mean_
from sdfest_torch.training.optim import Adam
from sdfest_torch.utils import graphs
from sdfest_torch.utils.device import resolve_device

LABELS = ("latent_shape", "position", "scale", "orientation")


class ReplayRing:
    """The device-resident sample ring of replay training; ``cursor`` and
    ``filled`` are int32 0-d tensors on the device, as the JAX ring's."""

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
        self.cursor = torch.zeros((), dtype=torch.int32, device=device)
        self.filled = torch.zeros((), dtype=torch.int32, device=device)

    def tensors(self) -> List[torch.Tensor]:
        """What a write changes in place."""
        return list(self.store.values()) + [self.cursor, self.filled]

    def write(self, batch: Dict[str, torch.Tensor]) -> None:
        """Write a generation batch at the cursor (``capacity`` is a
        multiple of its size, so a write never wraps); no host read."""
        n = batch["pointset"].shape[0]
        if self.capacity % n:
            raise ValueError(f"replay capacity {self.capacity} must be a "
                             f"multiple of the generation batch {n}")
        rows = torch.arange(n, device=self.device) + self.cursor
        for key, store in self.store.items():
            store.index_copy_(0, rows, batch[key].to(store.dtype))
        self.cursor.copy_((self.cursor + n) % self.capacity)
        self.filled.copy_(torch.clamp(self.filled + n, max=self.capacity))

    def rows(self, u: torch.Tensor) -> torch.Tensor:
        """Rows ``floor(u * filled)`` (at most ``filled - 1``) for uniforms
        ``u`` in ``[0, 1)``: uniform draws with replacement from the filled
        rows (JAX's ``randint(0, filled)``, ``init_trainer.py:264``)."""
        filled = self.filled.to(torch.int64)
        return torch.minimum(torch.floor(u * self.filled).to(torch.int64),
                             filled - 1)

    def gather(self, rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A training batch of the ring's ``rows`` (pointsets in float32)."""
        batch = {k: torch.index_select(v, 0, rows)
                 for k, v in self.store.items()}
        batch["pointset"] = batch["pointset"].to(torch.float32)
        return batch

    def uniforms(self, batch_size: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        """The uniforms of one training batch's rows."""
        return torch.rand(batch_size, generator=generator,
                          device=self.device)

    def draw(self, batch_size: int, generator: Optional[torch.Generator]
             ) -> Dict[str, torch.Tensor]:
        """A training batch of uniform draws from the filled rows."""
        return self.gather(self.rows(self.uniforms(batch_size, generator)))


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
        self.optimizer = Adam(self.net.parameters(),
                              lr=init_config.get("learning_rate", 1e-3))
        self.iteration = 0
        self.graphs = graphs.GraphCache(
            warm_up_runs=graphs.TRAIN_WARM_UP_RUNS)

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

    def _batch(self, batch: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """The entries the loss reads, on the device; floating ones in the
        network's dtype."""
        dtype = next(self.net.parameters()).dtype
        return {k: v.to(self.device, dtype) if v.is_floating_point()
                else v.to(self.device) for k, v in batch.items()
                if k in ("pointset",) + LABELS}

    def state_tensors(self) -> List[torch.Tensor]:
        """What a step writes in place: the parameters, the BatchNorms'
        statistics and Adam's state."""
        return (list(self.net.parameters()) + list(self.net.buffers())
                + self.optimizer.state_tensors())

    def _step(self, batch: Dict[str, torch.Tensor], group=None
              ) -> Dict[str, torch.Tensor]:
        """One Adam step on a batch: the body of :meth:`step`,
        :meth:`train_step` and each step of a chain.  No host read."""
        batch = self._batch(batch)
        params = self.optimizer.params()
        loss, metrics = self.loss(batch)
        grads = list(torch.autograd.grad(loss, params, allow_unused=True,
                                         materialize_grads=True))
        if group is not None:
            all_reduce_mean_(grads, group)
            all_reduce_mean_(list(metrics.values()), group)
            all_reduce_mean_([b for b in self.net.buffers()
                              if b.is_floating_point()], group)
        # left in .grad as backward() leaves them (inside a graph: tensors
        # of its pool, which each replay rewrites)
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.update(grads)
        return {k: v.detach() for k, v in metrics.items()}

    def _run(self, key, body: Callable, inputs,
             state: Sequence[torch.Tensor] = ()):
        """``body(inputs)`` as a captured graph on the card (keyed by
        ``key`` and the inputs' shapes), eagerly on the CPU or inside
        ``graphs.eager()``; returns the metrics (the caller's own)."""
        self.optimizer.init_state()
        return graphs.clone(self.graphs.call(
            key, body, inputs, self.device,
            state=self.state_tensors() + list(state)))

    def step(self, batch: Dict[str, torch.Tensor], group=None
             ) -> Dict[str, torch.Tensor]:
        """One eager Adam step; returns the loss terms (detached 0-d
        tensors).

        With a process ``group`` the batch is this rank's block; the
        gradients, loss terms and BatchNorm running statistics are averaged
        over the group before the update."""
        self.optimizer.init_state()
        metrics = self._step(batch, group)
        self.iteration += 1
        return metrics

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """:meth:`step` as one captured graph on the card (the jitted
        ``train_step``); the batch is copied into the graph's inputs."""
        metrics = self._run(("step",), self._step, self._batch(batch))
        self.iteration += 1
        return metrics

    def make_chained_step(self, dataset, batch_size: int, k: int
                          ) -> Callable:
        """K steps of generation and training on a fresh batch as one
        captured graph (``make_chained_step``, ``init_trainer.py:140-162``).

        Returns ``chained(generator=None)``: the K batches' draws are taken
        from ``generator`` before the dispatch
        (``dataset.draw``), the views rendered inside it
        (``dataset.views_from_draws``); returns the loss terms stacked on a
        leading ``(k,)`` axis, oldest first."""
        def chained(generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
            draws = [dataset.draw(batch_size, generator) for _ in range(k)]

            def body(draws):
                return graphs.stack([
                    self._step(dataset.views_from_draws(d)) for d in draws])

            metrics = self._run(("chain", dataset, batch_size, k), body,
                                draws)
            self.iteration += k
            return metrics

        return chained

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
        metrics (the eager loop of one unit)."""
        ring.write(dataset.sample_batch(gen_batch, generator))
        return [self.step(ring.draw(train_batch, generator))
                for _ in range(t_train)]

    def make_replay_chained_step(self, dataset, gen_batch: int,
                                 train_batch: int, t_train: int, k: int
                                 ) -> Callable:
        """K replay units as one captured graph
        (``make_replay_chained_step``, ``init_trainer.py:204-305``).

        Returns ``chained(ring, generator=None)``: per unit the generation
        batch's draws, then the row uniforms of its ``t_train`` training
        batches, taken from ``generator`` before the dispatch in the order
        :meth:`replay_unit` draws them; inside it each unit writes its
        batch at the ring's cursor and takes ``t_train`` steps on rows of
        the filled part.  The ring is written in place.  Returns the loss
        terms stacked on a leading ``(k * t_train,)`` axis, oldest first.
        """
        def chained(ring: ReplayRing,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
            if ring.capacity % gen_batch:
                raise ValueError(f"replay capacity {ring.capacity} must be "
                                 f"a multiple of gen_batch {gen_batch}")
            units = []
            for _ in range(k):
                draws = dataset.draw(gen_batch, generator)
                units.append((draws, [ring.uniforms(train_batch, generator)
                                      for _ in range(t_train)]))

            def body(units):
                steps = []
                for draws, uniforms in units:
                    ring.write(dataset.views_from_draws(draws))
                    steps.extend(self._step(ring.gather(ring.rows(u)))
                                 for u in uniforms)
                return graphs.stack(steps)

            metrics = self._run(
                ("replay", dataset, gen_batch, train_batch, t_train, k),
                body, units, state=ring.tensors())
            self.iteration += k * t_train
            return metrics

        return chained

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
