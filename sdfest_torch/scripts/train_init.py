"""Train the init network (counterpart of
``sdfest_tpu/scripts/train_init.py``).

    python -m sdfest_torch.scripts.train_init --config configs/init/mug_procedural_v3.yaml
    python -m sdfest_torch.scripts.train_init --preset init_mug_procedural_v3 \\
        --iterations 200 --replay_buffer_size 4096

The frozen VAE decoder (the ``vae`` config's ``model``) feeds the generated
views (:class:`sdfest_torch.datasets.generated.SDFVAEViewDataset`), each
dataset with the stable seed ``crc32(name)``; datasets of probability 0 are
skipped.  The real-data datasets (``NOCSDataset``, ``AnnotatedRedwoodDataset``)
load on the host, batched by a shuffling loader at a fixed point count and
trained without a latent target, as in the JAX package.  With
``replay_buffer_size > 0`` and one generated dataset, each replay unit
renders one generation batch into the ring on the device and takes
``replay_train_steps`` optimizer steps at ``replay_train_batch``
(:meth:`InitTrainer.replay_unit`); otherwise every step trains on a fresh
batch.  ``steps_per_dispatch`` (the JAX package's chaining of steps into one
compiled program) has no counterpart: units and steps run one after
another.  Checkpoints every ``checkpoint_iteration`` steps; ``resume: true``
continues from the latest ``<iteration>.ckpt`` in ``model_dir``,
``init_weights`` loads a checkpoint or a model file of either package; the
final weights and ``batch_stats`` are written as flax msgpack with the init
config.  Validation (``validation_iteration``) averages
``validation_batches`` fresh batches of each validation dataset.  Runs on
``--device`` (cuda unless asked otherwise), on one device.
"""
from __future__ import annotations

import argparse
import os
import time
import zlib
from datetime import datetime
from typing import Dict

import torch

from sdfest_torch.datasets.dataset_utils import (
    MultiDataLoader,
    ShuffledLoader,
    make_fixed_size_collate,
)
from sdfest_torch.datasets.generated import SDFVAEViewDataset
from sdfest_torch.models.vae import create_decoder_from_config
from sdfest_torch.scripts.train_vae import add_common_arguments, config_from_args
from sdfest_torch.training.init_trainer import InitTrainer
from sdfest_torch.utils import checkpoint as ckpt
from sdfest_torch.utils.device import resolve_device, synchronize
from sdfest_torch.utils.logging import make_logger
from sdfest_torch.utils.weights import load_decoder_weights

DATASET_TYPES = ("SDFVAEViewDataset", "NOCSDataset", "AnnotatedRedwoodDataset")


def data_seed(name: str) -> int:
    """A dataset's stable seed (not Python's ``hash``, which is salted per
    process)."""
    return zlib.crc32(name.encode()) % 2 ** 31


def _generator(device: torch.device, seed: int, offset: int = 0
               ) -> torch.Generator:
    """A generator on ``device`` seeded by ``seed`` with ``offset`` (the
    resume iteration) folded in."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + offset) % 2 ** 63)


class _GeneratedLoader:
    """Batch iterator of a generated dataset."""

    def __init__(self, dataset: SDFVAEViewDataset, batch_size: int,
                 seed: int = 0, seed_offset: int = 0):
        self._dataset = dataset
        self._batch_size = batch_size
        self.generator = _generator(dataset.device, seed, seed_offset)

    def __iter__(self):
        return self

    def __next__(self):
        return self._dataset.sample_batch(self._batch_size, self.generator)


class _RealLoader:
    """Batch iterator of a real-data dataset (NOCS, Redwood): its collated
    numpy batches as tensors, the labels the init network is trained on
    (no latent: the latent loss is left out, as in the JAX package)."""

    KEYS = ("pointset", "position", "scale", "orientation", "quaternion")

    def __init__(self, loader: ShuffledLoader):
        self._batches = iter(loader)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = next(self._batches)
        return {k: torch.as_tensor(v) for k, v in batch.items()
                if k in self.KEYS}


class Trainer:
    """The init network's training loop."""

    def __init__(self, config: dict, device="cuda"):
        self.device = resolve_device(device)
        self._config = config
        self._init_config = config.get("init", config)
        self._vae_config = config.get("vae", self._init_config.get("vae"))
        self._batch_size = self._init_config.get("batch_size", 32)
        self._iterations = self._init_config.get("iterations", 1000)
        self._num_points = self._init_config.get("num_points", 2500)
        self._run_name = config.get(
            "run_name",
            f"sdfest_init_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S-%f')}")
        self._model_dir = config.get(
            "model_dir", os.path.join(os.getcwd(), "models", self._run_name))
        # the trainer-level orientation representation goes into the head
        # and every dataset config, as in the reference
        orepr = self._init_config.get("orientation_repr")
        grid_res = self._init_config.get("orientation_grid_resolution")
        if orepr is not None:
            head = self._init_config.setdefault("head", {})
            head["orientation_repr"] = orepr
            if grid_res is not None:
                head["orientation_grid_resolution"] = grid_res
        category = self._init_config.get("category_str")
        if orepr is not None or category is not None:
            for groups in ("datasets", "validation_datasets"):
                for spec in self._init_config.get(groups, {}).values():
                    cfg = spec.setdefault("config_dict", {})
                    if orepr is not None:
                        cfg["orientation_repr"] = orepr
                        if grid_res is not None:
                            cfg["orientation_grid_resolution"] = grid_res
                    if category is not None:
                        cfg["category_str"] = category

        self.decoder = create_decoder_from_config(self._vae_config)
        load_decoder_weights(self.decoder, self._vae_config)
        self.decoder.to(self.device).eval().requires_grad_(False)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.get("seed", 0))
            self.trainer = InitTrainer(self._init_config,
                                       self._vae_config["latent_size"],
                                       device=self.device)
        self._generated_datasets: Dict[str, SDFVAEViewDataset] = {}

    # -- data --------------------------------------------------------------

    def _create_dataset(self, name: str, spec: dict, seed_offset: int = 0):
        dtype = spec["type"].split(".")[-1]
        if dtype not in DATASET_TYPES:
            raise ValueError(f"Unsupported dataset type {dtype}")
        cfg = dict(spec.get("config_dict", {}))
        if dtype == "SDFVAEViewDataset":
            cfg.setdefault("num_points", self._num_points)
            dataset = SDFVAEViewDataset(cfg, self.decoder, device=self.device)
            self._generated_datasets[name] = dataset
            return _GeneratedLoader(dataset, self._batch_size,
                                    seed=data_seed(name),
                                    seed_offset=seed_offset)
        if dtype == "NOCSDataset":
            from sdfest_torch.datasets.nocs_dataset import NOCSDataset

            dataset = NOCSDataset(cfg)
        else:
            from sdfest_torch.datasets.redwood_dataset import (
                AnnotatedRedwoodDataset,
            )

            dataset = AnnotatedRedwoodDataset(cfg)
        if len(dataset) < self._batch_size:
            # the shuffling loader drops the last partial batch: it would
            # never yield one
            raise ValueError(f"{name} holds {len(dataset)} samples, fewer "
                             f"than a batch of {self._batch_size}")
        return _RealLoader(ShuffledLoader(
            dataset, self._batch_size,
            collate=make_fixed_size_collate(self._num_points),
            seed=seed_offset))

    def _create_multi_data_loader(self, seed_offset: int = 0
                                  ) -> MultiDataLoader:
        # datasets of probability 0 are never drawn: not built, so configs
        # that disable the real-data loaders run without their trees
        loaders, probabilities = [], []
        for name, spec in self._init_config["datasets"].items():
            p = spec.get("probability", 1.0)
            if p <= 0.0:
                continue
            loaders.append(self._create_dataset(name, spec, seed_offset))
            probabilities.append(p)
        return MultiDataLoader(loaders, probabilities)

    def _create_validation_loaders(self) -> Dict[str, object]:
        if not self._init_config.get("validation_iteration", 0):
            return {}
        validation = {}
        for name, spec in self._init_config.get("validation_datasets",
                                                {}).items():
            if not spec or spec.get("probability", 1.0) <= 0.0:
                continue
            validation[name] = self._create_dataset(name, spec)
        return validation

    # -- run ---------------------------------------------------------------

    def benchmark(self, steps: int = 30) -> float:
        """Mean seconds per fresh-stream training step (generation and the
        step) over ``steps`` steps after 5 warm-up steps."""
        loader = self._create_multi_data_loader()
        for _ in range(5):
            self.trainer.step(next(loader))
        synchronize(self.device)
        start = time.perf_counter()
        for _ in range(steps):
            self.trainer.step(next(loader))
        synchronize(self.device)
        mean = (time.perf_counter() - start) / steps
        print(f"train step: {mean * 1000:.1f} ms "
              f"(batch {self._batch_size}, {steps} steps)")
        return mean

    def _resume(self) -> int:
        """The iteration of the latest ``<iteration>.ckpt`` in the model
        directory, loaded; 0 when there is none."""
        candidates = []
        if os.path.isdir(self._model_dir):
            for fname in os.listdir(self._model_dir):
                stem, ext = os.path.splitext(fname)
                if ext == ".ckpt" and stem.isdigit():
                    candidates.append((int(stem), fname))
        if not candidates:
            return 0
        path = os.path.join(self._model_dir, max(candidates)[1])
        meta = ckpt.load_checkpoint(path, self.trainer)
        print(f"Resumed from {path} at iteration {meta['iteration']}")
        # the interrupted segment wrote rows past this checkpoint
        _trim_scalar_csv(self._config.get("scalar_csv"), meta["iteration"])
        return int(meta["iteration"])

    def run(self) -> dict:
        cfg = self._init_config
        validation_iteration = cfg.get("validation_iteration", 0)
        checkpoint_iteration = cfg.get("checkpoint_iteration", 0)
        if cfg.get("init_weights"):
            ckpt.load_checkpoint(cfg["init_weights"], self.trainer)
            self.trainer.iteration = 0
            print(f"Loaded init weights from {cfg['init_weights']}")
        start_iteration = self._resume() if cfg.get("resume") else 0
        self.trainer.iteration = start_iteration
        # loaders after the resume: every stream folds in the resume point
        data_loader = self._create_multi_data_loader(
            seed_offset=start_iteration)
        validation_loaders = self._create_validation_loaders()
        writer = make_logger(self._config, self._run_name)

        active = [name for name, spec in cfg["datasets"].items()
                  if spec.get("probability", 1.0) > 0.0]
        replay_capacity = int(cfg.get("replay_buffer_size", 0) or 0)
        if replay_capacity > 0 and (
                len(active) != 1
                or active[0] not in self._generated_datasets):
            print("replay_buffer_size requires a single generated dataset; "
                  "falling back to fresh-stream training")
            replay_capacity = 0
        ring = None
        if replay_capacity > 0:
            dataset = self._generated_datasets[active[0]]
            t_train = int(cfg.get("replay_train_steps", 10) or 10)
            train_batch = int(cfg.get("replay_train_batch", 64)
                              or self._batch_size)
            ring = self.trainer.init_replay_buffer(
                replay_capacity, self._num_points,
                self._vae_config["latent_size"])
            generator = _generator(self.device, data_seed(active[0]),
                                   1 + start_iteration)

        if validation_iteration:
            self._validate(validation_loaders, writer, start_iteration)
        start = time.time()
        iteration = start_iteration
        while iteration < self._iterations:
            if ring is not None:
                chunk = self.trainer.replay_unit(
                    ring, dataset, self._batch_size, train_batch, t_train,
                    generator)
            else:
                chunk = [self.trainer.step(next(data_loader))]
            for metrics in chunk:
                iteration += 1
                if writer is not None and iteration % 20 == 0:
                    for name, value in metrics.items():
                        writer.add_scalar(name, float(value), iteration)
                if iteration % 100 == 0 or iteration == self._iterations:
                    print(f"Iteration {iteration}/{self._iterations} "
                          f"loss {float(metrics['loss']):.4f}")
                if validation_iteration and \
                        iteration % validation_iteration == 0:
                    self._validate(validation_loaders, writer, iteration)
                if checkpoint_iteration and \
                        iteration % checkpoint_iteration == 0:
                    ckpt.save_checkpoint(
                        os.path.join(self._model_dir, f"{iteration}.ckpt"),
                        self.trainer, iteration, self._run_name)
                if iteration >= self._iterations:
                    break
        print(f"Training took {time.time() - start:.1f}s")
        model_path, config_path = ckpt.save_model_and_config(
            self._model_dir, self._run_name, self.trainer.net,
            self._init_config)
        print(f"Saved model to {model_path} (config: {config_path})")
        if writer is not None:
            writer.close()
        return {"model": model_path, "config": config_path,
                "trainer": self.trainer}

    def _validate(self, validation_loaders, writer, iteration) -> None:
        n_batches = int(self._init_config.get("validation_batches", 4) or 1)
        for name, loader in validation_loaders.items():
            accum: Dict[str, float] = {}
            for _ in range(n_batches):
                batch = next(loader)
                if "latent_shape" not in batch:  # real data has no latent
                    batch["latent_shape"] = torch.zeros(
                        batch["pointset"].shape[0],
                        self._vae_config["latent_size"])
                for key, value in self.trainer.compute_metrics(
                        batch).items():
                    accum[key] = accum.get(key, 0.0) + value
            metrics = {k: v / n_batches for k, v in accum.items()}
            print(f"Validation [{name}] @ {iteration}: {metrics}")
            if writer is not None:
                for key, value in metrics.items():
                    writer.add_scalar(f"val/{name}/{key}", value, iteration)


def _trim_scalar_csv(path, start_iteration: int) -> None:
    """Drop the CSV rows past the resume point (they belong to the replaced
    segment of an interrupted run)."""
    if not path or not os.path.isfile(path):
        return
    with open(path) as f:
        header = f.readline()
        kept = [line for line in f if line.strip()
                and int(line.split(",", 1)[0]) <= start_iteration]
    with open(path, "w") as f:
        f.write(header)
        f.writelines(kept)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train init network.")
    add_common_arguments(parser)
    config = config_from_args(parser, argv)
    device = config.pop("device")
    steps = int(config.pop("benchmark_steps", 0) or 0)
    trainer = Trainer(config, device)
    if steps:
        trainer.benchmark(steps)
    else:
        trainer.run()


if __name__ == "__main__":
    main()
