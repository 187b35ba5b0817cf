"""Train the shape VAE (counterpart of ``sdfest_tpu/scripts/train_vae.py``).

    python -m sdfest_torch.scripts.train_vae --config configs/vae/mug_procedural.yaml
    python -m sdfest_torch.scripts.train_vae --preset vae_mug_procedural \\
        --dataset_path data/mug_procedural --iterations 1000

``--config`` reads YAML (with includes, resolved under ``sdfest_tpu/`` as
data; needs PyYAML), ``--preset`` a dict of :mod:`sdfest_torch.utils.presets`
(no PyYAML needed); any ``--dotted.key value`` overrides either.  The
loss, the pc render and the Adam step are
:class:`sdfest_torch.training.vae_trainer.VAETrainer`'s; checkpoints every
``checkpoint_iteration`` steps, ``checkpoint: <path>`` resumes (a checkpoint
of either package), and the final weights are written as flax msgpack with
their config.  ``--benchmark_steps N`` times N steps and exits.  Runs on
``--device`` (cuda unless asked otherwise), on one device.
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

import torch

from sdfest_torch.datasets.sdf_dataset import SDFDataset
from sdfest_torch.training.vae_trainer import VAETrainer
from sdfest_torch.utils import checkpoint as ckpt
from sdfest_torch.utils.config import _deep_merge, load_config_from_args
from sdfest_torch.utils.logging import make_logger
from sdfest_torch.utils.presets import preset


def make_trainer(config: dict, device) -> VAETrainer:
    """A :class:`VAETrainer` whose weights are PyTorch's initialization
    under ``config["seed"]`` (the global RNG is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.get("seed", 0))
        return VAETrainer(config, device=device)


def train(config: dict, device="cuda") -> dict:
    """Run VAE training; returns the model and config paths and the
    trainer."""
    iterations = config["iterations"]
    batch_size = config["batch_size"]
    run_name = config.get(
        "run_name",
        f"sdfvae_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S-%f')}")
    seed = config.get("seed", 0)
    dataset = SDFDataset(config["dataset_path"])
    trainer = make_trainer(config, device)
    if config.get("checkpoint"):
        meta = ckpt.load_checkpoint(config["checkpoint"], trainer)
        run_name = meta.get("run_name", run_name)
        print(f"Resumed from {config['checkpoint']} at iteration "
              f"{trainer.iteration}")
    # the data order and the draws fold in the start iteration, so a
    # resumed run does not repeat the replaced segment's stream
    batches = dataset.batches(batch_size, shuffle=True,
                              seed=seed + trainer.iteration)
    generator = torch.Generator(device=trainer.device).manual_seed(
        seed * 1_000_003 + trainer.iteration)
    writer = make_logger(config, run_name)
    model_dir = config.get("model_dir",
                           os.path.join(os.getcwd(), "models", run_name))
    checkpoint_iteration = config.get("checkpoint_iteration", 10000)
    start = time.time()
    while trainer.iteration < iterations:
        metrics = trainer.step(torch.from_numpy(next(batches)),
                               generator=generator)
        it = trainer.iteration
        if writer is not None and it % 20 == 0:
            for name, value in metrics.items():
                writer.add_scalar(name, float(value), it)
        if it % 100 == 0 or it == iterations:
            print(f"Iteration {it}/{iterations} "
                  f"loss {float(metrics['loss']):.4f}")
        if checkpoint_iteration and it % checkpoint_iteration == 0:
            ckpt.save_checkpoint(os.path.join(model_dir, f"{it}.ckpt"),
                                 trainer, it, run_name)
    print(f"Training took {time.time() - start:.1f}s")
    model_path, config_path = ckpt.save_model_and_config(
        model_dir, run_name, trainer.vae, config)
    print(f"Saved model to {model_path} (config: {config_path})")
    if writer is not None:
        writer.close()
    return {"model": model_path, "config": config_path, "trainer": trainer}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark(config: dict, steps: int = 30, device="cuda") -> float:
    """Mean seconds per training step over ``steps`` steps after 5 warm-up
    steps (host clock, the device synchronised at both ends)."""
    dataset = SDFDataset(config["dataset_path"])
    batches = dataset.batches(config["batch_size"], shuffle=True)
    trainer = make_trainer(config, device)
    generator = torch.Generator(device=trainer.device).manual_seed(
        config.get("seed", 0))
    for _ in range(5):
        trainer.step(torch.from_numpy(next(batches)), generator=generator)
    _synchronize(trainer.device)
    start = time.perf_counter()
    for _ in range(steps):
        trainer.step(torch.from_numpy(next(batches)), generator=generator)
    _synchronize(trainer.device)
    mean = (time.perf_counter() - start) / steps
    print(f"train step: {mean * 1000:.1f} ms "
          f"(batch {config['batch_size']}, {steps} steps)")
    return mean


def config_from_args(parser: argparse.ArgumentParser, argv=None) -> dict:
    """The config of a command line: ``--preset`` (a dict) or ``--config``
    (YAML files), with the dotted overrides on top."""
    config = load_config_from_args(parser, argv)
    name = config.pop("preset", None)
    return _deep_merge(preset(name), config) if name else config


def add_common_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", nargs="+", required=False,
                        help="YAML config files (needs PyYAML)")
    parser.add_argument("--preset", required=False,
                        help="a preset of sdfest_torch.utils.presets")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--benchmark_steps", type=int, default=0,
                        help="time N training steps and exit")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Train SDF shape VAE.")
    add_common_arguments(parser)
    config = config_from_args(parser, argv)
    device = config.pop("device")
    steps = int(config.pop("benchmark_steps", 0) or 0)
    if steps:
        benchmark(config, steps, device)
    else:
        train(config, device)


if __name__ == "__main__":
    main()
