"""Training checkpoints and final model export (counterpart of
``sdfest_tpu/utils/checkpoint.py``).

A checkpoint is a trainer's state (module, Adam state, iteration) written
with ``torch.save``, plus ``<path>.meta.json`` with the iteration and run
name.  :func:`load_checkpoint` also takes a checkpoint of the JAX package
(flax msgpack), whose Adam state and iteration carry over
(:func:`sdfest_torch.utils.weights.load_flax_state`).

:func:`save_model_and_config` writes the final weights as flax msgpack
(``utils/msgpack_writer.py``), which the pipelines of both packages load,
beside a YAML config that names them.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from sdfest_torch.utils import msgpack_reader, msgpack_writer, weights


def save_checkpoint(path: str, trainer, iteration: int, run_name: str
                    ) -> None:
    """Write ``trainer.state_dict()`` under ``iteration`` and its metadata
    (the JAX package's keys; the trainers keep no epoch).  Inside a chained
    dispatch ``iteration`` is the step's and the state the dispatch's end,
    as the JAX scripts write it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = trainer.state_dict()
    state["iteration"] = int(iteration)
    torch.save(state, path)
    meta = {"iteration": int(iteration), "run_name": run_name, "epoch": 0}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)


def _is_zip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"PK"


def load_checkpoint(path: str, trainer) -> Dict[str, Any]:
    """Load a checkpoint of either package into ``trainer`` (its module,
    ``optimizer`` and ``iteration``), or a flax model file into its module
    only; returns the metadata."""
    meta = {"iteration": 0, "run_name": "unknown", "epoch": 0}
    if _is_zip(path):  # torch.save's format
        state = torch.load(path, map_location=trainer.device,
                           weights_only=True)
        trainer.load_state_dict(state)
        meta["iteration"] = trainer.iteration
    else:  # flax msgpack: a JAX training state, or model weights only
        module = trainer.vae if hasattr(trainer, "vae") else trainer.net
        tree = msgpack_reader.load(path)
        if "opt_state" in tree:
            trainer.iteration = weights.load_flax_state(
                tree, module, trainer.optimizer)
        else:
            weights.load_flax_into(module, tree)
        meta["iteration"] = trainer.iteration
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    return meta


def save_model_and_config(
    model_dir: str,
    run_name: str,
    module: torch.nn.Module,
    config: Dict,
) -> Tuple[str, str]:
    """Write the module's weights as ``<run_name>.msgpack`` (the flax tree:
    ``params``, or ``{"params", "batch_stats"}`` with BatchNorms) and
    ``<run_name>.yaml``, the config with ``model`` naming them."""
    from sdfest_torch.utils.config import save_config_to_file

    os.makedirs(model_dir, exist_ok=True)
    model_path = os.path.join(model_dir, f"{run_name}.msgpack")
    msgpack_writer.save(model_path, weights.torch_to_flax(module.state_dict()))
    config = dict(config)
    config["model"] = os.path.join(".", f"{run_name}.msgpack")
    config_path = os.path.join(model_dir, f"{run_name}.yaml")
    save_config_to_file(config_path, config)
    return model_path, config_path
