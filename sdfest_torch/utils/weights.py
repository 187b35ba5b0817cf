"""Parameter layout bridge between flax trees and PyTorch modules, both
ways.

flax -> torch is the inverse of the layout map in
``sdfest_tpu/utils/convert_torch.py``:

- Dense ``kernel`` ``(in, out)`` -> Linear ``weight`` ``(out, in)``;
- Conv ``kernel`` ``(kD, kH, kW, in, out)`` -> Conv3d ``weight``
  ``(out, in, kD, kH, kW)``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

The port's modules use the flax module names (``fc_0``, ``conv_0``,
``linear_0``, ``bn_0``, ``final``), so a flax path ``a/b/kernel`` becomes the
torch key ``a.b.weight``.  :func:`torch_to_flax` is the inverse
(``num_batches_tracked`` has no flax counterpart and is dropped).

Training state: a JAX trainer's ``{"params", "batch_stats", "opt_state",
"iteration"}`` tree, with optax's Adam state ``opt_state["0"]`` =
``{"count", "mu", "nu"}`` in the parameters' layout, maps to a module, a
``torch.optim.Adam`` (``step``, ``exp_avg``, ``exp_avg_sq``) and the
iteration (:func:`load_flax_state`), so a JAX checkpoint resumes in the
port.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from sdfest_torch.utils import msgpack_reader

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _leaf_to_torch(name: str, arr: np.ndarray):
    arr = np.asarray(arr)
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 5:
            return "weight", np.transpose(arr, (4, 3, 0, 1, 2))
        raise ValueError(f"unsupported kernel rank {arr.ndim}")
    return {"bias": "bias", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}[name], arr


def flax_to_torch(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree (numpy leaves) to a torch ``state_dict``.

    ``tree`` is either a ``params`` tree or a ``{"params": ...,
    "batch_stats": ...}`` variables dict; both collections merge into one
    state dict.
    """
    collections = (
        [tree[k] for k in ("params", "batch_stats") if k in tree]
        if "params" in tree else [tree]
    )
    state: Dict[str, torch.Tensor] = {}
    for coll in collections:
        for path, arr in msgpack_reader.leaves(coll):
            name, value = _leaf_to_torch(path[-1], arr)
            key = ".".join(path[:-1] + (name,))
            state[key] = torch.from_numpy(np.array(value, order="C"))
    return state


def _leaf_to_flax(name: str, value: np.ndarray):
    if name == "weight":
        if value.ndim == 2:
            return "kernel", value.T
        if value.ndim == 5:
            return "kernel", np.transpose(value, (2, 3, 4, 1, 0))
        return "scale", value
    return {"bias": "bias", "running_mean": "mean", "running_var": "var"}[
        name], value


def _insert(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def torch_to_flax(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Map a torch ``state_dict`` (or a dict of same-keyed tensors) to the
    flax tree: ``{"params": ..., "batch_stats": ...}`` when it holds
    BatchNorm running statistics, else the ``params`` tree."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, tensor in tensors.items():
        *path, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        flax_name, value = _leaf_to_flax(
            name, tensor.detach().cpu().numpy())
        target = stats if name.startswith("running_") else params
        _insert(target, tuple(path) + (flax_name,),
                np.ascontiguousarray(value))
    return {"params": params, "batch_stats": stats} if stats else params


def load_flax_state(state: Dict[str, Any], module: torch.nn.Module,
                    optimizer: Optional[torch.optim.Adam] = None) -> int:
    """Load a JAX trainer's state tree (numpy leaves) into ``module`` and
    ``optimizer``; returns its iteration.

    ``state["params"]`` (and ``state["batch_stats"]``) go into the module,
    optax's Adam moments and count into the optimizer's ``exp_avg``,
    ``exp_avg_sq`` and ``step`` of every parameter.
    """
    variables = {"params": state["params"]}
    if state.get("batch_stats"):
        variables["batch_stats"] = state["batch_stats"]
    load_flax_into(module, variables)
    if optimizer is not None:
        adam = state["opt_state"]["0"]
        mu = flax_to_torch(adam["mu"])
        nu = flax_to_torch(adam["nu"])
        step = torch.tensor(float(np.asarray(adam["count"])),
                            dtype=torch.float32)
        for name, p in module.named_parameters():
            optimizer.state[p] = {
                "step": step.clone(),
                "exp_avg": mu[name].to(p.device, p.dtype).contiguous(),
                "exp_avg_sq": nu[name].to(p.device, p.dtype).contiguous(),
            }
    return int(np.asarray(state.get("iteration", 0)))


def load_flax_into(module: torch.nn.Module, tree: Dict[str, Any]) -> None:
    """Load a flax tree into ``module``; every parameter must be covered.

    BatchNorm's ``num_batches_tracked`` counter has no flax counterpart and
    is the only key allowed to stay at its initial value.
    """
    result = module.load_state_dict(flax_to_torch(tree), strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise ValueError(
            f"weight mismatch: missing {missing}, unexpected "
            f"{result.unexpected_keys}"
        )


def resolve_model_path(config: Dict[str, Any]) -> Optional[str]:
    """Path of a config's ``model`` weights (repo-relative or absolute)."""
    model = config.get("model")
    if model is None:
        return None
    for base in ("", _REPO_ROOT):
        candidate = os.path.join(base, model) if base else model
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f"Model weights {model} not found.")
