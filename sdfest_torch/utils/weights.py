"""Parameter layout bridge: flax parameter trees to PyTorch ``state_dict``s.

The inverse of the layout map in ``sdfest_tpu/utils/convert_torch.py``:

- Dense ``kernel`` ``(in, out)`` -> Linear ``weight`` ``(out, in)``;
- Conv ``kernel`` ``(kD, kH, kW, in, out)`` -> Conv3d ``weight``
  ``(out, in, kD, kH, kW)``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and the
  ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``.

The port's modules use the flax module names (``fc_0``, ``conv_0``,
``linear_0``, ``bn_0``, ``final``), so a flax path ``a/b/kernel`` becomes the
torch key ``a.b.weight``.
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
