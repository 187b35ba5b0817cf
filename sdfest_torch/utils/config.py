"""Config dicts: overlays and YAML output (counterpart of the part of
``sdfest_tpu/utils/config.py`` that the evaluation scripts call).

:func:`load_config` merges a dict overlay on top of a config (the ablation
loop of :mod:`sdfest_torch.scripts.rendering_evaluation`), and
:func:`save_config_to_file` writes a results file.  YAML files with
``config`` includes and the scripts' command lines are not ported yet
(ROADMAP section 1, item 9): a dict overlay may not hold a ``config`` key.
PyYAML is imported only when a file is written, so the module imports where
PyYAML is absent (the card's machine has none).
"""
from __future__ import annotations

import copy
import os
from typing import Optional


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    result = dict(base)
    for key, value in override.items():
        if key in result and isinstance(result[key], dict) and isinstance(
                value, dict):
            result[key] = _deep_merge(result[key], value)
        else:
            result[key] = value
    return result


def load_config(config: Optional[dict],
                current_dict: Optional[dict] = None) -> dict:
    """A config dict merged on top of ``current_dict`` (a deep copy of it;
    the overlay wins key by key, nested dicts merge)."""
    base = copy.deepcopy(current_dict) if current_dict else {}
    if config is None:
        return base
    if not isinstance(config, dict):
        raise NotImplementedError(
            "config files are not ported yet (ROADMAP section 1, item 9); "
            "pass a dict")
    if _has_include(config):
        raise NotImplementedError(
            "config includes are not ported yet (ROADMAP section 1, item 9)")
    return _deep_merge(base, copy.deepcopy(config))


def _has_include(config: dict) -> bool:
    return "config" in config or any(
        _has_include(v) for v in config.values() if isinstance(v, dict))


def save_config_to_file(path: str, config: dict) -> None:
    """Write a config dict to a YAML file (for reproducibility)."""
    import yaml

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_to_plain(config), f, default_flow_style=False,
                       sort_keys=False)


def _to_plain(obj):
    """Convert numpy scalars and arrays and torch tensors to plain Python for
    YAML dumping."""
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if hasattr(obj, "tolist"):  # numpy arrays and scalars, torch tensors
        return obj.tolist()
    return obj
