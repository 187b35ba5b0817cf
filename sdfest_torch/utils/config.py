"""Layered configs (counterpart of ``sdfest_tpu/utils/config.py``).

- A YAML mapping may hold a ``config`` key with one or more paths of other
  YAML files.  Includes resolve depth-first and merge in order; the
  including file's own keys override them, and later includes override
  earlier ones.
- An include may be a mapping whose string leaves are paths (a namespaced
  include, e.g. ``- vae: "./vae_models/mug.yaml"``): the file loads into
  that nested position.
- Paths resolve against the including file's directory (or the working
  directory), then ``.``, then the JAX package's directory, so that the
  configs under ``sdfest_tpu/configs/`` are read as data by their
  repository-relative names (``configs/vae/mug_procedural.yaml``).
- Command-line flags merge on top with the highest precedence; dotted names
  (``--a.b.c value``) make nested dicts.

:func:`load_config` merges a dict overlay (or a file) on top of a config,
:func:`save_config_to_file` writes one.  PyYAML is imported only where a
file is read (the card's machine has none); files are written by a small
emitter of plain dicts, lists and scalars.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
from typing import List, Optional, Sequence, Union

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_JAX_PACKAGE_DIR = os.path.join(_REPO_ROOT, "sdfest_tpu")


def default_search_paths(current_dir: Optional[str] = None) -> List[str]:
    """Search paths of config and resource files."""
    paths = [current_dir] if current_dir is not None else []
    return paths + [".", _JAX_PACKAGE_DIR]


def resolve_path(path: str,
                 search_paths: Optional[Sequence[str]] = None) -> str:
    """The first existing candidate of a possibly relative path under the
    search paths; the path itself when none exists."""
    path = os.path.expanduser(path)
    if os.path.isabs(path):
        return path
    if search_paths is None:
        search_paths = default_search_paths()
    for sp in search_paths:
        candidate = os.path.join(os.path.expanduser(sp), path)
        if os.path.exists(candidate):
            return candidate
    return path


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


def load_config_from_file(path: str,
                          search_paths: Optional[Sequence[str]] = None
                          ) -> dict:
    """Load a YAML config file, resolving nested ``config`` includes."""
    import yaml

    resolved = resolve_path(path, search_paths)
    with open(resolved) as f:
        raw = yaml.safe_load(f) or {}
    return _resolve_includes(raw, os.path.dirname(os.path.abspath(resolved)))


def _resolve_includes(config: dict, current_dir: Optional[str]) -> dict:
    if not isinstance(config, dict):
        return config
    config = {
        k: _resolve_includes(v, current_dir) if isinstance(v, dict) else v
        for k, v in config.items()
    }
    includes = config.pop("config", None)
    if includes is None:
        return config
    if isinstance(includes, str):
        includes = [includes]
    merged: dict = {}
    search = default_search_paths(current_dir)
    for inc in includes:
        if isinstance(inc, str):
            child = load_config_from_file(inc, search)
        elif isinstance(inc, dict):
            child = _load_namespaced_include(inc, search)
        else:
            raise ValueError(f"Unsupported config include entry: {inc!r}")
        merged = _deep_merge(merged, child)
    # the parent's own keys take precedence over included files
    return _deep_merge(merged, config)


def _load_namespaced_include(spec: dict, search_paths: Sequence[str]
                             ) -> dict:
    """Load a namespaced include: string leaves are paths, loaded in
    place."""
    out: dict = {}
    for key, value in spec.items():
        if isinstance(value, str):
            out[key] = load_config_from_file(value, search_paths)
        elif isinstance(value, dict):
            out[key] = _load_namespaced_include(value, search_paths)
        else:
            raise ValueError("Namespaced include leaves must be paths or "
                             f"dicts, got {value!r}")
    return out


def load_config(config: Union[str, dict, None],
                current_dict: Optional[dict] = None,
                search_paths: Optional[Sequence[str]] = None) -> dict:
    """A config (a path or a dict, includes resolved) merged on top of a
    deep copy of ``current_dict``: the overlay wins key by key, nested dicts
    merge."""
    base = copy.deepcopy(current_dict) if current_dict else {}
    if config is None:
        return base
    if isinstance(config, str):
        loaded = load_config_from_file(config, search_paths)
    else:
        loaded = _resolve_includes(copy.deepcopy(config), None)
    return _deep_merge(base, loaded)


def _set_dotted(d: dict, dotted_key: str, value) -> None:
    keys = dotted_key.split(".")
    for key in keys[:-1]:
        d = d.setdefault(key, {})
        if not isinstance(d, dict):
            raise ValueError(
                f"Cannot set nested key {dotted_key}: {key} is not a dict")
    d[keys[-1]] = value


def _parse_value(value: str):
    """A command-line value as YAML reads it (as JSON where PyYAML is
    absent); ``1e-4`` (a string to YAML 1.1) is a float."""
    try:
        import yaml
    except ImportError:
        try:
            parsed = json.loads(value)
        except ValueError:
            parsed = value
    else:
        try:
            parsed = yaml.safe_load(value)
        except yaml.YAMLError:
            return value
    if isinstance(parsed, str):
        try:
            return float(parsed)
        except ValueError:
            return parsed
    return parsed


def load_config_from_args(
    parser: Optional[argparse.ArgumentParser] = None,
    args: Optional[Sequence[str]] = None,
) -> dict:
    """Parse a command line into a config dict: ``--config file.yaml
    [file2.yaml ...]``, then the parser's own arguments, then any
    ``--dotted.key value`` overrides (highest precedence)."""
    if parser is None:
        parser = argparse.ArgumentParser()
    known, unknown = parser.parse_known_args(args)
    config: dict = {}
    config_files = getattr(known, "config", None)
    if config_files:
        if isinstance(config_files, str):
            config_files = [config_files]
        for cf in config_files:
            config = _deep_merge(config, load_config_from_file(cf))
    for key, value in vars(known).items():
        if key == "config" or value is None:
            continue
        _set_dotted(config, key, value)
    i = 0
    while i < len(unknown):
        token = unknown[i]
        if token.startswith("--"):
            key = token[2:]
            if "=" in key:
                key, value = key.split("=", 1)
                _set_dotted(config, key, _parse_value(value))
                i += 1
            elif i + 1 < len(unknown) and not unknown[i + 1].startswith(
                    "--"):
                _set_dotted(config, key, _parse_value(unknown[i + 1]))
                i += 2
            else:
                _set_dotted(config, key, True)
                i += 1
        else:
            i += 1
    return config


def save_config_to_file(path: str, config: dict) -> None:
    """Write a config dict to a YAML file (for reproducibility), without
    PyYAML: block YAML of plain dicts, lists and scalars, which PyYAML
    reads back as the same values."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(_yaml_text(_to_plain(config)))


def _yaml_scalar(v) -> str:
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            return {"nan": ".nan", "inf": ".inf", "-inf": "-.inf"}[repr(v)]
        text = repr(v)
        # YAML 1.1 reads "1e-05" as a string: give the mantissa a dot
        if "e" in text and "." not in text.split("e")[0]:
            mantissa, exponent = text.split("e")
            text = f"{mantissa}.0e{exponent}"
        return text
    return json.dumps(v)  # null, true/false, ints, double-quoted strings


def _yaml_text(obj, indent: int = 0) -> str:
    """Block YAML of plain dicts, lists and scalars."""
    pad = " " * indent
    lines = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            # scalar keys keep their type (the evaluation's results are
            # keyed by the number of views)
            k = _yaml_scalar(k if isinstance(k, (bool, int, float)) or k is
                             None else str(k))
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:\n" + _yaml_text(v, indent + 2))
            else:
                lines.append(f"{pad}{k}: "
                             + (("{}" if isinstance(v, dict) else "[]")
                                if isinstance(v, (dict, list))
                                else _yaml_scalar(v)) + "\n")
    else:
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}-\n" + _yaml_text(v, indent + 2))
            else:
                lines.append(f"{pad}- " + (
                    ("{}" if isinstance(v, dict) else "[]")
                    if isinstance(v, (dict, list)) else _yaml_scalar(v))
                    + "\n")
    return "".join(lines)


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
