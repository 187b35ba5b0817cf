"""A cell of the benchmark, resolved from ``BENCHMARK.json`` and the files
named after its parts: ``configs/<config>.json``, ``traffic/<traffic>.json``
and one ``metrics/<metric>.py`` per per-layer metric.  A new cell, mix or
metric is new files and new entries; no code here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: str
    bench_dir: str = BENCH_DIR

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its
    ``workloads`` lists, or without that key every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: str, bench_dir: str = BENCH_DIR,
            spec: Optional[Dict] = None) -> Cell:
    """The cell called ``name`` of ``root/BENCHMARK.json`` (or of
    ``spec``, a file's contents); raises ``KeyError`` for a name it does
    not list."""
    if spec is None:
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_json(os.path.join(bench_dir, "configs",
                                    entry["config"] + ".json"))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     entry["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), config, traffic, e2e, per_layer,
                root, bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
