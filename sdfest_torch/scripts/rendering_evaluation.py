"""Randomized synthetic rendering evaluation and its ablation loop
(counterpart of ``Evaluator`` in
``sdfest_tpu/scripts/rendering_evaluation.py``).

For each mesh under ``data_path``: N random views (z-buffer depth renders,
on the host, from uniformly random camera orientations at a fixed distance),
the pipeline's ``__call__`` on them (on ``device``), the estimate's mesh
(``generate_mesh``), surface samples of the ground-truth and estimated
meshes, and the config's metrics on them (fully-qualified function names);
optionally pose errors against the known ground truth.  Ablation configs
overlay the base config one by one; per metric the mean, variance and
standard deviation over the files are reported, printed when
``out_folder`` is None, else written to a YAML file (needs PyYAML).

Metric names of the JAX package (``sdfest_tpu.pipeline.metrics.<name>``,
as in ``sdfest_torch/configs/estimation/rendering_evaluation.yaml``) resolve
by name to :mod:`sdfest_torch.pipeline.metrics`, importing nothing of the
JAX package.  Each file's host seconds of rasterizing, the call,
``generate_mesh`` and the metrics are kept in :attr:`Evaluator.timings`.

Command line (YAML with includes, PyYAML needed): ``python -m
sdfest_torch.scripts.rendering_evaluation --config
configs/estimation/rendering_evaluation_mug_procedural.yaml`` (the JAX
package's configs resolve by their package-relative names).  Without
PyYAML, build the config as a dict, e.g.
``sdfest_torch.utils.presets.preset("mug_procedural")`` plus the evaluation
keys, and call ``Evaluator(config, device=...).run()``.
"""
from __future__ import annotations

import argparse
import copy
import glob
import math
import os
import time
from collections import defaultdict
from datetime import datetime
from pydoc import locate
from typing import Dict, List

import numpy as np
import torch

from sdfest_torch.ops import quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import synthetic
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.utils.config import (
    load_config,
    load_config_from_args,
    save_config_to_file,
)
from sdfest_torch.utils.device import synchronize

DEFAULT_METRICS = {
    "chamfer": {
        "f": "sdfest_torch.pipeline.metrics.symmetric_chamfer",
        "kwargs": {},
    },
    "mean_accuracy": {
        "f": "sdfest_torch.pipeline.metrics.mean_accuracy",
        "kwargs": {},
    },
    "mean_completeness": {
        "f": "sdfest_torch.pipeline.metrics.mean_completeness",
        "kwargs": {},
    },
}

# metric modules of the upstream package and of the JAX package, whose
# functions the port's metrics module holds under the same names
_METRIC_MODULES = ("sdfest.estimation.metrics.", "sdfest_tpu.pipeline.metrics.")
_PORT_METRICS = "sdfest_torch.pipeline.metrics."


def glob_exts(path: str, exts: List[str]) -> List[str]:
    """All files under ``path`` (recursive) with one of the extensions."""
    files = []
    for ext in exts:
        files.extend(glob.glob(os.path.join(path, f"**/*{ext}"), recursive=True))
    return files


def _resolve_metric(name: str):
    """Resolve a fully-qualified metric name.  Names in the upstream or the
    JAX package's metrics module map by name to the port's, without
    importing the JAX package; any other name of the JAX package is
    refused."""
    for prefix in _METRIC_MODULES:
        if name.startswith(prefix):
            name = _PORT_METRICS + name[len(prefix):]
    if name.split(".")[0] == "sdfest_tpu":
        raise ValueError(f"Cannot resolve metric function {name}: the port "
                         "does not import the JAX package")
    fn = locate(name)
    if fn is None:
        raise ValueError(f"Cannot resolve metric function {name}")
    return fn


class Evaluator:
    """Evaluate the SDF pipeline on synthetic renders of mesh datasets."""

    def __init__(self, config: dict, device="cuda") -> None:
        self.base_config = config
        self.device = device
        self.cam = Camera(**config["camera"])
        self._rng = np.random.default_rng(config.get("seed", 0))
        # one dict of host seconds per evaluated file, in evaluation order
        self.timings: List[Dict[str, float]] = []

    def run(self) -> dict:
        """Run the evaluation (with optional ablation grid); returns results."""
        if self.base_config.get("ablation_configs"):
            ablation_results = {}
            for name, ablation_config in self.base_config[
                "ablation_configs"
            ].items():
                print(f"[ablation] {name}", flush=True)
                config = load_config(
                    ablation_config, copy.deepcopy(self.base_config)
                )
                self._rng = np.random.default_rng(config.get("seed", 0))
                ablation_results[name] = self._evaluate_config(config)
            self._save_and_print_results(ablation_results)
            return ablation_results
        results = self._evaluate_config(self.base_config)
        self._save_and_print_results(results)
        return results

    def _evaluate_config(self, config: dict) -> dict:
        raw = self.evaluate_config_raw(config)
        return {
            views: self._compute_metric_statistics(metrics_list)
            for views, metrics_list in raw.items()
        }

    def evaluate_config_raw(self, config: dict, files=None) -> dict:
        """Per-file metric dicts, keyed by view count (no aggregation).

        ``files`` restricts evaluation to a subset of the dataset (a shard
        of a multi-process sweep, whose raw lists merge before the
        statistics).
        """
        results_dict = {}
        self.pipeline = SDFPipeline(config, device=self.device)
        if files is None:
            files = sorted(glob_exts(config["data_path"], [".obj", ".off"]))
        for views in config["num_views"]:
            per_file = []
            for i, path in enumerate(files):
                t0 = time.monotonic()
                per_file.append(self._evaluate_file(path, views, config))
                print(
                    f"  views={views} file {i + 1}/{len(files)} "
                    f"({os.path.basename(path)}) "
                    f"{time.monotonic() - t0:.1f}s "
                    f"{self.timings[-1]}",
                    flush=True,
                )
            results_dict[views] = per_file
        return results_dict

    def _save_and_print_results(self, results_dict: Dict) -> None:
        out_folder = self.base_config.get("out_folder")
        if out_folder is None:
            print(results_dict)
            return
        os.makedirs(out_folder, exist_ok=True)
        run_name = self.base_config.get("run_name", "eval")
        filename = (
            f"rend_eval_{run_name}_"
            f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.yaml"
        )
        out_path = os.path.join(out_folder, filename)
        save_config_to_file(
            out_path, {**self.base_config, "results": results_dict}
        )
        print(f"Results saved to: {out_path}")

    @staticmethod
    def _compute_metric_statistics(metrics_list: List[Dict]) -> Dict:
        """Mean / variance / standard deviation per metric."""
        stats = defaultdict(lambda: {"mean": 0.0, "var": 0.0})
        for metrics in metrics_list:
            for name, val in metrics.items():
                stats[name]["mean"] += val
        for s in stats.values():
            s["mean"] /= len(metrics_list)
        for metrics in metrics_list:
            for name, val in metrics.items():
                stats[name]["var"] += (val - stats[name]["mean"]) ** 2
        for s in stats.values():
            s["var"] /= len(metrics_list)
            s["std"] = math.sqrt(s["var"])
        return dict(stats)

    def _generate_views(self, mesh: synthetic.Mesh, num_views: int) -> Dict:
        """Random views of a world-frame mesh; cameras at fixed distance.

        The camera arithmetic runs in float64 (the port's quaternion ops on
        CPU tensors); returns numpy ``depth_images (V, H, W)``, ``masks``,
        ``camera_positions (V, 3)`` and ``camera_orientations (V, 4)``."""
        views = defaultdict(list)
        distance = self.base_config["camera_distance"]
        mesh.position = np.zeros(3)
        mesh_position = mesh.position.copy()
        mesh_orientation = np.asarray(mesh.orientation, dtype=np.float64)
        f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64))

        while len(views["depth_images"]) < num_views:
            u = self._rng.random(3)
            camera_orientation = np.array(
                [
                    np.sqrt(1 - u[0]) * np.sin(2 * np.pi * u[1]),
                    np.sqrt(1 - u[0]) * np.cos(2 * np.pi * u[1]),
                    np.sqrt(u[0]) * np.sin(2 * np.pi * u[2]),
                    np.sqrt(u[0]) * np.cos(2 * np.pi * u[2]),
                ]
            )  # camera(ogl) -> world
            cam_q = f64(camera_orientation)
            camera_position = (
                f64(mesh_position)
                - quaternion.apply(cam_q, f64([0.0, 0.0, -distance]))
            ).numpy()
            # mesh pose in the (OpenCV-convention) rasterizer camera frame
            cam_cv_q = quaternion.multiply(cam_q, f64([1.0, 0.0, 0.0, 0.0]))
            mesh_orientation_cam = quaternion.multiply(
                quaternion.invert(cam_cv_q), f64(mesh_orientation)
            )
            mesh.position = np.array([0.0, 0.0, distance])
            mesh.orientation = mesh_orientation_cam.numpy()
            depth = synthetic.draw_depth_geometry(mesh, self.cam)
            if (depth != 0).any():
                views["depth_images"].append(depth.astype(np.float32))
                views["masks"].append(depth != 0)
                views["camera_positions"].append(
                    camera_position.astype(np.float32)
                )
                views["camera_orientations"].append(
                    camera_orientation.astype(np.float32)
                )
            else:
                print("Warning: invalid depth generated, skipping this sample")

        mesh.position = mesh_position
        mesh.orientation = mesh_orientation
        return {k: np.stack(v) for k, v in views.items()}

    def _estimate(self, inputs: Dict, log_path, config: dict):
        """The pipeline's ``__call__`` on one file's views."""
        return self.pipeline(
            **inputs,
            log_path=log_path,
            shape_optimization=config.get("shape_optimization", True),
        )

    def _evaluate_file(self, path: str, num_views: int, config: dict) -> dict:
        t0 = time.perf_counter()
        gt_mesh = synthetic.Mesh(
            path=path,
            scale=self.base_config["mesh_scale"],
            rel_scale=self.base_config.get("rel_scale", False),
            center=True,
        )
        inputs = self._generate_views(gt_mesh, num_views)
        t1 = time.perf_counter()
        log_folder = self.base_config.get("log_folder")
        log_path = None
        if log_folder:
            os.makedirs(log_folder, exist_ok=True)
            log_path = os.path.join(
                log_folder,
                datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f") + ".pkl",
            )

        position, orientation, scale, shape = self._estimate(
            inputs, log_path, config)
        synchronize(self.device)  # the call's device work ends here
        t2 = time.perf_counter()
        out_mesh = self.pipeline.generate_mesh(shape, scale, True)
        out_mesh.position = position[0].cpu().numpy()
        out_mesh.orientation = orientation[0].cpu().numpy()
        t3 = time.perf_counter()

        samples = self.base_config.get("samples", 20000)
        seed = self.base_config.get("seed", 0)
        gt_pts = synthetic.Mesh(
            vertices=gt_mesh.get_transformed_vertices(), faces=gt_mesh.faces,
            scale=1.0, rel_scale=True,
        ).sample_points_uniformly(samples, rng=np.random.default_rng(seed))
        out_pts = synthetic.Mesh(
            vertices=out_mesh.get_transformed_vertices(), faces=out_mesh.faces,
            scale=1.0, rel_scale=True,
        ).sample_points_uniformly(samples, rng=np.random.default_rng(seed))

        metrics_config = self.base_config.get("metrics", DEFAULT_METRICS)
        metric_dict = {}
        for metric_name, m in metrics_config.items():
            fn = _resolve_metric(m["f"])
            metric_dict[metric_name] = float(
                fn(gt_pts, out_pts, **m.get("kwargs", {}))
            )
        if config.get("pose_metrics"):
            # pose errors against the known synthetic ground truth (the
            # mesh at the world origin in its canonical frame); with
            # ``rotational_symmetry_axis`` also modulo the symmetry (the
            # NOCS convention for bowl / bottle / can)
            from scipy.spatial.transform import Rotation

            from sdfest_torch.pipeline import metrics as pose_metrics

            gt_rot = Rotation.from_quat(
                np.asarray(gt_mesh.orientation, dtype=np.float64)
            )
            pred_rot = Rotation.from_quat(
                np.asarray(out_mesh.orientation, dtype=np.float64)
            )
            metric_dict["position_error"] = float(
                np.linalg.norm(np.asarray(out_mesh.position))
            )
            metric_dict["orientation_deg"] = pose_metrics.degree_error(
                gt_rot, pred_rot
            )
            axis = config.get("rotational_symmetry_axis")
            if axis is not None:
                metric_dict["orientation_deg_sym"] = (
                    pose_metrics.degree_error(gt_rot, pred_rot, axis)
                )
        self.timings.append({
            "rasterize_s": t1 - t0, "call_s": t2 - t1, "mesh_s": t3 - t2,
            "metrics_s": time.perf_counter() - t3})
        return metric_dict


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Synthetic rendering evaluation.")
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument("--device", default="cuda")
    config = load_config_from_args(parser, argv)
    device = config.pop("device")
    Evaluator(config, device=device).run()


if __name__ == "__main__":
    main()
