"""Category-level pose-and-shape evaluation on REAL275 / REDWOOD75
(counterpart of ``sdfest_tpu/scripts/category_evaluation.py``).

For every dataset sample: the estimation pipeline registered for the
sample's category (its ``__call__`` on ``device``), the predicted surface
mesh (``generate_mesh``), and pose and shape scores:

- **correctness grids** (NOCS-style mAP table entries): the share of samples
  within every combination of the config's position / degree / IoU-3D
  thresholds (IoU25, IoU50, 5deg5cm, 10deg10cm by default), symmetry-aware
  for the rotation-symmetric NOCS categories (bottle, bowl, can);
- **continuous means**: position error (m), orientation error (deg),
  oriented-box 3D IoU, and every reconstruction metric of the config's
  ``metrics`` map (fully-qualified names; the JAX package's
  ``sdfest_tpu.pipeline.metrics.<name>`` resolve to the port's metrics).

The pipeline estimates in its own camera convention (OpenGL: y up, looking
down -z); the samples hold the ground truth in OpenCV's (as
:func:`_make_dataset` loads them, and as an injected dataset must give it),
so each estimate is converted to OpenCV before it is scored.  The JAX
package's evaluator scores the OpenGL estimate as it is.

Results are aggregated per category and overall ("all"), printed when
``out_folder`` is None, else written to YAML.  A failed estimate (no depth
inside the mask, an empty reconstruction) counts as incorrect with
correctness 0 and is left out of the continuous means, as in the NOCS
protocol.  Each evaluated sample's host seconds of the call,
``generate_mesh`` and the metrics are kept in
:attr:`CategoryEvaluator.timings`.

``category_configs`` maps a category to its model config: a path (resolved
against ``config_dir``, by default the port's
``sdfest_torch/configs/estimation/``; PyYAML needed) or a dict merged as is
(``sdfest_torch.utils.presets.preset("real275_evaluation_procedural")``, for
machines without PyYAML).

Command line (PyYAML needed): ``python -m
sdfest_torch.scripts.category_evaluation --config
configs/estimation/real275_evaluation.yaml --data_path ./data/nocs
--out_folder ./results [--device cpu]``.
"""
from __future__ import annotations

import argparse
import os
import time
from collections import defaultdict
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from sdfest_torch.ops import pointset
from sdfest_torch.pipeline import metrics as metrics_module
from sdfest_torch.pipeline import synthetic
from sdfest_torch.pipeline.pipeline import NoDepthError, SDFPipeline
from sdfest_torch.scripts.rendering_evaluation import _resolve_metric
from sdfest_torch.utils.config import (
    default_search_paths,
    load_config,
    load_config_from_args,
    save_config_to_file,
)
from sdfest_torch.utils.device import synchronize

# the port's packaged estimation configs (a copy of the JAX package's), where
# the evaluation YAMLs' "./models/mug.yaml" entries resolve
_ESTIMATION_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "estimation",
)

# the camera convention of the pipeline's estimates, and that of the samples
# (the ground truth) it is scored against
PIPELINE_CONVENTION = "opengl"
SAMPLE_CONVENTION = "opencv"

# NOCS convention: bottle / bowl / can are rotation-symmetric about the
# object-frame up axis; after the default remap (remap_y_axis: y) that is
# axis 1.  Overridable via the config's ``symmetry_axes`` map.
DEFAULT_SYMMETRY_AXES = {"bottle": 1, "bowl": 1, "can": 1}

# NOCS-style correctness table: IoU25 / IoU50 plus the deg/cm grid.
DEFAULT_CORRECTNESS = {
    "iou_3d": {"iou_3d_thresholds": [0.25, 0.5]},
    "deg_cm": {
        "degree_thresholds": [5.0, 10.0],
        "position_thresholds": [0.05, 0.10],
    },
}


def _make_dataset(config: dict):
    """The dataset named by ``config["dataset"]``, with the extents-bearing
    ``full`` scale convention (the IoU-3D metrics need extents)."""
    name = config["dataset"]
    data_path = config["data_path"]
    if name in ("real275", "nocs"):
        from sdfest_torch.datasets.nocs_dataset import NOCSDataset

        return NOCSDataset(
            {
                "root_dir": data_path,
                "split": config.get("split", "real_test"),
                "camera_convention": SAMPLE_CONVENTION,
                "scale_convention": "full",
                "remap_y_axis": config.get("remap_y_axis", "y"),
                "remap_x_axis": config.get("remap_x_axis", "-z"),
                "mask_pointcloud": True,
            }
        )
    if name == "redwood":
        from sdfest_torch.datasets.redwood_dataset import (
            AnnotatedRedwoodDataset,
        )

        return AnnotatedRedwoodDataset(
            {
                "root_dir": data_path,
                "ann_dir": config["ann_dir"],
                "camera_convention": SAMPLE_CONVENTION,
                "scale_convention": "full",
                "remap_y_axis": config.get("remap_y_axis", "y"),
                "remap_x_axis": config.get("remap_x_axis", "-z"),
            }
        )
    raise ValueError(f"Unsupported dataset {name!r} for category evaluation.")


def _to_sample_convention(position, orientation):
    """The pipeline's estimate (its first row), in its camera convention
    (OpenGL: y up, looking down -z), as float64 numpy in the samples'
    (OpenCV, as :func:`_make_dataset` loads them): ``(position (3,),
    quaternion (4,))``."""
    position = torch.as_tensor(position).detach().cpu().to(torch.float64)
    orientation = torch.as_tensor(orientation).detach().cpu().to(
        torch.float64)
    position = pointset.change_position_camera_convention(
        position[0], PIPELINE_CONVENTION, SAMPLE_CONVENTION)
    orientation = pointset.change_orientation_camera_convention(
        orientation[0], PIPELINE_CONVENTION, SAMPLE_CONVENTION)
    return position.numpy(), orientation.numpy()


class CategoryEvaluator:
    """Evaluate per-category pipelines on an annotated RGB-D dataset.

    ``dataset`` and ``pipelines`` may be given (tests, in-memory samples);
    by default the dataset comes from the config and the pipelines are
    built on ``device`` lazily per category from ``category_configs``
    (categories without an entry are skipped, as in the reference's
    evaluation configs).
    """

    def __init__(
        self,
        config: dict,
        dataset=None,
        pipelines: Optional[Dict[str, SDFPipeline]] = None,
        device="cuda",
    ) -> None:
        self.config = config
        self.device = device
        self.dataset = dataset if dataset is not None else _make_dataset(config)
        self._pipelines: Dict[str, Optional[SDFPipeline]] = dict(
            pipelines or {})
        self._symmetry = {
            **DEFAULT_SYMMETRY_AXES,
            **(config.get("symmetry_axes") or {}),
        }
        self._correctness = config.get("correctness") or DEFAULT_CORRECTNESS
        self._metrics = config.get("metrics", {})
        self._samples = config.get("samples", 20000)
        self._gt_mesh_metric = config.get(
            "gt_mesh_metric", config.get("dataset") == "redwood"
        )
        # host seconds per evaluated sample: the call, generate_mesh, metrics
        self.timings: List[Dict[str, float]] = []

    # -- per-category pipeline ----------------------------------------------
    def _pipeline_for(self, category: str) -> Optional[SDFPipeline]:
        if category in self._pipelines:
            return self._pipelines[category]
        category_configs = self.config.get("category_configs") or {}
        if category not in category_configs:
            self._pipelines[category] = None
            return None
        search = default_search_paths(
            self.config.get("config_dir", _ESTIMATION_CONFIG_DIR)
        )
        pipeline_config = load_config(category_configs[category],
                                      dict(self.config), search_paths=search)
        self._pipelines[category] = SDFPipeline(pipeline_config,
                                                device=self.device)
        return self._pipelines[category]

    # -- ground truth -------------------------------------------------------
    def _gt_mesh(self, sample: dict) -> Optional[synthetic.Mesh]:
        obj_path = sample.get("obj_path")
        if not obj_path:
            return None
        vertices, faces = self.dataset.load_mesh(obj_path)
        if self._gt_mesh_metric:
            mesh = synthetic.Mesh(
                vertices=vertices, faces=faces, scale=1.0, rel_scale=True
            )
        else:
            # normalized CAD model: scale uniformly so the half-max-extent
            # matches the annotated extents (NOCS normalization)
            extents = np.asarray(sample["scale"], np.float64).reshape(-1)
            mesh = synthetic.Mesh(
                vertices=vertices,
                faces=faces,
                scale=float(np.max(extents)) / 2.0,
                rel_scale=False,
            )
        mesh.position = np.asarray(sample["position"], np.float64)
        mesh.orientation = np.asarray(sample["quaternion"], np.float64)
        return mesh

    # -- one sample ---------------------------------------------------------
    def evaluate_sample(self, sample: dict) -> Optional[dict]:
        """Run the category's pipeline on one sample; returns the error
        dict, None when the category has no pipeline.  A failed estimate
        returns ``{"failed": True, ...}`` (IoU 0, infinite errors)."""
        category = sample["category_str"]
        pipeline = self._pipeline_for(category)
        if pipeline is None:
            return None
        sym_axis = self._symmetry.get(category)
        record = {"category": category, "failed": False}
        t0 = time.perf_counter()
        try:
            position, orientation, scale, latent = pipeline(
                np.asarray(sample["depth"], np.float32),
                np.asarray(sample["mask"]),
            )
            synchronize(self.device)
            t1 = time.perf_counter()
            out_mesh = pipeline.generate_mesh(latent, scale, True)
            if out_mesh is None:
                raise ValueError("empty reconstruction")
        except (NoDepthError, ValueError):
            record.update(
                failed=True,
                position_error=float("inf"),
                degree_error=float("inf"),
                iou_3d=0.0,
            )
            return record
        t2 = time.perf_counter()

        pos_pred, quat_pred = _to_sample_convention(position, orientation)
        rot_pred = Rotation.from_quat(quat_pred)
        bbox_min = out_mesh.vertices.min(axis=0)
        bbox_max = out_mesh.vertices.max(axis=0)
        extent_pred = bbox_max - bbox_min
        # the predicted box is the mesh's object-frame bbox: its centre in
        # the camera frame is position + R * (bbox centre)
        box_center_pred = pos_pred + rot_pred.apply((bbox_min + bbox_max) / 2.0)
        pos_gt = np.asarray(sample["position"], np.float64)
        rot_gt = Rotation.from_quat(np.asarray(sample["quaternion"], np.float64))
        extent_gt = np.asarray(sample["scale"], np.float64).reshape(-1)

        record["position_error"] = float(np.linalg.norm(pos_gt - pos_pred))
        record["degree_error"] = metrics_module.degree_error(
            rot_gt, rot_pred, sym_axis
        )
        record["iou_3d"] = float(
            metrics_module.symmetric_box_iou(
                extent_gt, pos_gt, rot_gt,
                extent_pred, box_center_pred, rot_pred,
                sym_axis,
            )
        )

        gt_mesh = self._gt_mesh(sample)
        if gt_mesh is not None and self._metrics:
            rng_seed = self.config.get("seed", 0)
            out_mesh.position = pos_pred
            out_mesh.orientation = quat_pred
            gt_pts = gt_mesh.sample_points_uniformly(
                self._samples, rng=np.random.default_rng(rng_seed)
            )
            out_pts = out_mesh.sample_points_uniformly(
                self._samples, rng=np.random.default_rng(rng_seed)
            )
            for name, m in self._metrics.items():
                fn = _resolve_metric(m["f"])
                record[name] = float(fn(gt_pts, out_pts, **m.get("kwargs", {})))
        self.timings.append({"call": t1 - t0, "generate_mesh": t2 - t1,
                             "metrics": time.perf_counter() - t2})
        return record

    # -- correctness grids --------------------------------------------------
    def _correctness_bits(self, record: dict) -> Dict[str, int]:
        """Evaluate every configured threshold combination on one record."""
        bits = {}
        for grid_name, grid in self._correctness.items():
            pos_ts = grid.get("position_thresholds", [None])
            deg_ts = grid.get("degree_thresholds", [None])
            iou_ts = grid.get("iou_3d_thresholds", [None])
            for pos_t in pos_ts:
                for deg_t in deg_ts:
                    for iou_t in iou_ts:
                        ok = not record["failed"]
                        if ok and pos_t is not None:
                            ok = record["position_error"] <= pos_t
                        if ok and deg_t is not None:
                            ok = record["degree_error"] <= deg_t
                        if ok and iou_t is not None:
                            ok = record["iou_3d"] >= iou_t
                        parts = [grid_name]
                        if deg_t is not None:
                            parts.append(f"{deg_t:g}deg")
                        if pos_t is not None:
                            parts.append(f"{100 * pos_t:g}cm")
                        if iou_t is not None:
                            parts.append(f"iou{100 * iou_t:g}")
                        bits["_".join(parts)] = int(ok)
        return bits

    # -- full run -----------------------------------------------------------
    def default_indices(self) -> list:
        indices = list(range(len(self.dataset)))
        num_samples = self.config.get("num_samples")
        if num_samples is not None:
            indices = indices[: int(num_samples)]
        return indices

    def evaluate_indices(self, indices) -> list:
        """Raw scored records for the given dataset indices (no
        aggregation)."""
        records = []
        for i in indices:
            sample = self.dataset[i]
            record = self.evaluate_sample(sample)
            if record is None:
                continue
            record["correct"] = self._correctness_bits(record)
            records.append(record)
            print(
                f"[{i}] {record['category']}: "
                f"pos {record['position_error']:.4f} m, "
                f"rot {record['degree_error']:.2f} deg, "
                f"IoU {record['iou_3d']:.3f}"
                + (" (FAILED)" if record["failed"] else "")
            )
        return records

    @classmethod
    def aggregate_records(cls, records) -> dict:
        """Per-category + overall aggregation of raw scored records."""
        per_category = defaultdict(list)
        for record in records:
            per_category[record["category"]].append(record)
        results = {
            cat: cls._aggregate(recs)
            for cat, recs in sorted(per_category.items())
        }
        if records:
            results["all"] = cls._aggregate(records)
        return results

    def run(self) -> dict:
        records = self.evaluate_indices(self.default_indices())
        results = self.aggregate_records(records)
        self._save_results(results)
        return results

    @staticmethod
    def _aggregate(records) -> dict:
        out = {"count": len(records), "failed": sum(r["failed"] for r in records)}
        correctness = defaultdict(list)
        for r in records:
            for name, bit in r["correct"].items():
                correctness[name].append(bit)
        out["correctness"] = {
            name: float(np.mean(bits)) for name, bits in correctness.items()
        }
        # continuous means average the successful samples only, so every
        # column averages one population; failures count through ``failed``
        # and the correctness shares (as incorrect, per the NOCS protocol)
        succeeded = [r for r in records if not r["failed"]]
        scalar_names = set()
        for r in succeeded:
            scalar_names.update(
                k
                for k, v in r.items()
                if isinstance(v, float) and np.isfinite(v)
            )
        means = {}
        for name in sorted(scalar_names):
            vals = [
                r[name]
                for r in succeeded
                if isinstance(r.get(name), float) and np.isfinite(r[name])
            ]
            if vals:
                means[name] = float(np.mean(vals))
        out["means"] = means
        return out

    def _save_results(self, results: dict) -> None:
        out_folder = self.config.get("out_folder")
        if not out_folder:
            print(results)
            return
        os.makedirs(out_folder, exist_ok=True)
        run_name = self.config.get("run_name") or "category_eval"
        filename = (
            f"category_eval_{run_name}_"
            f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.yaml"
        )
        out_path = os.path.join(out_folder, filename)
        save_config_to_file(out_path, {**self.config, "results": results})
        print(f"Results saved to: {out_path}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Category-level pose-and-shape evaluation."
    )
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument("--device", default="cuda")
    config = load_config_from_args(parser, argv)
    device = config.pop("device")
    CategoryEvaluator(config, device=device).run()


if __name__ == "__main__":
    main()
