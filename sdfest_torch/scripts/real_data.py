"""Run the estimation pipeline on real RGB-D data, and the runtime analysis
(counterpart of ``sdfest_tpu/scripts/real_data.py``).

Per-dataset RGB-D loaders (Redwood, RGB-D Object UW, REAL275, and a
synthetic Redwood-like frame rendered from a mesh), instance masks (a mask
file, an on-disk cache, optional Detectron2, else the valid-depth mask),
per-instance pipeline runs, and the reference's runtime-analysis protocol:
``runs`` runs with the first skipped, with and without shape optimization,
each phase timed under its reference name (init, decode, render, losses,
backward, full refinement) with its ``mean``, ``calls_per_run`` and
``total_per_run``.

The phases are timed on the pipeline's device: the host clock around a
loop of calls that ends in ``torch.cuda.synchronize()`` (PyTorch runs every
launched kernel, so no output chaining is needed).  ``render_and_losses``
and ``fwd_and_backward`` are measured programs; ``losses`` and ``backward``
are their differences (clamped at 0), as in the JAX package.  The full
refinement runs with ``shape_optimization`` as the block says (the JAX
package's runs both blocks with it); the decoder runs in every iteration
either way, as there.
``--trace DIR`` writes a ``torch.profiler`` trace of one warm full
refinement (``DIR/runtime_analysis_trace.json``, Chrome trace format).

PIL is imported inside the loaders only; without PyYAML, give
:func:`runtime_analysis` a dict (e.g.
``sdfest_torch.utils.presets.preset("runtime_analysis_demo")`` with
``input`` set).  Command line (PyYAML needed): ``python -m
sdfest_torch.scripts.real_data --config
configs/estimation/runtime_analysis_demo.yaml --out_folder results/
[--trace DIR] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import os
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sdfest_torch.datasets.dataset_utils import load_image
from sdfest_torch.ops import pointset
from sdfest_torch.pipeline import losses
from sdfest_torch.pipeline.pipeline import NoDepthError, SDFPipeline
from sdfest_torch.utils.config import load_config_from_args, save_config_to_file
from sdfest_torch.utils.device import synchronize

TRACE_FILE = "runtime_analysis_trace.json"

# ---------------------------------------------------------------------------
# dataset loaders
# ---------------------------------------------------------------------------


def _rgbd(rgb_path: str, depth_path: str
          ) -> Tuple[np.ndarray, np.ndarray, str, str]:
    color = load_image(rgb_path, np.float32) / 255.0
    depth = load_image(depth_path, np.float32) * 0.001
    return color, depth, rgb_path, depth_path


def load_redwood_rgbd(rgb_path: str) -> Tuple[np.ndarray, np.ndarray, str, str]:
    """Load a Redwood RGB frame and its closest-timestamp depth frame."""
    rgb_dir = os.path.dirname(rgb_path)
    depth_dir = os.path.join(os.path.dirname(rgb_dir), "depth")
    timestamp = int(os.path.basename(rgb_path).split("-")[1].split(".")[0])
    depth_files = sorted(os.listdir(depth_dir))
    best = min(
        depth_files,
        key=lambda f: abs(int(f.split("-")[1].split(".")[0]) - timestamp),
    )
    return _rgbd(rgb_path, os.path.join(depth_dir, best))


def load_real275_rgbd(rgb_path: str) -> Tuple[np.ndarray, np.ndarray, str, str]:
    """Load a REAL275 color/depth pair (``*_color.png`` naming)."""
    return _rgbd(rgb_path, rgb_path.replace("color", "depth"))


def load_rgbd_object_uw_rgbd(rgb_path: str
                             ) -> Tuple[np.ndarray, np.ndarray, str, str]:
    """Load an RGB-D Object (UW) pair (``*_depth.png`` naming)."""
    base, ext = os.path.splitext(rgb_path)
    return _rgbd(rgb_path, base + "_depth" + ext)


def load_synthetic_rgbd(
    mesh_path: str, camera_config: Optional[dict] = None
) -> Tuple[np.ndarray, np.ndarray, str, str]:
    """Render a Redwood-like RGB-D frame from a mesh file (deterministic).

    Stands in for one real frame of the runtime-analysis protocol where the
    Redwood data is absent: the mesh at 0.11 m scale, 0.6 m ahead and tilted
    45 degrees about x (rim and handle visible), z-buffer rendered through
    the config camera (default: Redwood's).  Timings do not depend on pixel
    content beyond the object's footprint on the screen.
    """
    from sdfest_torch.ops.camera import Camera
    from sdfest_torch.pipeline import synthetic

    camera = Camera(**(camera_config or {
        "width": 640, "height": 480, "fx": 525, "fy": 525,
        "cx": 319.5, "cy": 239.5, "pixel_center": 0,
    }))
    mesh = synthetic.Mesh(path=mesh_path, scale=0.11, center=True)
    # the pose in the (OpenCV-convention) rasterizer camera frame
    mesh.position = np.array([0.0, 0.0, 0.6])
    mesh.orientation = np.array([0.3826834, 0.0, 0.0, 0.9238795])
    depth = synthetic.draw_depth_geometry(mesh, camera).astype(np.float32)
    color = np.zeros((camera.height, camera.width, 3), np.float32)
    return color, depth, mesh_path, mesh_path


_LOADERS = {
    "redwood": load_redwood_rgbd,
    "real275": load_real275_rgbd,
    "rgbd_object_uw": load_rgbd_object_uw_rgbd,
}


def load_rgbd(config: dict) -> Tuple[np.ndarray, np.ndarray, str, str]:
    """Load one RGB-D image per the config's ``dataset`` / ``input`` keys."""
    dataset = config["dataset"]
    if dataset == "synthetic":
        return load_synthetic_rgbd(config["input"], config.get("camera"))
    if dataset not in _LOADERS:
        raise NotImplementedError(f"Dataset {dataset} is not supported")
    return _LOADERS[dataset](config["input"])


# ---------------------------------------------------------------------------
# segmentation
# ---------------------------------------------------------------------------


def get_masks(
    color: np.ndarray,
    depth: np.ndarray,
    config: dict,
    cache_path: Optional[str] = None,
) -> List[Dict]:
    """Instance masks for the target category.

    In order: the config's ``mask_path``, cached detections, Detectron2 (if
    installed), else the one valid-depth mask.  Returns a list of dicts
    with ``mask`` (H, W bool) and ``category_str``.
    """
    if config.get("mask_path"):
        mask = load_image(config["mask_path"]) != 0
        if mask.ndim == 3:
            mask = mask[..., 0]
        return [{"mask": mask, "category_str": config.get("category", "unknown")}]

    if cache_path and os.path.exists(cache_path):
        data = np.load(cache_path, allow_pickle=True)
        return list(data["instances"])

    try:
        return _detectron_masks(color, config, cache_path)
    except ImportError:
        print(
            "Detectron2 unavailable; falling back to the valid-depth mask. "
            "Provide mask_path for real segmentation."
        )
        return [
            {"mask": depth > 0, "category_str": config.get("category", "unknown")}
        ]


def _detectron_masks(color, config, cache_path):
    import detectron2  # noqa: F401  (optional dependency)
    from detectron2 import model_zoo
    from detectron2.config import get_cfg
    from detectron2.engine import DefaultPredictor

    cfg = get_cfg()
    model = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"
    cfg.merge_from_file(model_zoo.get_config_file(model))
    cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(model)
    predictor = DefaultPredictor(cfg)
    outputs = predictor((color * 255).astype(np.uint8)[:, :, ::-1])
    instances = outputs["instances"].to("cpu")
    coco_names = predictor.metadata.get("thing_classes")
    result = []
    for i in range(len(instances)):
        result.append(
            {
                "mask": instances.pred_masks[i].numpy(),
                "category_str": coco_names[int(instances.pred_classes[i])],
            }
        )
    if cache_path:
        os.makedirs(os.path.dirname(cache_path), exist_ok=True)
        np.savez_compressed(cache_path, instances=np.asarray(result, dtype=object))
    return result


# ---------------------------------------------------------------------------
# runtime analysis
# ---------------------------------------------------------------------------


def measure_phases(
    pipeline: SDFPipeline, depth, mask, runs: int = 10,
    shape_optimization: bool = True,
) -> Dict[str, Dict]:
    """Per-phase times in seconds under the reference's phase names.

    init (preprocessing and the init network), decode (the decoder), render
    (the march), losses (depth L1 + pc), backward (the gradient of that
    loss w.r.t. the position) and full_refinement (one ``__call__``).  Each
    phase runs twice untimed, then ``runs`` times (the full refinement 3
    times) between two synchronisations.
    """
    dev = pipeline.device
    depth_t = pipeline._preprocess_depth(
        torch.as_tensor(depth, dtype=torch.float32, device=dev),
        torch.as_tensor(mask, device=dev),
    )
    points, pmask = pointset.depth_to_pointcloud_dense(depth_t, pipeline.camera)
    camera_position = torch.zeros(3, device=dev)
    camera_orientation = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    iterations = pipeline.config["max_iterations"]

    def init():
        generator = torch.Generator(device=dev).manual_seed(0)
        return pipeline._nn_init(depth_t, camera_position, camera_orientation,
                                 generator)

    def timed(fn, n=runs):
        fn()
        fn()  # a second untimed round, as the reference's skipped run
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        synchronize(dev)
        return (time.perf_counter() - t0) / n

    with torch.no_grad():
        latent, position, scale, orientation = init()
        sdf = pipeline._decode(latent)[0, 0]

        def render(p):
            return pipeline.render(sdf, p, orientation[0], 1.0 / scale[0])

        def loss_fn(p):
            return losses.depth_l1_loss(depth_t, render(p)) + (
                3.0 * losses.masked_pc_loss(points, pmask, p, orientation[0],
                                            scale[0], sdf))

        timings = {
            "init": {"mean": timed(init), "calls_per_run": 1},
            "decode": {"mean": timed(lambda: pipeline._decode(latent)),
                       "calls_per_run": iterations},
            "render": {"mean": timed(lambda: render(position[0])),
                       "calls_per_run": iterations},
        }
        t_loss = timed(lambda: loss_fn(position[0]))

    def gradient():
        p = position[0].clone().requires_grad_(True)
        return torch.autograd.grad(loss_fn(p), p)[0]

    t_grad = timed(gradient)
    timings["render_and_losses"] = {"mean": t_loss,
                                    "calls_per_run": iterations}
    timings["losses"] = {"mean": max(t_loss - timings["render"]["mean"], 0.0),
                         "calls_per_run": iterations}
    timings["fwd_and_backward"] = {"mean": t_grad,
                                   "calls_per_run": iterations}
    timings["backward"] = {"mean": max(t_grad - t_loss, 0.0),
                           "calls_per_run": iterations}
    timings["full_refinement"] = {
        "mean": timed(lambda: pipeline(
            depth_t, mask, shape_optimization=shape_optimization,
            generator=torch.Generator(device=dev).manual_seed(0)), n=3),
        "calls_per_run": 1,
    }
    for stats in timings.values():
        stats["total_per_run"] = stats["mean"] * stats["calls_per_run"]
    return timings


def runtime_analysis(config: dict, device="cuda") -> dict:
    """The reference's runtime breakdown: ``runs`` runs (default 11), the
    first skipped when ``skip_first_run``, with and without shape
    optimization (``results_with_decode`` / ``results_without_decode``).

    With ``trace_dir`` set (config key or ``--trace``), one warm full
    refinement is also traced with ``torch.profiler`` into
    ``trace_dir/runtime_analysis_trace.json``.  With ``out_folder`` the
    config and both blocks are written to YAML.
    """
    pipeline = SDFPipeline(config, device=device)
    color, depth, _, _ = load_rgbd(config)
    instances = get_masks(color, depth, config)
    mask = instances[0]["mask"]
    n_timed = int(config.get("runs", 11)) - bool(
        config.get("skip_first_run", True))
    results = {}
    for shape_opt in (True, False):
        phase_stats = measure_phases(pipeline, depth, mask, runs=n_timed,
                                     shape_optimization=shape_opt)
        results["results_with_decode" if shape_opt else "results_without_decode"] = {
            k: {kk: float(vv) for kk, vv in v.items()}
            for k, v in phase_stats.items()
        }
    if config.get("trace_dir"):
        trace_path = trace_refinement(pipeline, depth, mask,
                                      config["trace_dir"])
        print(f"Profiler trace written to {trace_path}")
    if config.get("out_folder"):
        os.makedirs(config["out_folder"], exist_ok=True)
        out_path = os.path.join(
            config["out_folder"],
            f"runtime_analysis_{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}.yaml",
        )
        save_config_to_file(out_path, {**config, **results})
        print(f"Runtime analysis saved to {out_path}")
    return results


def trace_refinement(pipeline: SDFPipeline, depth, mask, trace_dir: str
                     ) -> str:
    """A ``torch.profiler`` Chrome trace of one warm ``__call__`` (the
    device's activity too on a CUDA pipeline); returns its path."""
    from torch.profiler import ProfilerActivity, profile

    dev = pipeline.device

    def call():
        pipeline(depth, mask,
                 generator=torch.Generator(device=dev).manual_seed(0))
        synchronize(dev)

    call()  # warm
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        call()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


# ---------------------------------------------------------------------------
# main demo / evaluation flow
# ---------------------------------------------------------------------------


def run_on_image(pipeline: SDFPipeline, config: dict) -> List[Dict]:
    """Run the pipeline on each matching instance of one RGB-D image."""
    color, depth, color_path, _ = load_rgbd(config)
    cache_path = None
    if config.get("detection_cache"):
        cache_path = os.path.join(
            config["detection_cache"],
            os.path.basename(color_path) + ".npz",
        )
    instances = get_masks(color, depth, config, cache_path)
    target_category = config.get("category")
    results = []
    for instance in instances:
        if target_category and instance["category_str"] != target_category:
            continue
        try:
            position, orientation, scale, latent = pipeline(
                depth, instance["mask"])
        except NoDepthError:
            print("No depth data within mask; skipping instance.")
            continue
        results.append(
            {
                "position": position[0].cpu().numpy(),
                "orientation": orientation[0].cpu().numpy(),
                "scale": float(scale[0]),
                "latent": latent[0].cpu().numpy(),
                "category_str": instance["category_str"],
            }
        )
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="SDF pose estimation on real data.")
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument(
        "--trace", metavar="DIR", default=None,
        help="write a torch.profiler trace of one warm refinement into DIR "
        "during --measure_runtime",
    )
    parser.add_argument("--device", default="cuda")
    config = load_config_from_args(parser, argv)
    device = config.pop("device")
    if config.get("trace"):
        config["trace_dir"] = config.pop("trace")
    if config.get("measure_runtime"):
        runtime_analysis(config, device=device)
        return
    pipeline = SDFPipeline(config, device=device)
    results = run_on_image(pipeline, config)
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
