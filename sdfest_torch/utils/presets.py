"""Estimation configs carried as Python dicts (no YAML parser needed).

``MUG_PROCEDURAL`` is ``configs/estimation/models/mug_procedural.yaml``
updated by ``configs/estimation/default.yaml`` (both under
``sdfest_tpu/configs/estimation/``), merged as the README's quick start does:
``config = load(model); config.update(load(default))``.
``MUG_PROCEDURAL_FAST`` adds the production overlay
``configs/estimation/fast.yaml`` (ROI crop + ``[4, 2]`` multires) on top,
``MUG_PROCEDURAL_FAST_ADAPTIVE`` the overlay ``fast_adaptive.yaml`` (fast +
early stop); ``MUG_PROCEDURAL_TEMPORAL`` is ``MUG_PROCEDURAL`` with
``temporal_coherence: true`` (warm-started refinement renders), and
``MUG_PROCEDURAL_BF16`` is ``MUG_PROCEDURAL`` with ``bf16_march: true``
(default.yaml's switch: bf16-verified march samples).  CPU tests hold the
dicts against the YAML files.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

_ENCODER_LAYERS = [
    {"type": "Conv3d",
     "args": {"in_channels": 1, "out_channels": 4, "kernel_size": 3,
              "stride": 2}},
    {"type": "ReLU", "args": {}},
    {"type": "Conv3d",
     "args": {"in_channels": 4, "out_channels": 8, "kernel_size": 3,
              "stride": 2}},
    {"type": "ReLU", "args": {}},
    {"type": "Conv3d",
     "args": {"in_channels": 8, "out_channels": 16, "kernel_size": 3,
              "stride": 2}},
    {"type": "ReLU", "args": {}},
    {"type": "Flatten", "args": {}},
]

_GENERATED_VIEWS = {
    "width": 640, "height": 480, "fov_deg": 90, "pointcloud": True,
    "normalize_pose": True, "render_threshold": 0.004, "z_min": 0.25,
    "z_max": 0.7, "center_frac": 0.6, "extent_mean": 0.11,
    "extent_std": 0.01, "mask_noise": True, "mask_noise_min": 0.1,
    "mask_noise_max": 2.0, "norm_noise": False, "scale_to_unit_ball": False,
    "gaussian_noise_probability": 0.5, "orientation_repr": "discretized",
    "orientation_grid_resolution": 1, "category_str": "mug",
}

MUG_PROCEDURAL: Dict[str, Any] = {
    "vae": {
        "latent_size": 8,
        "tsdf": False,
        "encoder": {"layer_infos": _ENCODER_LAYERS},
        "decoder": {
            "fc_layers": [{"out": 20}, {"out": 50}, {"out": 8192}],
            "conv_layers": [
                {"in_size": 8, "in_channels": 16, "out_channels": 16,
                 "kernel_size": 3, "relu": True},
                {"in_size": 16, "in_channels": 16, "out_channels": 8,
                 "kernel_size": 3, "relu": True},
                {"in_size": 32, "in_channels": 8, "out_channels": 4,
                 "kernel_size": 3, "relu": True},
                {"in_size": 64, "in_channels": 4, "out_channels": 1,
                 "kernel_size": 1, "relu": False},
            ],
        },
        "model": "trained_models/mug_procedural/mug_procedural.msgpack",
    },
    "init": {
        "datasets": {
            "generated_dataset": {
                "type": "SDFVAEViewDataset",
                "probability": 1.0,
                "config_dict": _GENERATED_VIEWS,
            }
        },
        "num_points": 2500,
        "orientation_repr": "discretized",
        "orientation_grid_resolution": 1,
        "backbone_type": "VanillaPointNet",
        "backbone": {
            "in_size": 3,
            "mlp_out_sizes": [128, 128, 128, 128, 1024],
            "batchnorm": True,
            "dense": True,
            "residual": True,
        },
        "head_type": "SDFPoseHead",
        "head": {
            "in_size": 1024,
            "mlp_out_sizes": [512, 256, 128],
            "batchnorm": True,
            "orientation_repr": "discretized",
            "orientation_grid_resolution": 1,
        },
        "category_str": "mug",
        "normalize_pose": True,
        "model": "trained_models/init_mug_procedural_v3/"
                 "init_mug_procedural_v3.msgpack",
    },
    "category": "cup",
    "far_field": 2.0,
    # default.yaml
    "camera": {"width": 640, "height": 480, "fx": 320, "fy": 320, "cx": 320,
               "cy": 240, "pixel_center": 0.5},
    "threshold": 0.005,
    "iso_threshold": 0.02,
    "max_iterations": 50,
    "depth_weight": 1.0,
    "pc_weight": 3.0,
    "nn_weight": 0.0,
    "mean_shape": False,
    "init_view": "first",
    "shape_init": "prediction",
    "renderer_backend": "auto",
    "relaxation": 1.0,
    "coarse_culling": True,
    "bf16_march": False,
    "temporal_coherence": False,
    "roi_size": None,
    "roi_margin": 48,
    "multires_factor": 1,
    "multires_iterations": 0,
    "temporal_refresh_interval": 8,
    "early_stop_delta": 0.0,
    "early_stop_interval": 10,
}

MUG_PROCEDURAL_FAST: Dict[str, Any] = {
    **copy.deepcopy(MUG_PROCEDURAL),
    # fast.yaml
    "roi_size": "auto",
    "multires_factor": [4, 2],
    "multires_iterations": "auto",
}

MUG_PROCEDURAL_FAST_ADAPTIVE: Dict[str, Any] = {
    **copy.deepcopy(MUG_PROCEDURAL_FAST),
    # fast_adaptive.yaml
    "early_stop_delta": 0.01,
    "early_stop_interval": 10,
}

MUG_PROCEDURAL_TEMPORAL: Dict[str, Any] = {
    **copy.deepcopy(MUG_PROCEDURAL),
    "temporal_coherence": True,
}

MUG_PROCEDURAL_BF16: Dict[str, Any] = {
    **copy.deepcopy(MUG_PROCEDURAL),
    "bf16_march": True,
}

PRESETS = {"mug_procedural": MUG_PROCEDURAL,
           "mug_procedural_bf16": MUG_PROCEDURAL_BF16,
           "mug_procedural_fast": MUG_PROCEDURAL_FAST,
           "mug_procedural_fast_adaptive": MUG_PROCEDURAL_FAST_ADAPTIVE,
           "mug_procedural_temporal": MUG_PROCEDURAL_TEMPORAL}


def preset(name: str) -> Dict[str, Any]:
    """A deep copy of a named preset (callers may edit it freely)."""
    return copy.deepcopy(PRESETS[name])
