"""Dataset class for the annotated Redwood RGB-D dataset, host-side numpy
(counterpart of ``sdfest_tpu/datasets/redwood_dataset.py``).

RGB-D sequences plus JSON pose annotations; the instance mask is the
annotated ground-truth mesh rendered with the port's z-buffer rasterizer,
less the pixels whose measured depth lies clearly in front of it
(occluders).  The scale, axis and orientation-representation conventions
are :class:`sdfest_torch.datasets.nocs_dataset.NOCSDataset`'s.  PIL is
imported inside the loading functions only.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation

from sdfest_torch.datasets.dataset_utils import load_image
from sdfest_torch.datasets.nocs_dataset import (
    NOCSDataset,
    _quaternion_multiply_np,
)
from sdfest_torch.ops import pointset as pointset_utils
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.pipeline import synthetic
from sdfest_torch.utils import config as config_utils


class AnnotatedRedwoodDataset:
    """Annotated Redwood RGB-D dataset (bottle / bowl / mug sequences).

    Expected directory format::

        {root_dir}/{category_str}/rgbd/{sequence_id}/...
        {ann_dir}/{sequence_id}.obj
        {ann_dir}/annotations.json
    """

    num_categories = 3
    category_id_to_str = {0: "bottle", 1: "bowl", 2: "mug"}
    category_str_to_id = {v: k for k, v in category_id_to_str.items()}

    default_config: Dict = {
        "root_dir": None,
        "ann_dir": None,
        "mask_pointcloud": False,
        "normalize_pointcloud": False,
        "camera_convention": "opengl",
        "scale_convention": "half_max",
        "orientation_repr": "quaternion",
        "orientation_grid_resolution": None,
        "category_str": None,
        "remap_y_axis": None,
        "remap_x_axis": None,
    }

    def __init__(self, config: Dict) -> None:
        config = config_utils.load_config(
            config, current_dict=AnnotatedRedwoodDataset.default_config
        )
        self._root_dir = config["root_dir"]
        self._ann_dir = config["ann_dir"]
        self._camera_convention = config["camera_convention"]
        self._mask_pointcloud = config["mask_pointcloud"]
        self._normalize_pointcloud = config["normalize_pointcloud"]
        self._scale_convention = config["scale_convention"]
        self._remap_y_axis = config["remap_y_axis"]
        self._remap_x_axis = config["remap_x_axis"]
        self._orientation_repr = config["orientation_repr"]
        self._category_filter = config["category_str"]
        if self._orientation_repr == "discretized":
            self._orientation_grid = SO3Grid(
                config["orientation_grid_resolution"]
            )
        self._load_annotations()
        self._camera = Camera(
            width=640, height=480, fx=525, fy=525, cx=319.5, cy=239.5
        )

    def _load_annotations(self) -> None:
        with open(os.path.join(self._ann_dir, "annotations.json")) as f:
            anns_dict = json.load(f)
        self._raw_samples = []
        for seq_id, seq_anns in anns_dict.items():
            if (
                self._category_filter is not None
                and seq_anns["category"] != self._category_filter
            ):
                continue
            for pose_ann in seq_anns["pose_anns"]:
                self._raw_samples.append(
                    self._create_raw_sample(seq_id, seq_anns, pose_ann)
                )

    def _create_raw_sample(self, seq_id, sequence_dict, annotation_dict) -> dict:
        category_str = sequence_dict["category"]
        return {
            "position": np.asarray(annotation_dict["position"], np.float64),
            "orientation_q": np.asarray(
                annotation_dict["orientation"], np.float64
            ),
            "extents": np.asarray(sequence_dict["scale"], np.float64) * 2,
            "color_path": os.path.join(
                self._root_dir, category_str, "rgbd", seq_id, "rgb",
                annotation_dict["rgb_file"],
            ),
            "depth_path": os.path.join(
                self._root_dir, category_str, "rgbd", seq_id, "depth",
                annotation_dict["depth_file"],
            ),
            "mesh_path": os.path.join(self._ann_dir, sequence_dict["mesh"]),
            "category_str": category_str,
        }

    def __len__(self) -> int:
        return len(self._raw_samples)

    def __getitem__(self, idx: int) -> dict:
        raw_sample = self._raw_samples[idx]
        color = load_image(raw_sample["color_path"], np.float32) / 255.0
        depth = self._load_depth(raw_sample["depth_path"])
        instance_mask = self._compute_mask(depth, raw_sample)

        pointcloud_mask = instance_mask if self._mask_pointcloud else None
        pointcloud = pointset_utils.depth_to_pointcloud(
            depth,
            self._camera,
            mask=pointcloud_mask,
            convention=self._camera_convention,
        )

        position = raw_sample["position"].astype(np.float32)
        if self._camera_convention == "opengl":
            position = position * np.array([1.0, -1.0, -1.0], np.float32)

        orientation_q, extents = self._change_axis_convention(
            raw_sample["orientation_q"], raw_sample["extents"]
        )
        if self._camera_convention == "opengl":
            orientation_q = _quaternion_multiply_np(
                np.array([1.0, 0.0, 0.0, 0.0]), orientation_q
            )
        orientation = self._quat_to_orientation_repr(orientation_q)
        scale = self._get_scale(extents)

        if self._normalize_pointcloud:
            centroid = pointcloud.mean(axis=0)
            pointcloud = pointcloud - centroid
            position = position - centroid

        category_str = raw_sample["category_str"]
        return {
            "color": color,
            "depth": depth,
            "pointset": pointcloud.astype(np.float32),
            "mask": instance_mask,
            "position": position.astype(np.float32),
            "orientation": orientation,
            "quaternion": orientation_q.astype(np.float32),
            "scale": np.float32(scale) if np.ndim(scale) == 0 else scale,
            "color_path": raw_sample["color_path"],
            "obj_path": raw_sample["mesh_path"],
            "category_id": self.category_str_to_id[category_str],
            "category_str": category_str,
        }

    def _compute_mask(self, depth: np.ndarray, raw_sample: dict) -> np.ndarray:
        """Mask by rendering the annotated GT mesh and removing occlusions."""
        mesh = synthetic.Mesh(
            path=raw_sample["mesh_path"],
            scale=1.0,  # mesh already at metric size
            rel_scale=True,
            center=False,
        )
        mesh.position = raw_sample["position"]
        mesh.orientation = raw_sample["orientation_q"]
        gt_depth = synthetic.draw_depth_geometry(mesh, self._camera)
        mask = gt_depth != 0
        # exclude occluded parts (measured depth clearly in front of GT mesh)
        mask[(depth != 0) & (depth < gt_depth - 0.01)] = False
        return mask

    @staticmethod
    def _load_depth(depth_path: str) -> np.ndarray:
        return load_image(depth_path, np.float32) * 0.001

    def _get_scale(self, extents: np.ndarray):
        if self._scale_convention == "diagonal":
            return float(np.linalg.norm(extents))
        if self._scale_convention == "max":
            return float(extents.max())
        if self._scale_convention == "half_max":
            return 0.5 * float(extents.max())
        if self._scale_convention == "full":
            return extents.astype(np.float32)
        raise ValueError(
            f"Specified scale convention {self._scale_convention} not supported."
        )

    def _change_axis_convention(self, orientation_q, extents):
        if self._remap_y_axis is None and self._remap_x_axis is None:
            return orientation_q, extents
        if self._remap_y_axis is None or self._remap_x_axis is None:
            raise ValueError(
                "Either both or none of remap_{y,x}_axis have to be None."
            )
        rotation_o2n = self._get_o2n_object_rotation_matrix()
        remapped_extents = np.abs(rotation_o2n @ extents)
        quaternion_n2o = Rotation.from_matrix(rotation_o2n.T).as_quat()
        return (
            _quaternion_multiply_np(orientation_q, quaternion_n2o),
            remapped_extents,
        )

    # the axis-remap rotation of NOCSDataset (reads the same two attributes)
    _get_o2n_object_rotation_matrix = (
        NOCSDataset._get_o2n_object_rotation_matrix)

    def _quat_to_orientation_repr(self, quaternion: np.ndarray):
        if self._orientation_repr == "quaternion":
            return quaternion.astype(np.float32)
        elif self._orientation_repr == "discretized":
            return np.int64(self._orientation_grid.quat_to_index(quaternion))
        raise NotImplementedError(
            f"Orientation representation {self._orientation_repr} unsupported."
        )

    def load_mesh(self, object_path: str):
        """Load an object mesh (vertices, faces) in the remapped frame."""
        vertices, faces = synthetic.load_obj(object_path)
        if self._remap_y_axis is None and self._remap_x_axis is None:
            return vertices, faces
        rotation_o2n = self._get_o2n_object_rotation_matrix()
        return vertices @ rotation_o2n.T, faces

