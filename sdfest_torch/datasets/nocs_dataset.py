"""Dataset class for NOCS datasets (CAMERA / REAL), host-side numpy
(counterpart of ``sdfest_tpu/datasets/nocs_dataset.py``).

A one-time preprocessing pass recovers each instance's ground-truth pose
(from the gts pickles for ``real_test``, otherwise by RANSAC + Umeyama
alignment of the GT NOCS map against the back-projected depth) and caches
it as a per-instance pickle under ``{root_dir}/sdfest_pre/{split}`` with a
category index JSON; each sample is then loaded with the configured camera
convention, object-axis remapping, scale convention and orientation
representation (quaternion, or a cell of the port's ``SO3Grid``).

Samples are numpy arrays (variable-length point sets, batched by
:func:`sdfest_torch.datasets.dataset_utils.collate_samples`); the pipeline
moves what it uses to its device.  PIL is imported inside the loading
functions only, so the module imports where PIL is absent.
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Dict, Optional

import numpy as np
from scipy.spatial.transform import Rotation

from sdfest_torch.datasets import nocs_utils
from sdfest_torch.datasets.dataset_utils import load_image
from sdfest_torch.ops import pointset as pointset_utils
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.pipeline.synthetic import load_obj
from sdfest_torch.utils import config as config_utils


def _quaternion_multiply_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = q1
    bx, by, bz, bw = q2
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


class ObjectError(Exception):
    """Raised when an object mesh is unusable."""


class NOCSDataset:
    """Map-style dataset over NOCS CAMERA*/REAL* splits.

    Expected directory format matches the public NOCS release (see the
    reference docstring); preprocessing artifacts are stored under
    ``{root_dir}/sdfest_pre/{split}``.
    """

    num_categories = 7
    category_id_to_str = {
        0: "unknown",
        1: "bottle",
        2: "bowl",
        3: "camera",
        4: "can",
        5: "laptop",
        6: "mug",
    }
    category_str_to_id = {v: k for k, v in category_id_to_str.items()}

    default_config: Dict = {
        "root_dir": None,
        "split": None,
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
        """Initialize (and if necessary preprocess) the dataset split."""
        config = config_utils.load_config(
            config, current_dict=NOCSDataset.default_config
        )
        self._root_dir = config["root_dir"]
        self._split = config["split"]
        self._camera_convention = config["camera_convention"]
        self._camera = self._get_split_camera()
        self._preprocess_path = os.path.join(
            self._root_dir, "sdfest_pre", self._split
        )
        if not os.path.isdir(self._preprocess_path):
            self._preprocess_dataset()
        self._mask_pointcloud = config["mask_pointcloud"]
        self._normalize_pointcloud = config["normalize_pointcloud"]
        self._scale_convention = config["scale_convention"]
        self._sample_files = self._get_sample_files(config["category_str"])
        self._remap_y_axis = config["remap_y_axis"]
        self._remap_x_axis = config["remap_x_axis"]
        self._orientation_repr = config["orientation_repr"]
        if self._orientation_repr == "discretized":
            self._orientation_grid = SO3Grid(
                config["orientation_grid_resolution"]
            )

    def __len__(self) -> int:
        return len(self._sample_files)

    def __getitem__(self, idx: int) -> dict:
        """Return a sample dict (color, depth, mask, pointset, pose, scale)."""
        with open(self._sample_files[idx], "rb") as f:
            sample_data = pickle.load(f)
        return self._sample_from_sample_data(sample_data)

    # ------------------------------------------------------------------
    # preprocessing
    # ------------------------------------------------------------------

    def _preprocess_dataset(self) -> None:
        """Create per-instance preprocessing pickles for the current split."""
        os.makedirs(self._preprocess_path)
        color_paths = self._get_color_files()
        try:
            from joblib import Parallel, delayed

            Parallel(n_jobs=-1)(
                delayed(self._preprocess_color_path)(i, p)
                for i, p in enumerate(color_paths)
            )
        except ImportError:
            for i, p in enumerate(color_paths):
                self._preprocess_color_path(i, p)

        sample_files = self._get_sample_files()
        category_str_to_files = {
            category_str: []
            for category_str in NOCSDataset.category_id_to_str.values()
        }
        for sample_file in sample_files:
            with open(sample_file, "rb") as f:
                sample_data = pickle.load(f)
            category_str = NOCSDataset.category_id_to_str[
                sample_data["category_id"]
            ]
            category_str_to_files[category_str].append(
                os.path.basename(sample_file)
            )
        with open(
            os.path.join(self._preprocess_path, "categories.json"), "w"
        ) as f:
            json.dump(category_str_to_files, f)
        print(f"Finished preprocessing for {self._split}.")

    def _preprocess_color_path(self, image_id: int, color_path: str) -> None:
        counter = 0
        depth_path = self._depth_path_from_color_path(color_path)
        if not os.path.isfile(depth_path):
            print(f"Missing depth file {depth_path}. Skipping.")
            return
        mask_path = self._mask_path_from_color_path(color_path)
        meta_path = self._meta_path_from_color_path(color_path)
        meta_rows = self._read_meta(meta_path)
        instances_mask = self._load_mask(mask_path)
        mask_ids = np.unique(instances_mask).tolist()
        gt_id = 0
        for mask_id in mask_ids:
            if mask_id == 255:  # background
                continue
            matches = [row for row in meta_rows if row[0] == mask_id]
            if not matches:
                print(f"Warning: mask {mask_id} not found in {meta_path}")
                continue
            meta_row = matches[0]
            category_id = meta_row[1]
            if category_id == 0:  # unknown / distractor
                continue
            try:
                position, orientation_q, extents, nocs_transform = (
                    self._get_pose_and_scale(color_path, mask_id, gt_id, meta_row)
                )
            except nocs_utils.PoseEstimationError:
                print(
                    "Insufficient data for pose estimation. "
                    f"Skipping {color_path}:{mask_id}."
                )
                continue
            except ObjectError:
                print(
                    "Insufficient object mesh for pose estimation. "
                    f"Skipping {color_path}:{mask_id}."
                )
                continue
            sample_info = {
                "color_path": color_path,
                "depth_path": depth_path,
                "mask_path": mask_path,
                "mask_id": mask_id,
                "category_id": category_id,
                "obj_path": self._get_obj_path(meta_row),
                "nocs_transform": nocs_transform,
                "position": position,
                "orientation_q": orientation_q,
                "extents": extents,
                "nocs_scale": float(np.linalg.norm(extents)),
                "max_extent": float(np.max(extents)),
            }
            out_file = os.path.join(
                self._preprocess_path, f"{image_id:08}_{counter}.pkl"
            )
            with open(out_file, "wb") as f:
                pickle.dump(sample_info, f)
            counter += 1
            gt_id += 1

    @staticmethod
    def _read_meta(meta_path: str) -> list:
        """Parse a NOCS meta.txt into rows [mask_id, category_id, *rest]."""
        rows = []
        with open(meta_path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                rows.append([int(parts[0]), int(parts[1])] + parts[2:])
        return rows

    # ------------------------------------------------------------------
    # file path helpers
    # ------------------------------------------------------------------

    def _get_color_files(self) -> list:
        split_dirs = {
            "camera_train": "train",
            "camera_val": "val",
            "real_train": "real_train",
            "real_test": "real_test",
        }
        if self._split not in split_dirs:
            raise ValueError(f"Specified split {self._split} is not supported.")
        glob_pattern = os.path.join(
            self._root_dir, split_dirs[self._split], "**", "*_color.png"
        )
        return sorted(glob(glob_pattern, recursive=True))

    def _get_sample_files(self, category_str: Optional[str] = None) -> list:
        sample_files = sorted(
            glob(os.path.join(self._preprocess_path, "*.pkl"))
        )
        if category_str is None:
            return sample_files
        if category_str not in NOCSDataset.category_str_to_id:
            raise ValueError(f"Unsupported category_str {category_str}.")
        with open(
            os.path.join(self._preprocess_path, "categories.json")
        ) as f:
            category_str_to_filenames = json.load(f)
        return [
            os.path.join(self._preprocess_path, fn)
            for fn in category_str_to_filenames[category_str]
        ]

    def _get_split_camera(self) -> Camera:
        """NOCS camera intrinsics for the selected split."""
        if self._split in ["real_train", "real_test"]:
            return Camera(
                width=640, height=480, fx=591.0125, fy=590.16775,
                cx=322.525, cy=244.11084, pixel_center=0.0,
            )
        elif self._split in ["camera_train", "camera_val"]:
            return Camera(
                width=640, height=480, fx=577.5, fy=577.5,
                cx=319.5, cy=239.5, pixel_center=0.0,
            )
        raise ValueError(f"Specified split {self._split} is not supported.")

    def _depth_path_from_color_path(self, color_path: str) -> str:
        if self._split in ["real_train", "real_test"]:
            return color_path.replace("color", "depth")
        if self._split == "camera_train":
            return color_path.replace("color", "composed").replace(
                "/train/", "/camera_full_depths/train/"
            )
        if self._split == "camera_val":
            return color_path.replace("color", "composed").replace(
                "/val/", "/camera_full_depths/val/"
            )
        raise ValueError(f"Specified split {self._split} is not supported.")

    def _mask_path_from_color_path(self, color_path: str) -> str:
        return color_path.replace("color", "mask")

    def _meta_path_from_color_path(self, color_path: str) -> str:
        return color_path.replace("color.png", "meta.txt")

    def _nocs_map_path_from_color_path(self, color_path: str) -> str:
        return color_path.replace("color.png", "coord.png")

    def _get_gts_path(self, color_path: str) -> Optional[str]:
        if self._split == "real_test":
            gts_folder = os.path.join(self._root_dir, "gts", "real_test")
        elif self._split == "camera_val":
            gts_folder = os.path.join(self._root_dir, "gts", "val")
        else:
            return None
        path = os.path.normpath(color_path)
        split_path = path.split(os.sep)
        number = path[-14:-10]
        gts_filename = f"results_{split_path[-3]}_{split_path[-2]}_{number}.pkl"
        return os.path.join(gts_folder, gts_filename)

    def _get_obj_path(self, meta_row: list) -> str:
        if "camera" in self._split:  # ShapeNet mesh
            synset_id, object_id = meta_row[2], meta_row[3]
            return os.path.join(
                self._root_dir, "obj_models",
                self._split.replace("camera_", ""), synset_id, object_id,
                "model.obj",
            )
        if "real" in self._split:
            object_id = meta_row[2]
            return os.path.join(
                self._root_dir, "obj_models", self._split, object_id + ".obj"
            )
        raise ValueError(f"Specified split {self._split} is not supported.")

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------

    @staticmethod
    def _load_mask(mask_path: str) -> np.ndarray:
        mask_img = load_image(mask_path, np.uint8)
        if mask_img.ndim == 3:
            return mask_img[:, :, 0]  # CAMERA masks are RGBA
        return mask_img

    @staticmethod
    def _load_depth(depth_path: str) -> np.ndarray:
        return load_image(depth_path, np.float32) * 0.001

    @staticmethod
    def _load_nocs_map(nocs_map_path: str) -> np.ndarray:
        nocs_map = load_image(nocs_map_path, np.float32).copy() / 255.0
        nocs_map[:, :, 2] = 1.0 - nocs_map[:, :, 2]  # z is flipped in NOCS
        return nocs_map[:, :, :3]

    def _get_pose_and_scale(self, color_path, mask_id, gt_id, meta_row):
        """GT pose (OpenCV convention), extents, and NOCS transform."""
        obj_path = self._get_obj_path(meta_row)
        if self._split == "real_test":
            # only real_test gts are reliable (errors exist in camera val)
            with open(self._get_gts_path(color_path), "rb") as f:
                gts_data = pickle.load(f)
            nocs_transform = np.asarray(gts_data["gt_RTs"][gt_id])
            position = nocs_transform[0:3, 3]
            rot_scale = nocs_transform[0:3, 0:3]
            nocs_scales = np.sqrt(np.sum(rot_scale**2, axis=0))
            rotation_matrix = rot_scale / nocs_scales[:, None]
            nocs_scale = nocs_scales[0]
        else:
            position, rotation_matrix, nocs_scale, nocs_transform = (
                self._estimate_object(color_path, mask_id)
            )
        orientation_q = Rotation.from_matrix(rotation_matrix).as_quat()
        mesh_extents = self._get_mesh_extents_from_obj(obj_path)
        if "camera" in self._split:
            # CAMERA/ShapeNet meshes are normalized to diagonal == 1
            extents = nocs_scale * mesh_extents
        else:
            extents = mesh_extents
        return (
            np.asarray(position, dtype=np.float32),
            np.asarray(orientation_q, dtype=np.float32),
            np.asarray(extents, dtype=np.float32),
            np.asarray(nocs_transform, dtype=np.float32),
        )

    def _get_mesh_extents_from_obj(self, obj_path: str) -> np.ndarray:
        try:
            vertices, _ = load_obj(obj_path)
        except OSError:
            # missing/unreadable mesh: skip instance (reference returns an
            # empty o3d mesh here, leading to the same ObjectError)
            raise ObjectError()
        if len(vertices) == 0:
            raise ObjectError()
        return (vertices.max(axis=0) - vertices.min(axis=0)).astype(np.float32)

    def _estimate_object(self, color_path: str, mask_id: int) -> tuple:
        """Estimate pose and scale by aligning the GT NOCS map to depth."""
        depth = self._load_depth(self._depth_path_from_color_path(color_path))
        instances_mask = self._load_mask(
            self._mask_path_from_color_path(color_path)
        )
        instance_mask = instances_mask == mask_id
        nocs_map = self._load_nocs_map(
            self._nocs_map_path_from_color_path(color_path)
        )
        valid = np.logical_and(instance_mask, depth != 0)
        centered_nocs_points = nocs_map[valid] - 0.5
        measured_points = pointset_utils.depth_to_pointcloud(
            depth, self._camera, mask=valid, convention="opencv"
        )
        if len(measured_points) < 30:
            raise nocs_utils.PoseEstimationError()
        if np.max(depth[valid]) > 32.0:
            print("Erroneous depth detected.")
            raise nocs_utils.PoseEstimationError()
        # deterministic RANSAC seed per instance (borderline instances must
        # not flip between runs)
        import zlib

        seed = zlib.crc32(
            f"{os.path.basename(color_path)}:{mask_id}".encode()
        )
        position, rotation_matrix, scale, out_transform = (
            nocs_utils.estimate_similarity_transform(
                centered_nocs_points,
                measured_points,
                rng=np.random.default_rng(seed),
            )
        )
        if position is None:
            raise nocs_utils.PoseEstimationError()
        return position, rotation_matrix, scale, out_transform

    # ------------------------------------------------------------------
    # sample assembly
    # ------------------------------------------------------------------

    def _sample_from_sample_data(self, sample_data: dict) -> dict:
        color = load_image(sample_data["color_path"], np.float32) / 255.0
        depth = self._load_depth(sample_data["depth_path"])
        instances_mask = self._load_mask(sample_data["mask_path"])
        instance_mask = instances_mask == sample_data["mask_id"]

        pointcloud_mask = instance_mask if self._mask_pointcloud else None
        pointcloud = pointset_utils.depth_to_pointcloud(
            depth,
            self._camera,
            mask=pointcloud_mask,
            convention=self._camera_convention,
        )

        position = np.asarray(sample_data["position"], dtype=np.float32)
        if self._camera_convention == "opengl":
            position = position * np.array([1.0, -1.0, -1.0], dtype=np.float32)
        elif self._camera_convention != "opencv":
            raise ValueError(
                f"Camera convention {self._camera_convention} not supported."
            )

        orientation_q, extents = self._change_axis_convention(
            np.asarray(sample_data["orientation_q"], dtype=np.float64),
            np.asarray(sample_data["extents"], dtype=np.float64),
        )
        if self._camera_convention == "opengl":
            gl2cv_q = np.array([1.0, 0.0, 0.0, 0.0])
            orientation_q = _quaternion_multiply_np(gl2cv_q, orientation_q)
        orientation = self._quat_to_orientation_repr(orientation_q)
        scale = self._get_scale(sample_data, extents)

        if self._normalize_pointcloud:
            centroid = pointcloud.mean(axis=0)
            pointcloud = pointcloud - centroid
            position = position - centroid

        return {
            "color": color,
            "depth": depth,
            "pointset": pointcloud.astype(np.float32),
            "mask": instance_mask,
            "position": position.astype(np.float32),
            "orientation": orientation,
            "quaternion": orientation_q.astype(np.float32),
            "scale": np.float32(scale) if np.ndim(scale) == 0 else scale,
            "color_path": sample_data["color_path"],
            "obj_path": sample_data["obj_path"],
            "category_id": sample_data["category_id"],
            "category_str": NOCSDataset.category_id_to_str[
                sample_data["category_id"]
            ],
        }

    def _get_scale(self, sample_data: dict, extents: np.ndarray):
        if self._scale_convention == "diagonal":
            return sample_data["nocs_scale"]
        if self._scale_convention == "max":
            return sample_data["max_extent"]
        if self._scale_convention == "half_max":
            return 0.5 * sample_data["max_extent"]
        if self._scale_convention == "full":
            return extents.astype(np.float32)
        raise ValueError(
            f"Specified scale convention {self._scale_convention} not supported."
        )

    def _change_axis_convention(self, orientation_q, extents):
        """Remap the object frame axes (NOCS -> configured convention)."""
        if self._remap_y_axis is None and self._remap_x_axis is None:
            return orientation_q, extents
        if self._remap_y_axis is None or self._remap_x_axis is None:
            raise ValueError(
                "Either both or none of remap_{y,x}_axis have to be None."
            )
        rotation_o2n = self._get_o2n_object_rotation_matrix()
        remapped_extents = np.abs(rotation_o2n @ extents)
        rotation_n2o = rotation_o2n.T
        quaternion_n2o = Rotation.from_matrix(rotation_n2o).as_quat()
        remapped_orientation_q = _quaternion_multiply_np(
            orientation_q, quaternion_n2o
        )
        return remapped_orientation_q, remapped_extents

    def _get_o2n_object_rotation_matrix(self) -> np.ndarray:
        """Rotation mapping original to new object coordinates (axis remap)."""
        axis_to_col = {
            "x": (0, 1.0), "-x": (0, -1.0),
            "y": (1, 1.0), "-y": (1, -1.0),
            "z": (2, 1.0), "-z": (2, -1.0),
        }
        rotation_o2n = np.zeros((3, 3))
        if self._remap_y_axis not in axis_to_col:
            raise ValueError(f"Unsupported remap_y_axis {self._remap_y_axis}")
        row, sign = axis_to_col[self._remap_y_axis]
        rotation_o2n[row, 1] = sign
        if self._remap_x_axis not in axis_to_col:
            raise ValueError(f"Unsupported remap_x_axis {self._remap_x_axis}")
        row, sign = axis_to_col[self._remap_x_axis]
        rotation_o2n[row, 0] = sign
        # infer third column; make the matrix special orthogonal
        rotation_o2n[:, 2] = 1 - np.abs(np.sum(rotation_o2n, 1))
        rotation_o2n[:, 2] *= np.linalg.det(rotation_o2n)
        if np.linalg.det(rotation_o2n) != 1.0:
            raise ValueError(
                "Unsupported combination of remap_{y,x}_axis. det != 1"
            )
        return rotation_o2n

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
        vertices, faces = load_obj(object_path)
        if self._remap_y_axis is None and self._remap_x_axis is None:
            return vertices, faces
        rotation_o2n = self._get_o2n_object_rotation_matrix()
        return vertices @ rotation_o2n.T, faces
