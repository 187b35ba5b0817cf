"""Parity of the port's real-data loaders with the JAX package's (CPU):
``nocs_utils`` (Umeyama, seeded RANSAC), ``AnnotatedRedwoodDataset`` on the
Redwood fixture of ``test_datasets.py``, and ``NOCSDataset`` on a miniature
NOCS tree written here with PIL (one ``real_test`` frame with its gts
pickle, one ``real_train`` frame whose pose is estimated from a rendered
NOCS map): equal preprocessing pickles and equal ``__getitem__`` samples.
The host-side point-set, camera and misc helpers the loaders use are held
to the JAX package's too."""
import os
import pickle
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from sdfest_tpu.datasets import nocs_utils as jnocs_utils
from sdfest_tpu.datasets.nocs_dataset import NOCSDataset as JNOCSDataset
from sdfest_tpu.datasets.redwood_dataset import (
    AnnotatedRedwoodDataset as JRedwood,
)
from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.utils import misc as jmisc
from sdfest_torch.datasets import nocs_utils as tnocs_utils
from sdfest_torch.datasets.nocs_dataset import NOCSDataset
from sdfest_torch.datasets.redwood_dataset import AnnotatedRedwoodDataset
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import synthetic
from sdfest_torch.utils import misc as tmisc

from test_datasets import _make_redwood_fixture

# the NOCS REAL camera (NOCSDataset._get_split_camera of real_*)
REAL_CAMERA = dict(width=640, height=480, fx=591.0125, fy=590.16775,
                   cx=322.525, cy=244.11084, pixel_center=0.0)
HALF = 0.05  # the cube's half extent (m)
POSES = {  # split -> (position, quaternion xyzw), OpenCV camera frame
    "real_test": ((0.02, -0.01, 0.5), Rotation.from_euler(
        "XYZ", [25, -30, 15], degrees=True).as_quat()),
    "real_train": ((-0.03, 0.02, 0.55), Rotation.from_euler(
        "XYZ", [-20, 40, 10], degrees=True).as_quat()),
}


def _cube(half):
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    return v, f


def _write_frame(root, split, with_nocs_map):
    """One frame of ``split``: a cube of half extent HALF at POSES[split],
    mask id 1 (mug), its mesh under ``obj_models``."""
    scene = root / split / "scene_1"
    scene.mkdir(parents=True)
    position, quat = POSES[split]
    v, f = _cube(HALF)
    mesh = synthetic.Mesh(vertices=v, faces=f, scale=1.0, rel_scale=True,
                          position=np.asarray(position),
                          orientation=np.asarray(quat))
    camera = Camera(**REAL_CAMERA)
    depth = synthetic.draw_depth_geometry(mesh, camera)
    depth_mm = np.round(depth * 1000.0).astype(np.uint16)
    mask = np.full(depth.shape, 255, np.uint8)
    mask[depth_mm > 0] = 1
    Image.fromarray(np.zeros((480, 640, 3), np.uint8)).save(
        scene / "0000_color.png")
    Image.fromarray(depth_mm).save(scene / "0000_depth.png")
    Image.fromarray(mask).save(scene / "0000_mask.png")
    (scene / "0000_meta.txt").write_text(f"1 6 cube_{split}\n")
    models = root / "obj_models" / split
    models.mkdir(parents=True)
    synthetic.save_obj(str(models / f"cube_{split}.obj"), v, f)
    rot = Rotation.from_quat(quat).as_matrix()
    if with_nocs_map:
        # NOCS coordinates of each pixel's surface point: the object frame
        # normalized by the diagonal (1 for the unit NOCS cube), + 0.5, z
        # stored flipped
        d = depth_mm.astype(np.float64) / 1000.0
        rows, cols = np.nonzero(d)
        z = d[rows, cols]
        cam = np.stack([(cols - REAL_CAMERA["cx"]) * z / REAL_CAMERA["fx"],
                        (rows - REAL_CAMERA["cy"]) * z / REAL_CAMERA["fy"],
                        z], axis=-1)
        scale = 2 * HALF * np.sqrt(3.0)
        nocs = (cam - np.asarray(position)) @ rot / scale + 0.5
        nocs[:, 2] = 1.0 - nocs[:, 2]
        img = np.zeros((480, 640, 3), np.uint8)
        img[rows, cols] = np.clip(np.round(nocs * 255.0), 0, 255)
        Image.fromarray(img).save(scene / "0000_coord.png")
    else:
        gts = root / "gts" / split
        gts.mkdir(parents=True)
        rt = np.eye(4)
        rt[:3, :3] = rot * 0.3  # gt_RTs carry the NOCS scale in the rotation
        rt[:3, 3] = position
        with open(gts / "results_real_test_scene_1_0000.pkl", "wb") as f:
            pickle.dump({"gt_RTs": [rt]}, f)


@pytest.fixture(scope="module")
def nocs_trees(tmp_path_factory):
    """Two identical miniature NOCS trees (one per package, so each
    preprocesses its own ``sdfest_pre``)."""
    base = tmp_path_factory.mktemp("nocs")
    root = base / "jax"
    root.mkdir()
    _write_frame(root, "real_test", with_nocs_map=False)
    _write_frame(root, "real_train", with_nocs_map=True)
    shutil.copytree(root, base / "port")
    return base / "jax", base / "port"


@pytest.fixture
def serial(monkeypatch):
    """Preprocess without joblib's worker processes (both packages fall
    back to a loop when it does not import)."""
    monkeypatch.setitem(sys.modules, "joblib", None)


def _rel(value, root):
    return os.path.relpath(value, root) if isinstance(value, str) else value


def _assert_same(got, want, got_root, want_root, atol=0.0):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _rel(got[key], got_root), _rel(want[key], want_root)
        if isinstance(w, np.ndarray) or np.ndim(w):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=atol, err_msg=key)
            assert np.asarray(g).dtype == np.asarray(w).dtype, key
        else:
            assert g == w, key


# ---------------------------------------------------------------------------
# nocs_utils
# ---------------------------------------------------------------------------


def test_umeyama_equals_jax():
    rng = np.random.default_rng(0)
    source = rng.normal(size=(50, 3))
    target = 1.3 * Rotation.from_euler("XYZ", [20, -40, 70], degrees=True
                                       ).apply(source) + [0.3, -0.2, 0.8]
    for got, want in zip(tnocs_utils.umeyama(source, target),
                         jnocs_utils.umeyama(source, target)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(tnocs_utils.PoseEstimationError):
        tnocs_utils.umeyama(np.ones((5, 3)), target[:5])


def test_ransac_equals_jax():
    rng = np.random.default_rng(1)
    source = rng.normal(size=(100, 3))
    target = 0.8 * Rotation.from_euler("XYZ", [10, 30, -50], degrees=True
                                       ).apply(source) + [-0.1, 0.4, 0.2]
    target[::5] += rng.normal(size=target[::5].shape) * 5.0
    got = tnocs_utils.estimate_similarity_transform(
        source, target, rng=np.random.default_rng(7))
    want = jnocs_utils.estimate_similarity_transform(
        source, target, rng=np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tnocs_utils.estimate_similarity_transform(
        source[:4], target[:4]) == (None, None, None, None)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("convention", ["opengl", "opencv"])
def test_host_pointset_helpers_equal_jax(convention):
    rng = np.random.default_rng(2)
    depth = np.where(rng.random((48, 64)) > 0.3,
                     rng.random((48, 64)) + 0.5, 0.0).astype(np.float32)
    mask = rng.random((48, 64)) > 0.2
    cam = dict(width=64, height=48, fx=50.0, fy=51.0, cx=30.5, cy=25.25,
               pixel_center=0.0)
    for normalize in (False, True):
        got = tpointset.depth_to_pointcloud(depth, Camera(**cam), normalize,
                                            mask, convention)
        want = jpointset.depth_to_pointcloud(depth, JCamera(**cam),
                                             normalize, mask, convention)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tpointset.depth_to_pointcloud(depth, Camera(**cam),
                                      convention="ros")
    points = rng.normal(size=(4, 10, 3)).astype(np.float32)
    got = tpointset.normalize_points(torch.from_numpy(points))
    want = jpointset.normalize_points(jnp.asarray(points))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7)
    np.testing.assert_array_equal(Camera(**cam).intrinsic_matrix(0.5),
                                  JCamera(**cam).intrinsic_matrix(0.5))


def test_camera_convention_changes_equal_jax():
    rng = np.random.default_rng(3)
    transform = rng.normal(size=(2, 4, 4)).astype(np.float32)
    position = rng.normal(size=(5, 3)).astype(np.float32)
    quat = rng.normal(size=(5, 4)).astype(np.float32)
    for fn, x in (("transform", transform), ("position", position),
                  ("orientation", quat)):
        name = f"change_{fn}_camera_convention"
        for conventions in (("opengl", "opencv"), ("opencv", "opencv")):
            got = getattr(tpointset, name)(torch.from_numpy(x), *conventions)
            want = getattr(jpointset, name)(jnp.asarray(x), *conventions)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6, err_msg=name)
        with pytest.raises(ValueError):
            getattr(tpointset, name)(torch.from_numpy(x), "opengl", "ros")


def test_misc_equals_jax(tmp_path):
    for x in (True, False, 0, 0.05, "no", "False", "0.1", "n"):
        assert tmisc.str_to_tsdf(x) == jmisc.str_to_tsdf(x)
    assert tmisc.str_to_object("numpy.linalg.norm") is np.linalg.norm
    local_name = 3  # noqa: F841 (found in the caller's scope)
    assert tmisc.str_to_object("local_name") == 3
    assert tmisc.str_to_object("no.such.thing") is None
    sample = {"pointset": np.random.default_rng(0).normal(size=(500, 3)),
              "position": np.zeros(3), "quaternion": [0.0, 0.0, 0.0, 1.0],
              "scale": np.float32(0.1)}
    fig = tmisc.visualize_sample(sample, path=str(tmp_path / "s.png"))
    assert os.path.isfile(tmp_path / "s.png") and fig is not None


# ---------------------------------------------------------------------------
# AnnotatedRedwoodDataset
# ---------------------------------------------------------------------------

REDWOOD_CONFIGS = {
    "default": {},
    "remapped_discretized": {
        "camera_convention": "opencv", "scale_convention": "full",
        "remap_y_axis": "y", "remap_x_axis": "-z", "mask_pointcloud": True,
        "orientation_repr": "discretized", "orientation_grid_resolution": 1},
    "normalized": {"normalize_pointcloud": True, "mask_pointcloud": True,
                   "scale_convention": "diagonal"},
}


@pytest.mark.parametrize("occlude", [False, True])
def test_redwood_samples_equal_jax(tmp_path, occlude):
    root_dir, ann_dir, _, _ = _make_redwood_fixture(tmp_path, occlude)
    for name, extra in REDWOOD_CONFIGS.items():
        cfg = {"root_dir": str(root_dir), "ann_dir": str(ann_dir), **extra}
        ds, jds = AnnotatedRedwoodDataset(dict(cfg)), JRedwood(dict(cfg))
        assert len(ds) == len(jds) == 1
        _assert_same(ds[0], jds[0], tmp_path, tmp_path)
        v, f = ds.load_mesh(ds[0]["obj_path"])
        jv, jf = jds.load_mesh(jds[0]["obj_path"])
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)


# ---------------------------------------------------------------------------
# NOCSDataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["real_test", "real_train"])
def test_nocs_preprocessing_equals_jax(nocs_trees, serial, split):
    jroot, root = nocs_trees
    ds = NOCSDataset({"root_dir": str(root), "split": split})
    jds = JNOCSDataset({"root_dir": str(jroot), "split": split})
    assert len(ds) == len(jds) == 1
    pre = root / "sdfest_pre" / split
    jpre = jroot / "sdfest_pre" / split
    assert sorted(os.listdir(pre)) == sorted(os.listdir(jpre)) == [
        "00000000_0.pkl", "categories.json"]
    assert (pre / "categories.json").read_text() == (
        jpre / "categories.json").read_text()
    with open(pre / "00000000_0.pkl", "rb") as f, open(
            jpre / "00000000_0.pkl", "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    _assert_same(got, want, root, jroot)
    # the pose the data was made with: the gts of real_test exactly, the
    # NOCS-map estimate of real_train within the map's 8-bit quantization
    position, quat = POSES[split]
    np.testing.assert_allclose(got["position"], position,
                               atol=1e-6 if split == "real_test" else 2e-3)
    angle = (Rotation.from_quat(got["orientation_q"]).inv()
             * Rotation.from_quat(quat)).magnitude()
    assert np.degrees(angle) < (1e-3 if split == "real_test" else 1.0)
    np.testing.assert_allclose(got["extents"], 2 * HALF, atol=1e-7)


NOCS_CONFIGS = {
    "default": {},
    "evaluation": {"camera_convention": "opencv", "scale_convention": "full",
                   "remap_y_axis": "y", "remap_x_axis": "-z",
                   "mask_pointcloud": True},
    "training": {"mask_pointcloud": True, "normalize_pointcloud": True,
                 "remap_y_axis": "y", "remap_x_axis": "-z",
                 "orientation_repr": "discretized",
                 "orientation_grid_resolution": 1, "category_str": "mug"},
    "max": {"scale_convention": "max"},
}


@pytest.mark.parametrize("name", sorted(NOCS_CONFIGS))
def test_nocs_samples_equal_jax(nocs_trees, serial, name):
    jroot, root = nocs_trees
    for split in ("real_test", "real_train"):
        cfg = {"split": split, **NOCS_CONFIGS[name]}
        ds = NOCSDataset(dict(cfg, root_dir=str(root)))
        jds = JNOCSDataset(dict(cfg, root_dir=str(jroot)))
        assert len(ds) == len(jds) == 1
        got, want = ds[0], jds[0]
        _assert_same(got, want, root, jroot)
        assert got["category_str"] == "mug"
        assert got["mask"].sum() > 1000
        v, f = ds.load_mesh(got["obj_path"])
        np.testing.assert_array_equal(v, jds.load_mesh(want["obj_path"])[0])
