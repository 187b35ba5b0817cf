"""Parity of the port's mesh and synthetic-data modules with the JAX
package's (CPU): marching tetrahedra, the numpy rasterizer and meshes, the
metrics, the procedural scenes and data set, the SDF <-> mesh utilities,
and ``SDFPipeline.generate_depth`` / ``generate_mesh`` on the committed mug
weights at a 128x96 camera.

Both packages take their host C++ marching tetrahedra when that library is
built, whose meshes differ from the numpy path's by a few percent in their
counts; the parity tests turn it off in both (``native_off``) and hold the
port's numpy path to the JAX package's (``test_torch_native.py`` holds the
two native paths to each other).  JAX runs in float64 here
(``tests/conftest.py``); its outputs are cast to float32 where the port
computes in float32.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.native import api as jnative
from sdfest_tpu.ops import marching_cubes as jmc
from sdfest_tpu.ops import sdf_utils as jsdf_utils
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline import metrics as jmetrics
from sdfest_tpu.pipeline import synthetic as jsynthetic
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.scripts import make_procedural_dataset as jmpd
from sdfest_tpu.utils import scenes as jscenes
from sdfest_torch.native import api as tnative
from sdfest_torch.ops import marching_cubes as tmc
from sdfest_torch.ops import sdf_utils as tsdf_utils
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import metrics as tmetrics
from sdfest_torch.pipeline import synthetic as tsynthetic
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.scripts import make_procedural_dataset as tmpd
from sdfest_torch.utils import scenes as tscenes
from sdfest_torch.utils.presets import preset

CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
              pixel_center=0.5)
SMALL_CAMERA = dict(width=64, height=48, fx=48, fy=48, cx=32, cy=24)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)


def _config(**overrides):
    config = preset("mug_procedural")
    config.update(camera=dict(CAMERA), max_iterations=3, **PLAIN)
    config.update(overrides)
    return config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (many small CPU ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def native_off(monkeypatch):
    """Both packages' numpy marching tetrahedra, whatever is built."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture(scope="module")
def pipes():
    """The two pipelines on the committed weights and a decoded mug."""
    jpipe = JPipeline(_config(fused_call=False))
    pipe = SDFPipeline(_config(), device="cpu")
    latent = (0.5 * np.random.default_rng(0).normal(size=(1, 8))).astype(
        np.float32)
    grid = np.asarray(jpipe._decode(jnp.asarray(latent)))[0, 0]
    return dict(jpipe=jpipe, pipe=pipe, latent=latent, grid=grid)


def _grids(pipes):
    return {"sphere": tscenes.make_sphere_sdf(32),
            "mug_family": tscenes.make_mug_family_sdf(
                24, **tscenes.sample_mug_family(np.random.default_rng(3))),
            "decoded_mug": pipes["grid"]}


# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sphere", "mug_family", "decoded_mug"])
def test_marching_tetrahedra_equals_jax(pipes, name):
    grid = _grids(pipes)[name]
    level = 0.02 if name == "decoded_mug" else 0.0
    verts, faces = tmc.marching_tetrahedra_np(grid, level)
    want_v, want_f = jmc.marching_tetrahedra_np(grid, level)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)


def test_marching_cubes_spacing_and_range_match_jax(native_off):
    grid = tscenes.make_sphere_sdf(20)
    spacing = (0.1, 0.2, 0.3)
    got = tmc.marching_cubes(grid, 0.1, spacing)
    want = jmc.marching_cubes(grid, 0.1, spacing)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for level in (float(grid.min()) - 1.0, float(grid.max())):
        assert tmc.marching_cubes(grid, level) == (None, None)
    assert tmc._CASES == jmc._case_triangles()


# ---------------------------------------------------------------------------
# synthetic: meshes, OBJ files, the rasterizer
# ---------------------------------------------------------------------------


def _cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    return v, f


def _mug_mesh():
    mesh = tsdf_utils.mesh_from_sdf(tscenes.make_mug_sdf(24),
                                    complete_mesh=True)
    return mesh.vertices, mesh.faces


@pytest.mark.parametrize("shape", ["cube", "mug"])
def test_rasterize_depth_equals_jax(shape):
    v, f = _cube() if shape == "cube" else _mug_mesh()
    quat = Rotation.from_euler("XYZ", [30, -20, 50], degrees=True).as_quat()
    kwargs = dict(vertices=v, faces=f, scale=0.1, position=np.array(
        [0.01, -0.02, 0.35]), orientation=quat)
    got = tsynthetic.draw_depth_geometry(tsynthetic.Mesh(**kwargs),
                                         Camera(**SMALL_CAMERA))
    want = jsynthetic.draw_depth_geometry(jsynthetic.Mesh(**kwargs),
                                          JCamera(**SMALL_CAMERA))
    assert got.shape == (48, 64) and (got > 0).sum() > 100
    np.testing.assert_array_equal(got, want)


def test_mesh_scale_obj_io_and_sampling_match_jax(tmp_path):
    v, f = _mug_mesh()
    quat = Rotation.from_euler("XYZ", [10, 20, 30], degrees=True).as_quat()
    for kw in (dict(scale=0.1), dict(scale=0.5, rel_scale=True),
               dict(scale=2.0, center=True)):
        got = tsynthetic.Mesh(v + 0.3, f, position=np.ones(3),
                              orientation=quat, **kw)
        want = jsynthetic.Mesh(v + 0.3, f, position=np.ones(3),
                               orientation=quat, **kw)
        assert got.scale == want.scale
        np.testing.assert_array_equal(got.get_transformed_vertices(),
                                      want.get_transformed_vertices())
        np.testing.assert_array_equal(
            got.sample_points_uniformly(500, np.random.default_rng(1)),
            want.sample_points_uniformly(500, np.random.default_rng(1)))
    path = str(tmp_path / "mug.obj")
    tsynthetic.save_obj(path, v, f)
    for load in (tsynthetic.load_obj, jsynthetic.load_obj):
        lv, lf = load(path)
        np.testing.assert_array_equal(lf, f)
        np.testing.assert_array_equal(lv, v)
    loaded = tsynthetic.Mesh(path=path, scale=0.2)
    assert np.isclose(loaded.scale, 0.2)
    with pytest.raises(ValueError, match="Only one"):
        tsynthetic.Mesh(vertices=v, faces=f, path=path)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _clouds():
    rng = np.random.default_rng(7)
    gt = rng.normal(size=(400, 3)) * [0.1, 0.05, 0.08]
    rec = gt[:300] + rng.normal(scale=0.01, size=(300, 3))
    return gt, rec


def _boxes():
    rng = np.random.default_rng(11)
    rot = lambda: Rotation.from_quat(rng.normal(size=4))
    return ([0.2, 0.1, 0.15], np.array([0.0, 0.01, 0.5]), rot(),
            [0.18, 0.12, 0.14], np.array([0.02, 0.0, 0.49]), rot())


def _metric_cases():
    gt, rec = _clouds()
    e1, p1, r1, e2, p2, r2 = _boxes()
    return {
        "mean_accuracy": (gt, rec),
        "mean_accuracy_normalized": (gt, rec, 2, True),
        "mean_completeness": (gt, rec),
        "symmetric_chamfer": (gt, rec),
        "symmetric_chamfer_p1_normalized": (gt, rec, 1, True),
        "completeness_thresh": (gt, rec, 0.01),
        "accuracy_thresh": (gt, rec, 0.01),
        "accuracy_thresh_normalized": (gt, rec, 0.05, 2, True),
        "reconstruction_fscore": (gt, rec, 0.01),
        "extent": (gt,),
        "degree_error": (r1, r2),
        "degree_error_symmetric": (r1, r2, 1),
        "box_iou_3d": (e1, p1, r1, e2, p2, r2),
        "symmetric_box_iou": (e1, p1, r1, e2, p2, r2, 1),
        "correct_thresh": (p1, p2, r1, r2, e1, e2, gt, rec, 0.05, 90.0,
                           0.1, 0.1, 1),
    }


@pytest.mark.parametrize("case", sorted(_metric_cases()))
def test_metric_matches_jax(case):
    args = _metric_cases()[case]
    name = next(n for n in ("mean_accuracy", "mean_completeness",
                            "symmetric_chamfer", "completeness_thresh",
                            "accuracy_thresh", "reconstruction_fscore",
                            "extent", "degree_error", "box_iou_3d",
                            "symmetric_box_iou", "correct_thresh")
                if case == n or case.startswith(n + "_"))
    got = getattr(tmetrics, name)(*args)
    want = getattr(jmetrics, name)(*args)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.isfinite(got)


# ---------------------------------------------------------------------------
# scenes and the procedural data set
# ---------------------------------------------------------------------------


def test_scenes_match_jax():
    for name in ("make_sphere_sdf", "make_mug_sdf", "make_mug_family_sdf",
                 "make_bowl_family_sdf"):
        np.testing.assert_array_equal(getattr(tscenes, name)(20),
                                      getattr(jscenes, name)(20))
    for sample in ("sample_mug_family", "sample_bowl_family"):
        assert getattr(tscenes, sample)(np.random.default_rng(5)) == getattr(
            jscenes, sample)(np.random.default_rng(5))
    assert tscenes.MUG_FAMILY_BOUNDS == jscenes.MUG_FAMILY_BOUNDS
    assert tscenes.BOWL_FAMILY_BOUNDS == jscenes.BOWL_FAMILY_BOUNDS


@pytest.mark.parametrize("category", ["mug", "bowl"])
def test_procedural_dataset_equals_jax(tmp_path, native_off, category):
    """seed 777, n 2, res 32 with meshes: the same params, grids and .obj
    files as the JAX package's script on its numpy path."""
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    got = tmpd.generate(str(got_dir), n=2, res=32, seed=777,
                        export_meshes=True, category=category)
    want = jmpd.generate(str(want_dir), n=2, res=32, seed=777,
                         export_meshes=True, category=category)
    assert got == want
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    assert names == ["00000.npy", "00000.obj", "00001.npy", "00001.obj",
                     "params.json"]
    for name in names:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes()


# ---------------------------------------------------------------------------
# sdf_utils
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complete_mesh", [False, True])
def test_mesh_from_sdf_equals_jax(native_off, complete_mesh):
    grid = tscenes.make_mug_sdf(24)
    got = tsdf_utils.mesh_from_sdf(grid, 0.01, complete_mesh)
    want = jsdf_utils.mesh_from_sdf(grid, 0.01, complete_mesh)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.scale == want.scale
    assert tsdf_utils.mesh_from_sdf(grid, 10.0) is None
    v = np.random.default_rng(2).normal(size=(50, 3))
    np.testing.assert_array_equal(tsdf_utils.scale_to_unit_cube(v),
                                  jsdf_utils.scale_to_unit_cube(v))


def test_sdf_to_pointcloud_equals_jax():
    grid = tscenes.make_mug_sdf(24)
    quat = Rotation.from_euler("XYZ", [5, 15, 25], degrees=True).as_quat()
    args = (grid, np.array([0.1, 0.0, 0.4]), quat, 0.12)
    np.testing.assert_array_equal(tsdf_utils.sdf_to_pointcloud(*args),
                                  jsdf_utils.sdf_to_pointcloud(*args))
    kw = dict(threshold=0.1, max_points=200)
    got = tsdf_utils.sdf_to_pointcloud(*args, rng=np.random.default_rng(4),
                                       **kw)
    want = jsdf_utils.sdf_to_pointcloud(*args, rng=np.random.default_rng(4),
                                        **kw)
    assert got.shape == (200, 3)
    np.testing.assert_array_equal(got, want)


def test_mesh_to_sdf_raises_until_the_host_library_is_ported():
    """The host library is ported: the cube voxelizes (inside negative,
    outside positive), and a mesh the voxelizer rejects gives None, as in
    the JAX package.  (Rays along a face's diagonal cross two triangles'
    shared edge, so the x-ray parity misreads cells with y == z, and there
    the result depends on the compiler's contraction of products into FMAs:
    the probe avoids them, and ``test_torch_native.py`` holds the port to
    the JAX package bit for bit on a mesh without such rays.)"""
    v, f = _cube()
    sdf = tsdf_utils.mesh_to_sdf(tsynthetic.Mesh(v, f), 32, padding=2)
    assert sdf.shape == (32, 32, 32) and sdf.dtype == np.float32
    assert sdf[16, 10, 20] < 0 < sdf[0, 0, 0]
    empty = tsynthetic.Mesh(v, np.zeros((0, 3), np.int64))
    assert tsdf_utils.mesh_to_sdf(empty, 32) is None


# ---------------------------------------------------------------------------
# generate_depth / generate_mesh
# ---------------------------------------------------------------------------


def test_generate_depth_matches_jax(pipes):
    """The march gate of the JAX package's kernel tests: hits agree on
    more than 99.5% of the pixels, |ddepth| < 5e-3 where both hit."""
    args = (GT_POSITION, GT_QUAT, GT_HALF, pipes["latent"])
    want = np.asarray(pipes["jpipe"].generate_depth(
        *(jnp.asarray(a) for a in args)), np.float32)
    got = pipes["pipe"].generate_depth(*(torch.as_tensor(a) for a in args))
    assert got.shape == (96, 128) and got.device.type == "cpu"
    got = got.numpy()
    both = (got > 0) & (want > 0)
    assert both.sum() > 150
    assert ((got > 0) == (want > 0)).mean() > 0.995
    assert np.abs(got - want)[both].max() < 5e-3


def test_render_takes_the_config_options(pipes, monkeypatch):
    """``render`` hands the config's march options to ``render_depth``."""
    from sdfest_torch.pipeline import pipeline as tpipeline

    seen = {}
    monkeypatch.setattr(tpipeline, "render_depth",
                        lambda *a, **kw: seen.update(kw))
    pipe = SDFPipeline(_config(relaxation=1.5, bf16_march=True,
                               threshold=0.004), device="cpu")
    pipe.render(None, None, None, None)
    assert {k: seen[k] for k in ("threshold", "relaxation", "culling",
                                 "bf16", "adaptive")} == dict(
        threshold=0.004, relaxation=1.5, culling=False, bf16=True,
        adaptive=False)
    assert seen["camera"] == pipe.camera and seen["device"] == pipe.device


@pytest.mark.parametrize("complete_mesh", [False, True])
def test_generate_mesh_matches_jax(pipes, native_off, complete_mesh):
    """The same triangles (vertex positions within 1e-4) at the estimate's
    scale.  The vertex arrays are compared through the faces: the decoders
    differ by ~1e-7, which can reorder vertices whose merge keys (rounded
    to 1e-6) sort next to each other."""
    latent, scale = pipes["latent"], np.asarray([0.12], np.float32)
    want = pipes["jpipe"].generate_mesh(jnp.asarray(latent),
                                        jnp.asarray(scale), complete_mesh)
    got = pipes["pipe"].generate_mesh(torch.as_tensor(latent),
                                      torch.as_tensor(scale), complete_mesh)
    assert isinstance(got, tsynthetic.Mesh)
    assert len(got.faces) == len(want.faces) > 1000
    assert len(got.vertices) == len(want.vertices)
    assert np.isclose(got.scale, want.scale, rtol=1e-6)
    np.testing.assert_allclose(got.vertices[got.faces],
                               want.vertices[want.faces], atol=1e-4)
    np.testing.assert_allclose(got.get_transformed_vertices()[got.faces],
                               want.get_transformed_vertices()[want.faces],
                               atol=1e-4)


def test_generate_mesh_outside_the_range_is_none(pipes):
    for level in (-100.0, 100.0):
        pipe = SDFPipeline(_config(iso_threshold=level), device="cpu")
        assert pipe.generate_mesh(pipes["latent"], 0.1) is None
