"""Parity of the port's category-level evaluation with the JAX package's
(CPU): ``CategoryEvaluator`` on the fake datasets and pipelines of
``test_eval_scripts.py``, a real ``SDFPipeline`` on the committed mug
weights at a small NOCS-like camera (``pixel_center`` 0, an off-centre
principal point), the datasets ``_make_dataset`` builds, the packaged-config
resolution, and the three presets of this evaluation path against their
YAML.

The port scores the pipeline's estimate after converting it from the
pipeline's camera convention (OpenGL) to the samples' (OpenCV); the JAX
package scores it as it comes.  So the port's stubs return what a pipeline
would, the OpenGL form of the JAX stubs' poses, and the JAX package's real
pipeline is wrapped to hand its evaluator the OpenCV form: both then score
the same estimate.  JAX runs in float64 here (``tests/conftest.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import xla
from sdfest_tpu.scripts import category_evaluation as jce
from sdfest_tpu.utils import config as jconfig
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.pipeline import synthetic as tsynthetic
from sdfest_torch.pipeline.pipeline import NoDepthError, SDFPipeline
from sdfest_torch.scripts import category_evaluation as tce
from sdfest_torch.utils import config as tconfig
from sdfest_torch.utils.presets import preset

from test_datasets import _make_redwood_fixture
from test_eval_scripts import (
    _category_config,
    _category_sample,
    _cube_mesh,
    _FakeCategoryDataset,
    _FakePipeline,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a NOCS-like camera at 1/10 of the REAL camera's raster: pixel_center 0
# and an off-centre principal point
NOCS_LIKE = dict(width=64, height=48, fx=59.10125, fy=59.016775, cx=32.2525,
                 cy=24.411084, pixel_center=0)
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
GT_POSITION_GL = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT_GL = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GL2CV = np.array([1.0, 0.0, 0.0, 0.0])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (many small CPU ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_gl(position, quaternion):
    """OpenCV -> OpenGL camera frame (the same flip both ways)."""
    p = np.asarray(position, np.float64) * [1.0, -1.0, -1.0]
    q = Rotation.from_quat(GL2CV) * Rotation.from_quat(
        np.asarray(quaternion, np.float64))
    return p, q.as_quat()


class _PortPipeline:
    """The port's counterpart of ``_FakePipeline``: the same pose as a
    pipeline would report it (OpenGL), a port mesh, the port's
    NoDepthError."""

    def __init__(self, position, quaternion, scale, fail=False):
        p, q = _to_gl(position, quaternion)
        self._out = (torch.tensor(p[None], dtype=torch.float32),
                     torch.tensor(q[None], dtype=torch.float32),
                     torch.tensor([scale], dtype=torch.float32),
                     torch.zeros(1, 8))
        self._fail = fail
        self.calls = 0

    def __call__(self, depth, mask, **kwargs):
        self.calls += 1
        if self._fail is True or (self._fail == "second" and self.calls > 1):
            raise NoDepthError("no depth")
        return self._out

    def generate_mesh(self, latent, scale, complete_mesh=False):
        v, f = _cube_mesh()
        return tsynthetic.Mesh(vertices=v, faces=f, scale=float(
            np.asarray(scale).reshape(-1)[0]), rel_scale=False)


class _JaxHalfFail(_FakePipeline):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.calls = 0

    def __call__(self, depth, mask, **kwargs):
        self.calls += 1
        if self.calls > 1:
            from sdfest_tpu.pipeline.pipeline import NoDepthError as JError

            raise JError("no depth")
        return super().__call__(depth, mask)


ROT7 = Rotation.from_euler("z", 7, degrees=True).as_quat()
ROT90Y = Rotation.from_euler("y", 90, degrees=True).as_quat()
IDENTITY = [0.0, 0.0, 0.0, 1.0]
# (samples, {category: (position, quaternion, scale, fail)}, config edits):
# the scenarios of test_eval_scripts.py's category tests
SCENARIOS = {
    "perfect": ([("mug",)], {"mug": ([0, 0, 0.3], IDENTITY, 0.05, False)},
                {}),
    "threshold_grid": ([("mug",)], {"mug": ([0.07, 0, 0.3], ROT7, 0.05,
                                            False)}, {"out_folder": None}),
    "symmetry": ([("bowl",), ("bowl",), ("camera",)],
                 {"bowl": ([0, 0, 0.3], ROT90Y, 0.05, False)},
                 {"out_folder": None}),
    "failures": ([("bowl",), ("bowl",)],
                 {"bowl": ([0, 0, 0.3], ROT90Y, 0.05, True)},
                 {"out_folder": None}),
    "half_fail": ([("mug",), ("mug",)],
                  {"mug": ([0, 0, 0.3], IDENTITY, 0.05, "second")},
                  {"out_folder": None}),
    "config_robustness": ([("mug",)], {"mug": ([0, 0, 0.3], IDENTITY, 0.05,
                                               False)},
                          {"out_folder": None, "dataset": None,
                           "correctness": None}),
}


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for cat, agg in want.items():
        assert got[cat]["count"] == agg["count"]
        assert got[cat]["failed"] == agg["failed"]
        assert got[cat]["correctness"] == agg["correctness"]
        assert set(got[cat]["means"]) == set(agg["means"])
        for name, value in agg["means"].items():
            np.testing.assert_allclose(got[cat]["means"][name], value,
                                       rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_category_evaluator_equals_jax_on_stubs(tmp_path, name):
    samples, poses, edits = SCENARIOS[name]
    config = _category_config(tmp_path)
    for key, value in edits.items():
        if value is None and key == "dataset":
            del config[key]
        else:
            config[key] = value
    jpipes, pipes = {}, {}
    for cat, (pos, quat, scale, fail) in poses.items():
        if fail == "second":
            jpipes[cat] = _JaxHalfFail(pos, quat, scale)
        else:
            jpipes[cat] = _FakePipeline(pos, quat, scale, fail=fail)
        pipes[cat] = _PortPipeline(pos, quat, scale, fail=fail)
    dataset = _FakeCategoryDataset([_category_sample(*s) for s in samples])
    if config.get("out_folder"):
        config["out_folder"] = str(tmp_path / "jax")
    want = jce.CategoryEvaluator(dict(config), dataset, jpipes).run()
    if config.get("out_folder"):
        config["out_folder"] = str(tmp_path / "port")
    evaluator = tce.CategoryEvaluator(dict(config), dataset, pipes,
                                      device="cpu")
    got = evaluator.run()
    _assert_results_equal(got, want)
    n_ok = sum(r["count"] - r["failed"] for c, r in want.items() if c != "all")
    assert len(evaluator.timings) == n_ok
    assert all(set(t) == {"call", "generate_mesh", "metrics"}
               for t in evaluator.timings)
    if name == "perfect":
        assert all(v == 1.0 for v in got["mug"]["correctness"].values())
        (out,) = os.listdir(tmp_path / "port")
        assert out.startswith("category_eval_test_") and out.endswith(".yaml")
        saved = tconfig.load_config_from_file(str(tmp_path / "port" / out))
        assert saved["results"]["all"]["count"] == 1


def test_estimate_is_scored_in_the_samples_convention():
    """A pipeline reporting the ground truth in its own convention scores
    0 error; the same numbers taken as OpenCV would be ~0.6 m off."""
    sample = _category_sample("mug", position=(0.01, -0.02, 0.3))
    pipe = _PortPipeline(sample["position"], sample["quaternion"], 0.05)
    ev = tce.CategoryEvaluator({"metrics": {}}, _FakeCategoryDataset(
        [sample]), {"mug": pipe}, device="cpu")
    record = ev.evaluate_sample(sample)
    assert record["position_error"] < 1e-7 and record["degree_error"] < 1e-4
    assert record["iou_3d"] > 0.99
    p, q = tce._to_sample_convention(*pipe._out[:2])
    np.testing.assert_allclose(p, sample["position"], atol=1e-7)


# ---------------------------------------------------------------------------
# a real pipeline on the committed mug weights
# ---------------------------------------------------------------------------


def _mug_config(**overrides):
    config = preset("mug_procedural")
    config.update(camera=dict(NOCS_LIKE), max_iterations=3, **PLAIN)
    config.update(overrides)
    return config


@pytest.fixture(scope="module")
def jax_draws():
    """The port's subsampling fed JAX's draws of ``key=None`` (one view)."""
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpointset, "_uniform",
                   lambda n, g, d: torch.from_numpy(u[:n]))
        yield


class _OpenCVEstimates:
    """A JAX pipeline whose estimates reach the JAX evaluator in OpenCV
    (what the port's evaluator does to its pipeline's); records them."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.outputs = None

    def __call__(self, depth, mask, **kwargs):
        position, orientation, scale, latent = self.pipe(
            jnp.asarray(depth), jnp.asarray(mask), **kwargs)
        self.outputs = (position, orientation, scale, latent)
        return (
            jpointset.change_position_camera_convention(
                position, "opengl", "opencv"),
            jpointset.change_orientation_camera_convention(
                orientation, "opengl", "opencv"),
            scale, latent)

    def generate_mesh(self, *args, **kwargs):
        return self.pipe.generate_mesh(*args, **kwargs)


def test_category_evaluator_real_pipeline_equals_jax(tmp_path, jax_draws):
    """3 iterations on a NOCS-like camera: the pipeline's outputs within
    1e-4 of JAX's and the records (pose errors, IoU, chamfer) within 1e-3."""
    jpipe = JPipeline(_mug_config(fused_call=False))
    latent = (0.5 * np.random.default_rng(0).normal(size=(1, 8))).astype(
        np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = np.array(xla.render_depth(
        sdf, GT_POSITION_GL, GT_QUAT_GL, 1.0 / 0.1,
        camera=JCamera(**NOCS_LIKE), threshold=0.005), dtype=np.float32)
    assert (depth > 0).sum() > 100
    sample = _category_sample("mug")
    p_cv, q_cv = _to_gl(GT_POSITION_GL, GT_QUAT_GL)  # the flip is its own inverse
    sample.update(depth=depth, mask=depth > 0,
                  position=p_cv.astype(np.float32),
                  quaternion=q_cv.astype(np.float32),
                  scale=np.full(3, 0.2, np.float32))
    config = _category_config(tmp_path)
    config.update(out_folder=None, samples=500)
    dataset = _FakeCategoryDataset([sample])
    jwrapped = _OpenCVEstimates(jpipe)
    want_ev = jce.CategoryEvaluator(dict(config), dataset, {"mug": jwrapped})
    want = want_ev.evaluate_sample(sample)
    pipe = _Recording(SDFPipeline(_mug_config(), device="cpu"))
    ev = tce.CategoryEvaluator(dict(config), dataset, {"mug": pipe},
                               device="cpu")
    got = ev.evaluate_sample(sample)
    for g, w in zip(pipe.outputs, jwrapped.outputs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=1e-4)
    assert set(got) == set(want)
    assert not got["failed"]
    for key in ("position_error", "degree_error", "iou_3d", "chamfer"):
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                   err_msg=key)


class _Recording:
    """A port pipeline that keeps its last estimate."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.outputs = None

    def __call__(self, *args, **kwargs):
        self.outputs = self.pipe(*args, **kwargs)
        return self.outputs

    def generate_mesh(self, *args, **kwargs):
        return self.pipe.generate_mesh(*args, **kwargs)


# ---------------------------------------------------------------------------
# datasets, configs, presets
# ---------------------------------------------------------------------------


def test_make_dataset_redwood_equals_jax(tmp_path):
    root_dir, ann_dir, _, _ = _make_redwood_fixture(tmp_path)
    config = {"dataset": "redwood", "data_path": str(root_dir),
              "ann_dir": str(ann_dir)}
    got = tce._make_dataset(dict(config))[0]
    want = jce._make_dataset(dict(config))[0]
    assert sorted(got) == sorted(want)
    for key in ("depth", "mask", "pointset", "position", "quaternion",
                "scale"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scale"], [0.2, 0.2, 0.2])  # full extents
    with pytest.raises(ValueError, match="Unsupported dataset"):
        tce._make_dataset({"dataset": "ycb", "data_path": "."})


def test_packaged_config_resolution(monkeypatch):
    """``category_configs`` paths resolve against the JAX package's
    configs (read as data), as there; dict entries merge as they are."""
    built = []

    class _Probe:
        def __init__(self, config, device):
            built.append((config, device))

    monkeypatch.setattr(tce, "SDFPipeline", _Probe)
    config = tconfig.load_config_from_file(
        "configs/estimation/real275_evaluation.yaml")
    assert config == jconfig.load_config_from_file(os.path.join(
        jce._ESTIMATION_CONFIG_DIR, "real275_evaluation.yaml"))
    ev = tce.CategoryEvaluator(config, dataset=_FakeCategoryDataset([]),
                               device="cpu")
    assert ev._pipeline_for("mug") is not None
    got, device = built[-1]
    assert device == "cpu"
    assert got["vae"]["latent_size"] == 8
    assert got["max_iterations"] == 30
    assert got["camera"]["width"] == 640
    assert got["init"]["model"].endswith("mug_init.pt")
    assert ev._pipeline_for("unknown") is None
    # the preset's dict entries (no YAML needed)
    ev = tce.CategoryEvaluator(preset("real275_evaluation_procedural"),
                               dataset=_FakeCategoryDataset([]), device="cpu")
    assert ev._pipeline_for("bowl") is not None
    got, _ = built[-1]
    assert got["category"] == "bowl" and got["max_iterations"] == 30
    assert got["camera"]["cx"] == 322.525
    assert got["vae"]["model"].endswith("bowl_procedural.msgpack")
    assert ev._pipeline_for("laptop") is None


PRESET_YAML = {
    # preset -> (YAML files merged in order; the later wins key by key)
    "bowl_procedural": ["models/bowl_procedural.yaml", "default.yaml"],
    "runtime_analysis_demo": ["runtime_analysis_demo.yaml"],
    "real275_evaluation_procedural": ["real275_evaluation.yaml"],
}


@pytest.mark.parametrize("name", sorted(PRESET_YAML))
def test_presets_match_resolved_yaml(name):
    base = os.path.join(ROOT, "sdfest_tpu", "configs", "estimation")
    want = {}
    for f in PRESET_YAML[name]:
        want.update(jconfig.load_config_from_file(os.path.join(base, f)))
    if name == "real275_evaluation_procedural":
        want["category_configs"] = {
            cat: jconfig.load_config_from_file(os.path.join(
                base, "models", f"{cat}_procedural.yaml"))
            for cat in ("mug", "bowl")}
    assert preset(name) == want
