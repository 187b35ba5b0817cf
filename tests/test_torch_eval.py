"""Parity of the port's flight recorder, log playback, config overlays and
synthetic rendering evaluation with the JAX package's (CPU), on the
committed mug weights at a 128x96 camera (64x48 for the fast preset).

The call tests feed the port JAX's point-subsampling draws and turn culling
and adaptive relaxation off (the JAX package's CPU backend marches without
them), as ``test_torch_pipeline.py`` does.  The evaluation meshes come from
the port's ``make_procedural_dataset`` at a small resolution (the
rasterizer loops over faces in Python).  JAX runs in float64 here
(``tests/conftest.py``); its outputs are cast to float32.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from sdfest_tpu.native import api as jnative
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import xla
from sdfest_tpu.scripts import play_log as jplay_log
from sdfest_tpu.scripts import rendering_evaluation as jrend_eval
from sdfest_tpu.utils import config as jconfig
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.pipeline import metrics as tmetrics
from sdfest_torch.pipeline import synthetic as tsynthetic
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.scripts import make_procedural_dataset as tmpd
from sdfest_torch.scripts import play_log as tplay_log
from sdfest_torch.scripts import rendering_evaluation as trend_eval
from sdfest_torch.utils import config as tconfig
from sdfest_torch.utils.presets import preset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
              pixel_center=0.5)
SMALL_CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
                    pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
STATE_KEYS = ("position", "orientation", "scale", "latent")
# rendering_evaluation.yaml's keys (its metrics in the JAX package's names)
EVAL_KEYS = dict(camera_distance=0.3, mesh_scale=0.1, rel_scale=False,
                 samples=2000, seed=0, shape_optimization=True,
                 metrics=yaml.safe_load(open(os.path.join(
                     ROOT, "sdfest_tpu/configs/estimation/"
                     "rendering_evaluation.yaml")))["metrics"])


def _config(camera=CAMERA, **overrides):
    config = preset("mug_procedural")
    config.update(camera=dict(camera), max_iterations=3, **PLAIN)
    config.update(overrides)
    return config


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (many small CPU ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_draws():
    """The port's subsampling fed JAX's draws of ``key=None`` (one view),
    for the module's calls."""
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpointset, "_uniform",
                   lambda n, g, d: torch.from_numpy(u[:n]))
        yield


def _observation(camera, latent_seed=0):
    jpipe = JPipeline(_config(camera, fused_call=False))
    latent = (0.5 * np.random.default_rng(latent_seed).normal(size=(1, 8))
              ).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                                 camera=JCamera(**camera), threshold=0.005))
    assert (depth > 0).sum() > 100
    return depth


def _record(tmp, config, depth, **call_kwargs):
    """``(port pipeline, port log, JAX log)`` of one call each with
    ``log_path``."""
    paths = [os.path.join(tmp, f"{name}.pkl") for name in ("port", "jax")]
    mask = depth > 0
    JPipeline(dict(config))(jnp.asarray(depth), jnp.asarray(mask),
                            log_path=paths[1], **call_kwargs)
    pipe = SDFPipeline(dict(config), device="cpu")
    pipe(torch.from_numpy(depth), torch.from_numpy(mask), log_path=paths[0],
         **call_kwargs)
    return (pipe, *(tplay_log.load_log(p) for p in paths), paths)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory, jax_draws):
    tmp = str(tmp_path_factory.mktemp("recorder"))
    depth = _observation(CAMERA)
    pipe, got, want, paths = _record(tmp, _config(), depth)
    return dict(pipe=pipe, got=got, want=want, paths=paths, depth=depth,
                tmp=tmp)


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _check_log_like_jax(got, want):
    """The same keys and shapes; numpy only; losses within rtol 1e-4."""
    assert not any(isinstance(x, torch.Tensor) for x in _leaves(got))
    assert set(got) == set(want) == {"config", "log"}
    assert set(got["log"]) == set(want["log"])
    for k, w in want["log"].items():
        g = got["log"][k]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), k
            assert g.shape == w.shape, k
        else:
            assert type(g) is type(w), k
    for k in ("loss", "loss_depth", "loss_pc"):
        np.testing.assert_allclose(got["log"][k], _np(want["log"][k]),
                                   rtol=1e-4)
    np.testing.assert_array_equal(got["log"]["depth_input"],
                                  _np(want["log"]["depth_input"]))


def test_flight_recorder_matches_jax(recorded):
    got, want = recorded["got"], recorded["want"]
    _check_log_like_jax(got, want)
    assert len(got["log"]["loss"]) == 3
    assert "multires_boundary" not in got["log"]
    for k in STATE_KEYS:
        np.testing.assert_allclose(got["log"][k], _np(want["log"][k]),
                                   atol=1e-4)
    last = recorded["pipe"].last_log
    np.testing.assert_array_equal(got["log"]["loss"], last["loss"].numpy())
    assert got["config"] == recorded["pipe"].config
    assert 0.0 < got["log"]["timestamp"] < 600.0


def test_flight_recorder_multires_boundaries_match_jax(tmp_path, jax_draws):
    """The fast preset's [4, 2] schedule: the boundaries of JAX's plan."""
    config = preset("mug_procedural_fast")
    config.update(camera=dict(SMALL_CAMERA), max_iterations=5,
                  roi_margin=16, **PLAIN)
    depth = _observation(SMALL_CAMERA)
    pipe, got, want, _ = _record(str(tmp_path), config, depth)
    _check_log_like_jax(got, want)
    assert want["log"]["multires_boundaries"] == [2, 4]
    assert got["log"]["multires_boundaries"] == [2, 4]
    assert got["log"]["multires_boundary"] == 4
    assert type(got["log"]["multires_boundary"]) is int


def test_logs_play_back_in_either_package(recorded, tmp_path):
    """JAX's play_log reads the port's pickle, the port's reads JAX's."""
    port_path, jax_path = recorded["paths"]
    data = jplay_log.load_log(port_path)
    np.testing.assert_array_equal(data["log"]["loss"],
                                  recorded["got"]["log"]["loss"])
    jplay_log.plot_trajectories(data["log"], str(tmp_path / "jax.png"))
    data = tplay_log.load_log(jax_path)
    tplay_log.plot_trajectories(data["log"], str(tmp_path / "port.png"))
    assert (tmp_path / "jax.png").stat().st_size > 0
    assert (tmp_path / "port.png").stat().st_size > 0
    _, frames, indices = tplay_log._render_frames(data, 2, device="cpu")
    assert indices == [0, 2] and frames[0].shape == (96, 128)
    assert all(isinstance(f, np.ndarray) and (f > 0).any() for f in frames)


def test_render_frames_and_export_meshes(recorded, tmp_path):
    data, pipe = recorded["got"], recorded["pipe"]
    _, frames, indices = tplay_log._render_frames(data, 1, pipeline=pipe)
    assert indices == [0, 1, 2]
    log = pipe.last_log
    want = pipe.generate_depth(log["position"][2][0], log["orientation"][2][0],
                               log["scale"][2][0], log["latent"][2])
    np.testing.assert_array_equal(frames[2], want.numpy())
    tplay_log.export_meshes(data, str(tmp_path / "meshes"), stride=2,
                            device="cpu")
    names = sorted(os.listdir(tmp_path / "meshes"))
    assert names == ["00000.obj", "00002.obj"]
    v, f = tsynthetic.load_obj(str(tmp_path / "meshes" / names[-1]))
    mesh = pipe.generate_mesh(log["latent"][2], log["scale"][2][0], True)
    assert len(f) == len(mesh.faces) > 1000
    np.testing.assert_allclose(v, mesh.get_transformed_vertices(), atol=1e-6)


@pytest.mark.parametrize("mode", ["depth", "error", "mesh"])
def test_export_animation_writes_a_movie_or_its_frames(recorded, tmp_path,
                                                       mode):
    out = str(tmp_path / f"{mode}.mp4")
    tplay_log.export_animation(recorded["got"], out, stride=1, mode=mode,
                               pipeline=recorded["pipe"])
    frames = str(tmp_path / f"{mode}_frames.npz")
    assert os.path.exists(out) or os.path.exists(frames)
    if not os.path.exists(out):  # no movie writer here: the frames
        assert np.load(frames)["frames"].shape == (3, 96, 128)
    with pytest.raises(ValueError, match="Unknown animation mode"):
        tplay_log.export_animation(recorded["got"], out, mode="nope",
                                   pipeline=recorded["pipe"])


def test_call_animation_and_visualize_write_their_files(recorded, tmp_path):
    depth = torch.from_numpy(recorded["depth"])
    path = str(tmp_path / "figure.png")
    pipe = SDFPipeline(_config(visualization_path=path), device="cpu")
    out = str(tmp_path / "call.mp4")
    want = recorded["pipe"](depth, depth > 0)
    got = pipe(depth, depth > 0, visualize=True, animation_path=out,
               animation_mode="error")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert os.path.getsize(path) > 0
    assert os.path.exists(out) or os.path.exists(
        str(tmp_path / "call_frames.npz"))


# ---------------------------------------------------------------------------
# the rendering evaluation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("meshes"))
    tmpd.generate(out, n=1, res=16, seed=777, export_meshes=True)
    return out


def _eval_config(mesh_dir, **overrides):
    config = _config(**EVAL_KEYS)
    config.update(data_path=mesh_dir, num_views=[1], out_folder=None,
                  pose_metrics=True)
    config.update(overrides)
    return config


def test_generate_views_matches_jax(mesh_dir):
    """Depth images equal, camera poses within 1e-6 (JAX in float64 here,
    as the port's float64 camera arithmetic)."""
    config = _eval_config(mesh_dir)
    path = os.path.join(mesh_dir, "00000.obj")
    mesh = lambda m: m.Mesh(path=path, scale=0.1, center=True)
    got = trend_eval.Evaluator(config, device="cpu")._generate_views(
        mesh(tsynthetic), 2)
    want = jrend_eval.Evaluator(config)._generate_views(
        mesh(jrend_eval.synthetic), 2)
    assert set(got) == set(want)
    for k in ("depth_images", "masks"):
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    for k in ("camera_positions", "camera_orientations"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6)
    assert got["depth_images"].shape == (2, 96, 128)
    assert (got["depth_images"] > 0).sum() > 200


def test_evaluator_matches_jax(mesh_dir, jax_draws, monkeypatch):
    """One mesh, one view: the pipeline's outputs within 1e-4 of JAX's,
    the metrics (the evaluation config's five and the pose errors) within
    1e-3, and the same keys (the JAX package's estimated mesh from its
    numpy marching tetrahedra)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    outputs = {}

    def recording(cls, name):
        call = cls.__call__

        def wrapped(self, *args, **kwargs):
            outputs[name] = call(self, *args, **kwargs)
            return outputs[name]
        monkeypatch.setattr(cls, "__call__", wrapped)

    recording(JPipeline, "jax")
    recording(SDFPipeline, "port")
    config = _eval_config(mesh_dir)
    want = jrend_eval.Evaluator(config).run()
    evaluator = trend_eval.Evaluator(config, device="cpu")
    got = evaluator.run()
    for g, w in zip(outputs["port"], outputs["jax"]):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    assert set(got) == set(want) == {1}
    assert set(got[1]) == set(want[1]) == set(EVAL_KEYS["metrics"]) | {
        "position_error", "orientation_deg"}
    for name, stats in want[1].items():
        assert set(got[1][name]) == set(stats) == {"mean", "var", "std"}
        assert np.isfinite(got[1][name]["mean"])
        np.testing.assert_allclose(got[1][name]["mean"], stats["mean"],
                                   atol=1e-3)
    assert [set(t) for t in evaluator.timings] == [
        {"rasterize_s", "call_s", "mesh_s", "metrics_s"}]


def test_evaluator_ablations_write_yaml(mesh_dir, tmp_path):
    """The ablation loop overlays each config on the base (the production
    overlay's plan runs coarse levels) and writes the results file."""
    config = _eval_config(
        mesh_dir, out_folder=str(tmp_path), run_name="test",
        max_iterations=5, pose_metrics=False,
        ablation_configs={"standard": {}, "production": {
            "roi_size": "auto", "multires_factor": [4, 2],
            "multires_iterations": "auto"}})
    del config["metrics"]  # the evaluator's defaults
    evaluator = trend_eval.Evaluator(config, device="cpu")
    results = evaluator.run()
    assert evaluator.pipeline.last_plan[0]  # production: coarse levels ran
    assert set(results) == {"standard", "production"}
    for res in results.values():
        assert set(res[1]) == set(trend_eval.DEFAULT_METRICS)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("rend_eval_test_") and name.endswith(".yaml")
    with open(tmp_path / name) as f:
        saved = yaml.safe_load(f)
    assert saved["results"]["production"][1]["chamfer"]["mean"] == (
        results["production"][1]["chamfer"]["mean"])
    assert len(evaluator.timings) == 2


def test_metric_names_resolve_to_the_port_without_the_jax_package():
    """The JAX package's and the upstream metric names map to the port's
    functions by name, with the JAX package blocked."""
    names = [m["f"] for m in EVAL_KEYS["metrics"].values()] + [
        m["f"] for m in jrend_eval.DEFAULT_METRICS.values()] + [
        "sdfest.estimation.metrics.symmetric_chamfer",
        "sdfest_torch.pipeline.metrics.reconstruction_fscore"]
    for name in names:
        fn = trend_eval._resolve_metric(name)
        assert fn is getattr(tmetrics, name.rsplit(".", 1)[1])
    for bad in ("sdfest_tpu.ops.sdf_utils.mesh_from_sdf",
                "sdfest_torch.pipeline.metrics.nope"):
        with pytest.raises(ValueError, match="Cannot resolve"):
            trend_eval._resolve_metric(bad)
    code = (
        "import sys\n"
        "for m in ('jax', 'sdfest_tpu', 'yaml', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "from sdfest_torch.scripts.rendering_evaluation import "
        "_resolve_metric\n"
        f"print([_resolve_metric(n).__module__ for n in {names!r}])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("sdfest_torch.pipeline.metrics") == len(names)


def test_config_overlays_and_yaml_output_match_jax(tmp_path):
    base = _eval_config("data", ablation_configs={"a": {}})
    for overlay in ({}, {"roi_size": "auto", "multires_factor": [4, 2]},
                    {"init": {"model": None}, "camera": {"fx": 10}}, None):
        got = tconfig.load_config(overlay, base)
        assert got == jconfig.load_config(overlay, base)
        assert got is not base and got["init"] is not base["init"]
    # includes, in a dict overlay and as a file, resolve as in the JAX
    # package (the JAX package's configs are read as data)
    for overlay in ({"init": {"config": "configs/init/mug_procedural_v3.yaml"}},
                    "configs/estimation/default.yaml"):
        assert tconfig.load_config(overlay, base) == jconfig.load_config(
            overlay, base)
    data = {"t": torch.tensor(1.5), "a": np.arange(3), "n": np.float32(2.0),
            "nested": {"l": (1, torch.tensor([2.0, 3.0]))}}
    path = str(tmp_path / "sub" / "out.yaml")
    tconfig.save_config_to_file(path, data)
    with open(path) as f:
        assert yaml.safe_load(f) == {"t": 1.5, "a": [0, 1, 2], "n": 2.0,
                                     "nested": {"l": [1, [2.0, 3.0]]}}
