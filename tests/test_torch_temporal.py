"""Parity of the port's refinement options with the JAX package (CPU):
temporal coherence (the warm refinement loop), early stop, and the log
they write, on the committed mug weights at a small 64x48 camera.

JAX's warm refinement runs on its pallas backend in interpret mode
(``renderer_backend: pallas``), as its own tests run it; the early-stop
trajectories take the XLA backend, so the port turns culling and adaptive
relaxation off there, as ``test_torch_pipeline.py`` does.
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import xla
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.utils.presets import preset

CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
              pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
KEYS = ("position", "orientation", "scale", "latent")
WARM = dict(temporal_coherence=True, temporal_refresh_interval=4)
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
EARLY = dict(early_stop_delta=1.0, early_stop_interval=2)


def _config(**overrides):
    config = preset("mug_procedural")
    config["camera"] = dict(CAMERA)
    config["max_iterations"] = 8
    config.update(overrides)
    return config


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def scene():
    """An observation of a decoded mug at a ground-truth pose, its lifted
    tile-order cloud and a perturbed start state."""
    jpipe = JPipeline(_config(fused_call=False))
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                                 camera=JCamera(**CAMERA), threshold=0.005))
    assert (depth > 0).sum() > 200
    points, mask = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(depth), JCamera(**CAMERA), order="tile")
    turn = Rotation.from_euler("XYZ", [4, -3, 5], degrees=True)
    start = {
        "position": (GT_POSITION + [0.01, -0.008, 0.015])[None].astype(
            np.float32),
        "orientation": (turn * Rotation.from_quat(GT_QUAT)).as_quat()[None]
        .astype(np.float32),
        "scale": np.asarray([0.11], np.float32),
        "latent": (latent + 0.1 * rng.normal(size=(1, 8))).astype(np.float32),
    }
    return dict(depth=depth, points=_np(points), mask=np.array(mask),
                start=start)


def _jax_refine(scene, n, **overrides):
    jpipe = JPipeline(_config(fused_call=False, **overrides))
    return jpipe._refine(
        {k: jnp.asarray(v) for k, v in scene["start"].items()},
        jnp.asarray(scene["depth"])[None], jnp.asarray(scene["points"])[None],
        jnp.asarray(scene["mask"])[None], jnp.zeros((1, 3), jnp.float32),
        jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32), True, None, None,
        1, n)


def _port_refine(scene, n, **overrides):
    pipe = SDFPipeline(_config(**overrides), device="cpu")
    return pipe._refine(
        {k: torch.from_numpy(v) for k, v in scene["start"].items()},
        torch.from_numpy(scene["depth"]), torch.from_numpy(scene["points"]),
        torch.from_numpy(scene["mask"]), num_iterations=n)


@pytest.fixture(scope="module")
def warm_runs(scene):
    """8 warm iterations (refresh every 4) in both packages, and 8 cold
    ones in the port."""
    return dict(
        jax=_jax_refine(scene, 8, renderer_backend="pallas", **WARM),
        port=_port_refine(scene, 8, **WARM),
        cold=_port_refine(scene, 8),
    )


def test_warm_refine_tracks_jax_and_cold(warm_runs):
    """The warm trajectory against JAX's warm _refine (the bar of
    ``test_refine_with_culling_and_adaptive_march_tracks_jax``), and its
    end state against the port's cold _refine (JAX's own warm-vs-cold bar,
    ``tests/test_pipeline.py:259-266``)."""
    jstate, _, jlog = warm_runs["jax"]
    state, _, log = warm_runs["port"]
    want = _np(jlog["loss"])
    assert want[-1] < want[0]
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=0.05)
    for k in ("position", "scale"):
        np.testing.assert_allclose(state[k].numpy(), _np(jstate[k]),
                                   atol=2e-3)
        np.testing.assert_allclose(state[k].numpy(),
                                   warm_runs["cold"][0][k].numpy(), atol=2e-3)


def test_warm_refine_renders_through_the_warm_march(scene, monkeypatch):
    """Every warm iteration renders with render_depth_warm (no fused op),
    refreshing every 4th; later iterations skip or warm-start rays."""
    from sdfest_torch.pipeline import pipeline as tpipeline
    from sdfest_torch.render import warm

    calls = []

    def spy(*args, **kwargs):
        calls.append(args[6])  # full_refresh
        depth, state = warm.warm_render_step(*args, **kwargs)
        calls[-1] = (calls[-1], int((state["macc"] > 0).sum()))
        return depth, state

    monkeypatch.setattr(tpipeline, "warm_render_step", spy)
    monkeypatch.setattr(tpipeline, "render_depth_with_pc_values", None)
    _port_refine(scene, 8, **WARM)
    assert [c[0] for c in calls] == [True, False, False, False] * 2
    # skipped rays accumulate motion between refreshes
    assert all(c[1] == 0 for c in calls if c[0])
    assert any(c[1] > 0 for c in calls if not c[0])


@pytest.fixture(scope="module")
def early_runs(scene):
    return dict(jax=_jax_refine(scene, 8, **PLAIN, **EARLY),
                port=_port_refine(scene, 8, **PLAIN, **EARLY))


def test_early_stop_matches_jax(early_runs):
    """delta 1.0 / interval 2 freezes after the second check: the active
    flags equal JAX's, the losses agree at rtol 1e-4, the frozen rows repeat
    the last active row, and the final state is the last active one."""
    jstate, jbest, jlog = early_runs["jax"]
    state, best, log = early_runs["port"]
    active = log["active"].numpy()
    np.testing.assert_array_equal(active, _np(jlog["active"]))
    assert 0 < active.sum() < 8 and (np.diff(active) <= 0).all()
    np.testing.assert_allclose(log["loss"].numpy(), _np(jlog["loss"]),
                               rtol=1e-4)
    last = int(active.sum()) - 1
    for k in ("loss", "inlier_ratio", *KEYS):
        for row in range(last + 1, 8):
            assert torch.equal(log[k][row], log[k][last])
    for k in KEYS:
        assert torch.equal(state[k], log[k][last])
        np.testing.assert_allclose(state[k].numpy(), _np(jstate[k]),
                                   atol=1e-4)
        np.testing.assert_allclose(best[k].numpy(), _np(jbest[k]), atol=1e-4)


@pytest.mark.parametrize("run", ["warm", "early", "plain"])
def test_refine_log_keys_match_jax(scene, warm_runs, early_runs, run):
    """The port's per-iteration log has the JAX log's keys, ``active``
    included (1 on every row without early stop)."""
    if run == "plain":
        jlog, log = _jax_refine(scene, 2, **PLAIN)[2], _port_refine(
            scene, 2, **PLAIN)[2]
        assert log["active"].tolist() == [1.0, 1.0]
    else:
        runs = warm_runs if run == "warm" else early_runs
        jlog, log = runs["jax"][2], runs["port"][2]
    assert set(log) == set(jlog)
    for k in log:
        assert tuple(log[k].shape) == tuple(jlog[k].shape), k


def test_early_stop_runs_one_chain_per_phase(scene, monkeypatch, tmp_path):
    """A multires + early-stop __call__ (``test_pipeline_options.py:449``):
    each phase runs its own checkpoint chain; the flags and losses equal
    those of JAX's fused __call__ fed the same subsampling draws."""
    config = _config(max_iterations=6, multires_factor=2,
                     multires_iterations=3, early_stop_delta=1.0,
                     early_stop_interval=1, **PLAIN)
    depth = scene["depth"]
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    monkeypatch.setattr(tpointset, "_uniform",
                        lambda n, g, d: torch.from_numpy(u))
    jpipe = JPipeline(dict(config))
    log_path = str(tmp_path / "log.pkl")
    want = jpipe(jnp.asarray(depth), jnp.asarray(depth > 0),
                 log_path=log_path)
    with open(log_path, "rb") as f:
        jlog = pickle.load(f)["log"]
    pipe = SDFPipeline(config, device="cpu")
    got = pipe(torch.from_numpy(depth), torch.from_numpy(depth > 0))
    assert pipe.last_plan == jpipe._cached_plan
    log = pipe.last_log
    assert log["active"].tolist() == [1.0, 1.0, 0.0, 1.0, 1.0, 0.0]
    np.testing.assert_array_equal(log["active"].numpy(), _np(jlog["active"]))
    np.testing.assert_allclose(log["loss"].numpy(), _np(jlog["loss"]),
                               rtol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)


@pytest.mark.parametrize("roi,ds_factor", [((32, 32), 1), (None, 2)])
def test_warm_with_roi_or_multires_raises_as_jax(scene, roi, ds_factor):
    match = "roi" if roi else "multires"
    jpipe = JPipeline(_config(fused_call=False, renderer_backend="pallas",
                              **WARM))
    with pytest.raises(ValueError, match=match):
        jpipe._refine(
            {k: jnp.asarray(v) for k, v in scene["start"].items()},
            jnp.asarray(scene["depth"])[None],
            jnp.asarray(scene["points"])[None],
            jnp.asarray(scene["mask"])[None], jnp.zeros((1, 3)),
            jnp.asarray([[0.0, 0.0, 0.0, 1.0]]), True, None, roi, ds_factor,
            2)
    pipe = SDFPipeline(_config(**WARM), device="cpu")
    with pytest.raises(ValueError, match=match):
        pipe._refine({k: torch.from_numpy(v)
                      for k, v in scene["start"].items()},
                     torch.from_numpy(scene["depth"]),
                     torch.from_numpy(scene["points"]),
                     torch.from_numpy(scene["mask"]), num_iterations=2,
                     roi=roi, ds_factor=ds_factor)


@pytest.mark.parametrize("key,value", [("temporal_refresh_interval", 0),
                                       ("early_stop_interval", 0)])
def test_option_intervals_must_be_positive(scene, key, value):
    overrides = dict(WARM, early_stop_delta=0.01, **{key: value})
    pipe = SDFPipeline(_config(**overrides), device="cpu")
    with pytest.raises(ValueError, match=key):
        pipe._refine({k: torch.from_numpy(v)
                      for k, v in scene["start"].items()},
                     torch.from_numpy(scene["depth"]),
                     torch.from_numpy(scene["points"]),
                     torch.from_numpy(scene["mask"]), num_iterations=2)


@pytest.mark.parametrize("name", ["mug_procedural_temporal",
                                  "mug_procedural_fast_adaptive"])
def test_new_presets_run_end_to_end_on_the_cpu(scene, name):
    """The two presets of this slice drive __call__ on the CPU (small
    camera and budget): finite estimates, a full log, active flags a
    prefix of ones."""
    config = preset(name)
    config.update(camera=dict(CAMERA), max_iterations=6, roi_margin=8)
    if name.endswith("adaptive"):
        config["early_stop_interval"] = 1
    pipe = SDFPipeline(config, device="cpu")
    depth = torch.from_numpy(scene["depth"])
    out = pipe(depth, depth > 0)
    for t in out:
        assert bool(torch.isfinite(t).all())
    active = pipe.last_log["active"].numpy()
    assert active.shape == (6,) and set(active.tolist()) <= {0.0, 1.0}
    if name.endswith("temporal"):
        assert pipe.last_plan == ((), None, None) and active.all()
