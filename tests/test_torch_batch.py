"""Parity of the port's ``SDFPipeline.refine_batch`` (a batch of hypotheses
refined together, one launch of each kernel per view and iteration) with the
JAX package's (CPU), on the committed mug weights at a small 128x96
camera, and with the port's own single-hypothesis ``_refine``.

As in ``test_torch_pipeline.py``, the tight trajectory tests turn culling
and adaptive relaxation off on the port (the JAX package's CPU backend
marches without them).  The temporal test runs JAX's warm path on its
pallas backend in interpret mode, at the 64x48 camera and the bar of
``test_torch_temporal.py``.  JAX runs in float64 here
(``tests/conftest.py``); its outputs are cast to float32.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import xla
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.utils.presets import preset

CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
              pixel_center=0.5)
SMALL_CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
                    pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
KEYS = ("position", "orientation", "scale", "latent")
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
WARM = dict(temporal_coherence=True, temporal_refresh_interval=2)
TURNS = ([4, -3, 5], [-5, 2, 3], [2, 4, -4])


def _config(camera=CAMERA, **overrides):
    config = preset("mug_procedural")
    config["camera"] = dict(camera)
    config["max_iterations"] = 3
    config.update(overrides)
    return config


def _np(x):
    return np.array(x, dtype=np.float32)


def _scene(camera, n_hyp):
    """An observation of a decoded mug, its tile-order cloud as the shared
    view inputs ``(V, ...)`` with V = 1, and ``n_hyp`` perturbed starts in
    ``refine_batch``'s shapes."""
    jpipe = JPipeline(_config(camera, fused_call=False))
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                                 camera=JCamera(**camera), threshold=0.005))
    assert (depth > 0).sum() > 150
    points, mask = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(depth), JCamera(**camera), order="tile")
    gt = Rotation.from_quat(GT_QUAT)
    states = {
        "position": (GT_POSITION + rng.normal(scale=0.01, size=(n_hyp, 3)))
        [:, None].astype(np.float32),
        "orientation": np.stack([
            (Rotation.from_euler("XYZ", t, degrees=True) * gt).as_quat()
            for t in TURNS[:n_hyp]])[:, None].astype(np.float32),
        "scale": np.asarray([0.11, 0.095, 0.105][:n_hyp], np.float32)[:, None],
        "latent": (latent + 0.1 * rng.normal(size=(n_hyp, 1, 8))).astype(
            np.float32),
    }
    views = (depth[None], _np(points)[None], np.array(mask)[None],
             np.zeros((1, 3), np.float32),
             np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32))
    return dict(states=states, views=views, camera=camera)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs: its many small CPU ops
    gain nothing from more, and beside the suite's other workers the
    threads' spin-waits cost more than the ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    return _scene(CAMERA, 3)


def _jax_batch(scene, overrides, **kwargs):
    jpipe = JPipeline(_config(scene["camera"], fused_call=False, **overrides))
    kwargs = {k: v(jpipe) if callable(v) else v for k, v in kwargs.items()}
    return jpipe.refine_batch(
        {k: jnp.asarray(v) for k, v in scene["states"].items()},
        *(jnp.asarray(v) for v in scene["views"]), **kwargs)


def _port_batch(scene, overrides, **kwargs):
    pipe = SDFPipeline(_config(scene["camera"], **overrides), device="cpu")
    kwargs = {k: v(pipe) if callable(v) else v for k, v in kwargs.items()}
    return pipe.refine_batch(
        {k: torch.from_numpy(v) for k, v in scene["states"].items()},
        *(torch.from_numpy(v) for v in scene["views"]), **kwargs)


def _assert_matches_jax(port, want):
    """loss rtol 1e-4, inlier ratio atol 1e-6, final and best states atol
    1e-4 (the bar of ``test_refine_trajectory_matches_jax``), every entry
    in the JAX package's shape."""
    (final, best, log), (jfinal, jbest, jlog) = port, want
    assert set(log) == set(jlog)
    for k in log:
        assert tuple(log[k].shape) == np.shape(jlog[k]), k
    np.testing.assert_allclose(log["loss"].numpy(), _np(jlog["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(log["inlier_ratio"].numpy(),
                               _np(jlog["inlier_ratio"]), atol=1e-6)
    np.testing.assert_allclose(best["inlier_ratio"].numpy(),
                               _np(jbest["inlier_ratio"]), atol=1e-6)
    for k in KEYS:
        assert tuple(final[k].shape) == np.shape(jfinal[k]), k
        np.testing.assert_allclose(final[k].numpy(), _np(jfinal[k]),
                                   atol=1e-4, err_msg=k)
        np.testing.assert_allclose(best[k].numpy(), _np(jbest[k]),
                                   atol=1e-4, err_msg=k)


def test_refine_batch_matches_jax(scene):
    overrides = dict(PLAIN, max_iterations=5)
    port = _port_batch(scene, overrides)
    want = _jax_batch(scene, overrides)
    assert port[2]["loss"].shape == (3, 5)
    assert bool((port[2]["loss"][:, -1] < port[2]["loss"][:, 0]).all())
    _assert_matches_jax(port, want)


def test_refine_batch_multires_roi_matches_jax(scene):
    """A [4, 2] schedule with an ROI at every level: the same plan as the
    JAX package's (levels, coarse and fine ROIs), the same trajectories."""
    overrides = dict(PLAIN, max_iterations=5, multires_factor=[4, 2],
                     multires_iterations=[2, 1], roi_size="auto",
                     roi_margin=8)
    depth = scene["views"][0]
    pipe = SDFPipeline(_config(**overrides), device="cpu")
    jpipe = JPipeline(_config(fused_call=False, **overrides))
    assert pipe._multires_for() == jpipe._multires_for() == [(4, 2), (2, 1)]
    for f in (1, 2, 4):
        strided = depth[:, ::f, ::f]
        assert pipe._roi_for(torch.from_numpy(strided), f) == (
            jpipe._roi_for(jnp.asarray(strided), f)) is not None, f
    kwargs = dict(multires=lambda p: p._multires_for(),
                  roi=lambda p: p._roi_for(depth))
    port = _port_batch(scene, overrides, **kwargs)
    assert port[2]["loss"].shape == (3, 5)
    _assert_matches_jax(port, _jax_batch(scene, overrides, **kwargs))


def test_adaptive_chunked_equals_unchunked(scene):
    """delta ~ 0 never stops: 7 iterations in chunks 3 + 3 + 1, chained
    through Adam's state (its step count included) and the best tracker,
    equal the unchunked batch (the bar of
    ``tests/test_pipeline_options.py:510-540``)."""
    overrides = dict(max_iterations=7, early_stop_delta=1e-12,
                     early_stop_interval=3)
    final_a, best_a, log_a = _port_batch(scene, overrides, adaptive=True)
    final_b, best_b, log_b = _port_batch(scene, overrides, adaptive=False)
    assert log_a["loss"].shape == log_b["loss"].shape == (3, 7)
    for k in KEYS:
        np.testing.assert_allclose(final_a[k].numpy(), final_b[k].numpy(),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(best_a["inlier_ratio"].numpy(),
                               best_b["inlier_ratio"].numpy(), atol=1e-5)
    np.testing.assert_allclose(log_a["loss"].numpy(), log_b["loss"].numpy(),
                               atol=1e-5)


def _executed(losses, interval, delta, stop):
    """The iterations an adaptive run executes, from the unchunked log
    ``losses (N, T)``: it stops after the first chunk whose chunk-final
    losses ``stop(~improved)`` on the previous chunk's, each hypothesis
    improved when it fell by ``delta * max(|previous|, 1e-8)``."""
    ends = losses[:, interval - 1::interval]
    for c in range(1, ends.shape[1]):
        ref = ends[:, c - 1]
        improved = ref - ends[:, c] >= delta * np.maximum(np.abs(ref), 1e-8)
        if stop(~improved):
            return (c + 1) * interval
    return losses.shape[1]


def test_adaptive_stops_where_jax_stops(scene):
    """A demanding delta stops where JAX's adaptive refine_batch stops:
    chunks of 2 of a 12-iteration budget, delta 0.165.  On this scene's
    losses the run stops after 6 iterations when every hypothesis has
    plateaued (the reference's predicate), and would stop after 4 if one
    plateaued hypothesis were enough (the second chunk improves one
    hypothesis by 0.154 and the others by 0.176 and 0.186); the executed
    prefix equals the port's non-adaptive log and JAX's adaptive one."""
    interval, delta = 2, 0.165
    overrides = dict(PLAIN, max_iterations=12, early_stop_delta=delta,
                     early_stop_interval=interval)
    _, _, log_full = _port_batch(scene, overrides, adaptive=False)
    full = log_full["loss"].numpy()
    expected = _executed(full, interval, delta, np.all)
    assert expected < 12
    assert _executed(full, interval, delta, np.any) < expected
    final, _, log = _port_batch(scene, overrides, adaptive=True)
    _, _, jlog = _jax_batch(scene, overrides, adaptive=True)
    executed = log["loss"].shape[1]
    assert executed == np.shape(jlog["loss"])[1] == expected
    assert log["active"].shape == (3, executed)
    assert bool(torch.isfinite(final["position"]).all())
    np.testing.assert_allclose(log["loss"].numpy(), full[:, :executed],
                               atol=1e-5)
    np.testing.assert_allclose(log["loss"].numpy(), _np(jlog["loss"]),
                               rtol=1e-4)


def test_temporal_refine_batch_matches_jax():
    """Every hypothesis keeps its own warm state: the port's batched warm
    refinement against JAX's (pallas, interpret mode, under vmap), at the
    bar of ``test_warm_refine_tracks_jax_and_cold``: loss rtol 0.05,
    position and scale atol 2e-3."""
    small = _scene(SMALL_CAMERA, 2)
    final, _, log = _port_batch(small, WARM)
    jfinal, _, jlog = _jax_batch(small, dict(WARM,
                                             renderer_backend="pallas"))
    assert log["loss"].shape == np.shape(jlog["loss"]) == (2, 3)
    np.testing.assert_allclose(log["loss"].numpy(), _np(jlog["loss"]),
                               rtol=0.05)
    for k in ("position", "scale"):
        np.testing.assert_allclose(final[k].numpy(), _np(jfinal[k]),
                                   atol=2e-3, err_msg=k)


@pytest.mark.parametrize("options", ["default", "temporal"])
def test_each_hypothesis_follows_its_own_refine(scene, options):
    """Hypothesis b of the batch ends where the port's own single _refine
    from start b ends (atol 1e-6), its log and best too: the default march
    (culling + adaptive relaxation) and the warm march."""
    overrides = dict(max_iterations=4, **(WARM if options == "temporal"
                                          else {}))
    final, best, log = _port_batch(scene, overrides)
    pipe = SDFPipeline(_config(**overrides), device="cpu")
    depth, points, mask = (torch.from_numpy(v) for v in scene["views"][:3])
    for b in range(3):
        start = {k: torch.from_numpy(v[b]) for k, v in scene["states"].items()}
        state, best_b, log_b = pipe._refine(start, depth, points, mask)
        for k in KEYS:
            np.testing.assert_allclose(final[k][b].numpy(), state[k].numpy(),
                                       atol=1e-6, err_msg=k)
            np.testing.assert_allclose(best[k][b].numpy(),
                                       best_b[k].numpy(), atol=1e-6)
        np.testing.assert_allclose(log["loss"][b].numpy(),
                                   log_b["loss"].numpy(), atol=1e-6)
        assert float(best["inlier_ratio"][b]) == float(
            best_b["inlier_ratio"])


def test_refine_chunks_chain_through_opt_state_and_best(scene):
    """The single-hypothesis _refine in chunks of 2 + 2 iterations, the
    second carrying the first's Adam state (step count included) and best
    tracker (``return_full``), ends where 4 iterations at once end; early
    stop is off with ``allow_early_stop=False`` even when configured."""
    pipe = SDFPipeline(_config(early_stop_delta=1.0, early_stop_interval=1),
                       device="cpu")
    views = [torch.from_numpy(v) for v in scene["views"][:3]]
    start = {k: torch.from_numpy(v[0]) for k, v in scene["states"].items()}
    whole, best_w, log_w = pipe._refine(start, *views, num_iterations=4,
                                        allow_early_stop=False)
    assert bool((log_w["active"] == 1).all())
    state, opt_state, best, log = pipe._refine(
        start, *views, num_iterations=2, allow_early_stop=False,
        return_full=True)
    assert opt_state["count"] == 2
    state, opt_state, best, log_b = pipe._refine(
        state, *views, num_iterations=2, allow_early_stop=False,
        opt_state=opt_state, best=best, return_full=True)
    assert opt_state["count"] == 4
    for k in KEYS:
        np.testing.assert_allclose(state[k].numpy(), whole[k].numpy(),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(best[k].numpy(), best_w[k].numpy(),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(torch.cat([log["loss"], log_b["loss"]]),
                               log_w["loss"], atol=1e-6)
    assert float(best["inlier_ratio"]) == float(best_w["inlier_ratio"])


def test_refine_batch_option_errors_match_jax(scene):
    """Adaptive with temporal coherence, and a schedule that leaves no
    full-resolution iteration, raise as in the JAX package (before any
    input is read)."""
    pipe = SDFPipeline(_config(early_stop_delta=0.1, **WARM), device="cpu")
    with pytest.raises(ValueError, match="temporal_coherence"):
        pipe.refine_batch({k: torch.from_numpy(v) for k, v in
                           scene["states"].items()},
                          *(torch.from_numpy(v) for v in scene["views"]),
                          adaptive=True)
    pipe = SDFPipeline(_config(max_iterations=4), device="cpu")
    with pytest.raises(ValueError, match="full-resolution iteration"):
        pipe.refine_batch(None, None, None, None, None, None,
                          multires=(2, 4))
