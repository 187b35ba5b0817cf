"""Parity of the port's multi-view estimation with the JAX package (CPU):
several views with camera poses, ``init_view: best``, prior orientation
distributions, the point constraint and ``reuse_plan``, on the committed mug
weights at a small 128x96 camera.

The JAX pipeline renders with its XLA backend on the CPU (no coarse culling,
no adaptive relaxation), so the port turns both off where the bar is tight,
as ``test_torch_pipeline.py`` does; the temporal case runs JAX's pallas
backend in interpret mode, as ``test_torch_temporal.py`` does.  The port's
subsampling draws are replaced by JAX's (one ``jax.random.uniform`` per view,
from ``jax.random.split(key, V)``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline import losses as jlosses
from sdfest_tpu.pipeline import pipeline as jpipeline
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import xla
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.pipeline import losses as tlosses
from sdfest_torch.pipeline import pipeline as tpipeline
from sdfest_torch.pipeline.pipeline import NoDepthError, SDFPipeline
from sdfest_torch.utils.presets import preset

CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
              pixel_center=0.5)
SMALL_CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
                    pixel_center=0.5)
FAST_CAMERA = dict(width=256, height=192, fx=128, fy=128, cx=128, cy=96,
                   pixel_center=0.5)
KEYS = ("position", "orientation", "scale", "latent")
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
# the mug's world pose and its pose in each view's camera frame
WORLD_POSITION = np.asarray([0.1, 0.05, -0.3])
WORLD_ROT = Rotation.from_euler("XYZ", [5, 10, 15], degrees=True)
HALF = 0.1
VIEW_POSES = [([0.02, -0.01, -0.5], [20, 35, 10]),
              ([-0.02, 0.01, -0.55], [-10, 60, 5]),
              ([0.0, 0.02, -0.45], [40, -20, 30])]
N_GRID = 576  # cells of the init_v3 head's SO(3) grid


def _config(camera=CAMERA, **overrides):
    config = preset("mug_procedural")
    config["camera"] = dict(camera)
    config["max_iterations"] = 3
    config.update(overrides)
    return config


def _np(x):
    return np.array(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(_np(x))


def _views(sdf, camera, n):
    """Depth ``(n, H, W)`` of the mug seen by n cameras, and the cameras'
    world poses ``(n, 3)``/``(n, 4)``: each view sees the mug at its
    VIEW_POSES pose in its own frame."""
    depths, positions, quats = [], [], []
    for pos_c, euler in VIEW_POSES[:n]:
        rot_c = Rotation.from_euler("XYZ", euler, degrees=True)
        rot_cam = WORLD_ROT * rot_c.inv()
        positions.append(WORLD_POSITION - rot_cam.apply(pos_c))
        quats.append(rot_cam.as_quat())
        depths.append(_np(xla.render_depth(
            sdf, _np(pos_c), _np(rot_c.as_quat()), np.float32(1 / HALF),
            camera=JCamera(**camera), threshold=0.005)))
    for d in depths:
        assert (d > 0).sum() > 100
    return np.stack(depths), _np(positions), _np(quats)


@pytest.fixture(scope="module")
def mug():
    jpipe = JPipeline(_config())
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    return dict(latent=latent, sdf=sdf, views=_views(sdf, CAMERA, 3))


def _inject_draws(monkeypatch, n_views):
    """The port's draws become JAX's: view v takes uniform(split(key0)[v])."""
    keys = jax.random.split(jax.random.PRNGKey(0), n_views)
    draws = [torch.from_numpy(np.array(jax.random.uniform(k, (2500,))))
             for k in keys]
    it = iter(draws)
    monkeypatch.setattr(tpointset, "_uniform", lambda n, g, d: next(it))


def _priors(n_views, peaked_view=None):
    """A random ``(V, C)`` prior (one view sharply peaked on cell 100 when
    asked) and a random ``(C,)`` training prior."""
    rng = np.random.default_rng(5)
    prior = rng.dirichlet(np.ones(N_GRID), size=n_views)
    if peaked_view is not None:
        prior[peaked_view] = 1e-9
        prior[peaked_view, 100] = 1.0
    train = rng.dirichlet(np.ones(N_GRID))
    return _np(prior), _np(train)


# ---------------------------------------------------------------------------
# losses and the posterior
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_point_constraint_loss_matches_jax(seed):
    """Value and gradient w.r.t. an unnormalized quaternion, atol 1e-6."""
    rng = np.random.default_rng(seed)
    q = _np(rng.normal(size=4) * rng.uniform(0.5, 1.5))
    source, target = _np(rng.normal(size=3)), _np(rng.normal(size=3))
    want, want_grad = jax.value_and_grad(jlosses.point_constraint_loss)(
        jnp.asarray(q), jnp.asarray(source), jnp.asarray(target))
    tq = _t(q).requires_grad_()
    got = tlosses.point_constraint_loss(tq, _t(source), _t(target))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), _np(want_grad), atol=1e-6)


@pytest.mark.parametrize("case", ["no_prior", "prior", "prior_and_train"])
def test_adjust_categorical_posterior_matches_jax(case):
    rng = np.random.default_rng(7)
    posterior = _np(rng.dirichlet(np.ones(N_GRID), size=3))
    prior, train = _priors(3, peaked_view=1)
    prior = None if case == "no_prior" else prior
    train = train if case == "prior_and_train" else None
    want = jpipeline._adjust_categorical_posterior(
        jnp.asarray(posterior), None if prior is None else jnp.asarray(prior),
        None if train is None else jnp.asarray(train))
    got = tpipeline._adjust_categorical_posterior(
        _t(posterior), None if prior is None else _t(prior),
        None if train is None else _t(train))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)


# ---------------------------------------------------------------------------
# init, probe and refinement over views
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_prior", [False, True])
@pytest.mark.parametrize("init_view", ["first", "best"])
def test_nn_init_over_views_matches_jax(mug, monkeypatch, init_view,
                                        with_prior):
    """_nn_init over 3 views against JAX's, fed its draws, atol 1e-4.  With
    the prior, view 2's prior is peaked, so "best" takes view 2."""
    depth, cam_pos, cam_quat = mug["views"]
    prior, train = _priors(3, peaked_view=2) if with_prior else (None, None)
    jpipe = JPipeline(_config(init_view=init_view))
    want = jpipe._nn_init(
        jnp.asarray(depth), jnp.asarray(cam_pos), jnp.asarray(cam_quat),
        jax.random.PRNGKey(0), None if prior is None else jnp.asarray(prior),
        None if train is None else jnp.asarray(train))
    _inject_draws(monkeypatch, 3)
    pipe = SDFPipeline(_config(init_view=init_view), device="cpu")
    got = pipe._nn_init(
        _t(depth), _t(cam_pos), _t(cam_quat), None,
        None if prior is None else _t(prior),
        None if train is None else _t(train))
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)


def test_probe_over_views_matches_jax(mug):
    depth = mug["views"][0].copy()
    depth[1] = 0.0  # an empty view
    valid, spans = JPipeline(_config())._probe(jnp.asarray(depth),
                                               jnp.asarray(depth > 0))
    got = tpipeline._probe(_t(depth)).tolist()
    assert got == [[int(v), *map(int, s)] for v, s in zip(valid, spans)]


def _clouds(depth, camera):
    clouds = [jpointset.depth_to_pointcloud_dense(
        jnp.asarray(d), JCamera(**camera), order="tile") for d in depth]
    return (_np(np.stack([c[0] for c in clouds])),
            np.stack([np.array(c[1]) for c in clouds]))


def _start(latent, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    turn = Rotation.from_euler("XYZ", [4, -3, 5], degrees=True)
    return {
        "position": _np((WORLD_POSITION + [0.01, -0.008, 0.015])[None]),
        "orientation": _np((turn * WORLD_ROT).as_quat()[None]),
        "scale": np.asarray([0.11], np.float32),
        "latent": _np(latent + 0.1 * rng.normal(size=(1, 8))),
    }


CONSTRAINT = (_np([0.0, 0.0, 0.1]), _np(WORLD_ROT.apply([0.0, 0.0, 0.1])),
              0.5)


@pytest.mark.parametrize("constraint", [False, True])
def test_refine_over_two_views_matches_jax(mug, constraint):
    """_refine with V = 2 (culling and adaptive off), 5 iterations, without
    and with a point constraint: loss rtol 1e-4, state atol 1e-4."""
    depth, cam_pos, cam_quat = (x[:2] for x in mug["views"])
    points, masks = _clouds(depth, CAMERA)
    start = _start(mug["latent"])
    pc = CONSTRAINT if constraint else None
    jpipe = JPipeline(_config(fused_call=False))
    want_state, want_best, want_log = jpipe._refine(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(depth),
        jnp.asarray(points), jnp.asarray(masks), jnp.asarray(cam_pos),
        jnp.asarray(cam_quat), True,
        None if pc is None else tuple(jnp.asarray(x) for x in pc), None, 1, 5)
    pipe = SDFPipeline(_config(**PLAIN), device="cpu")
    state, best, log = pipe._refine(
        {k: torch.from_numpy(v) for k, v in start.items()}, _t(depth),
        _t(points), torch.from_numpy(masks), _t(cam_pos), _t(cam_quat),
        num_iterations=5, point_constraint=pc)
    want = _np(want_log["loss"])
    assert want[-1] < want[0]
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(log["inlier_ratio"].numpy(),
                               _np(want_log["inlier_ratio"]), atol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(state[k].numpy(), _np(want_state[k]),
                                   atol=1e-4)
        np.testing.assert_allclose(best[k].numpy(), _np(want_best[k]),
                                   atol=1e-4)


def test_point_constraint_changes_the_trajectory(mug):
    """The constraint enters the loss: with a heavy weight the loss differs
    from the unconstrained one by the weighted constraint at iteration 0."""
    depth, cam_pos, cam_quat = (x[:1] for x in mug["views"])
    points, masks = _clouds(depth, CAMERA)
    start = _start(mug["latent"])
    pipe = SDFPipeline(_config(**PLAIN), device="cpu")
    logs = []
    for pc in (None, (CONSTRAINT[0], CONSTRAINT[1], 10.0)):
        _, _, log = pipe._refine(
            {k: torch.from_numpy(v) for k, v in start.items()}, _t(depth),
            _t(points), torch.from_numpy(masks), _t(cam_pos), _t(cam_quat),
            num_iterations=1, point_constraint=pc)
        logs.append(float(log["loss"][0]))
    extra = 10.0 * float(tlosses.point_constraint_loss(
        _t(start["orientation"][0]), _t(CONSTRAINT[0]), _t(CONSTRAINT[1])))
    assert extra > 1e-3
    np.testing.assert_allclose(logs[1] - logs[0], extra, rtol=1e-4)


# ---------------------------------------------------------------------------
# __call__ over views
# ---------------------------------------------------------------------------


def test_call_over_two_views_matches_jax(mug, monkeypatch):
    """__call__ with V = 2, init_view best and priors, against JAX's fused
    __call__, init included, fed its draws; atol 1e-4."""
    depth, cam_pos, cam_quat = (x[:2] for x in mug["views"])
    prior, train = _priors(2, peaked_view=1)
    masks = depth > 0
    jpipe = JPipeline(_config(init_view="best"))
    want = jpipe(jnp.asarray(depth), jnp.asarray(masks),
                 camera_positions=jnp.asarray(cam_pos),
                 camera_orientations=jnp.asarray(cam_quat),
                 prior_orientation_distribution=jnp.asarray(prior),
                 training_orientation_distribution=jnp.asarray(train))
    _inject_draws(monkeypatch, 2)
    pipe = SDFPipeline(_config(init_view="best", **PLAIN), device="cpu")
    got = pipe(_t(depth), torch.from_numpy(masks), camera_positions=cam_pos,
               camera_orientations=cam_quat,
               prior_orientation_distribution=prior,
               training_orientation_distribution=train)
    assert pipe.last_plan == jpipe._cached_plan
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    assert pipe.last_log["loss"].shape == (3,)


def test_fast_call_over_two_views_matches_jax(mug, monkeypatch):
    """The fast overlay (an ROI per view at every level of the [4, 2]
    schedule) with V = 2 against JAX's fused __call__; atol 1e-4."""
    config = preset("mug_procedural_fast")
    config.update(camera=dict(FAST_CAMERA), max_iterations=5, roi_margin=16,
                  **PLAIN)
    depth, cam_pos, cam_quat = _views(mug["sdf"], FAST_CAMERA, 2)
    masks = depth > 0
    jpipe = JPipeline(dict(config))
    want = jpipe(jnp.asarray(depth), jnp.asarray(masks),
                 camera_positions=jnp.asarray(cam_pos),
                 camera_orientations=jnp.asarray(cam_quat))
    _inject_draws(monkeypatch, 2)
    pipe = SDFPipeline(config, device="cpu")
    got = pipe(_t(depth), torch.from_numpy(masks), camera_positions=cam_pos,
               camera_orientations=cam_quat)
    levels, fine_roi, _ = pipe.last_plan
    assert pipe.last_plan == jpipe._cached_plan
    assert all(lv[2] is not None for lv in levels) and fine_roi is not None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)


def test_temporal_refine_over_two_views_tracks_jax(mug):
    """Warm refinement (temporal coherence, a warm state per view, one
    motion bound) with V = 2 within rtol 0.05 of JAX's on its pallas
    backend, 6 iterations with a refresh every 3."""
    depth, cam_pos, cam_quat = _views(mug["sdf"], SMALL_CAMERA, 2)
    points, masks = _clouds(depth, SMALL_CAMERA)
    start = _start(mug["latent"])
    warm = dict(temporal_coherence=True, temporal_refresh_interval=3)
    jpipe = JPipeline(_config(SMALL_CAMERA, fused_call=False,
                              renderer_backend="pallas", **warm))
    _, _, want_log = jpipe._refine(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(depth),
        jnp.asarray(points), jnp.asarray(masks), jnp.asarray(cam_pos),
        jnp.asarray(cam_quat), True, None, None, 1, 6)
    pipe = SDFPipeline(_config(SMALL_CAMERA, **warm), device="cpu")
    _, _, log = pipe._refine(
        {k: torch.from_numpy(v) for k, v in start.items()}, _t(depth),
        _t(points), torch.from_numpy(masks), _t(cam_pos), _t(cam_quat),
        num_iterations=6)
    want = _np(want_log["loss"])
    assert want[-1] < want[0]
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=0.05)


@pytest.mark.parametrize("init_view,empty,raises", [
    ("first", 0, True), ("first", 1, False),
    ("best", 1, True), ("best", None, False),
])
def test_no_depth_error_rules_match_jax(mug, init_view, empty, raises):
    """"first" needs view 0 observed, "best" every view (JAX's rule,
    checked against JAX where it raises)."""
    depth, cam_pos, cam_quat = (x[:2] for x in mug["views"])
    masks = depth > 0
    if empty is not None:
        masks[empty] = False
    pipe = SDFPipeline(_config(init_view=init_view, max_iterations=1),
                       device="cpu")
    call = lambda: pipe(_t(depth), torch.from_numpy(masks),
                        camera_positions=cam_pos, camera_orientations=cam_quat)
    if raises:
        with pytest.raises(NoDepthError):
            call()
        jpipe = JPipeline(_config(init_view=init_view, max_iterations=1))
        with pytest.raises(jpipeline.NoDepthError):
            jpipe(jnp.asarray(depth), jnp.asarray(masks),
                  camera_positions=jnp.asarray(cam_pos),
                  camera_orientations=jnp.asarray(cam_quat))
    else:
        out = call()
        assert all(bool(torch.isfinite(x).all()) for x in out)


def test_reuse_plan_skips_the_probe(mug, monkeypatch):
    """With reuse_plan the second call runs no probe and keeps the plan, so
    an empty observation no longer raises up front; without it every call
    probes."""
    probes = []
    probe = tpipeline._probe
    monkeypatch.setattr(tpipeline, "_probe",
                        lambda d: probes.append(1) or probe(d))
    depth = _t(mug["views"][0][0])
    fast = dict(roi_size="auto", multires_factor=[2],
                multires_iterations=[1], max_iterations=2, roi_margin=8)
    pipe = SDFPipeline(_config(reuse_plan=True, **fast), device="cpu")
    pipe(depth, depth > 0)
    plan = pipe.last_plan
    assert len(probes) == 1 and plan[0] and plan[1] is not None
    pipe(depth, depth > 0)
    assert len(probes) == 1 and pipe.last_plan == plan
    out = pipe(depth, torch.zeros_like(depth))  # no NoDepthError up front
    assert len(probes) == 1 and all(bool(torch.isfinite(x).all())
                                    for x in out)
    pipe = SDFPipeline(_config(**fast), device="cpu")
    for _ in range(2):
        pipe(depth, depth > 0)
    assert len(probes) == 3
    with pytest.raises(NoDepthError):
        pipe(depth, torch.zeros_like(depth))


@pytest.mark.parametrize("case", ["prior_with_quaternion_head",
                                  "unknown_init_view",
                                  "best_with_quaternion_head"])
def test_invalid_init_options_raise_as_jax(mug, case):
    config = _config()
    if case != "unknown_init_view":
        config["init"]["head"]["orientation_repr"] = "quaternion"
        del config["init"]["model"]  # the committed head is discretized
    prior = None
    if case == "prior_with_quaternion_head":
        prior, error = np.full(N_GRID, 1.0 / N_GRID, np.float32), ValueError
    else:
        config["init_view"] = ("foo" if case == "unknown_init_view"
                               else "best")
        error = NotImplementedError
    depth = mug["views"][0][0]
    with pytest.raises(error):
        JPipeline(dict(config))(
            jnp.asarray(depth), jnp.asarray(depth > 0),
            prior_orientation_distribution=None if prior is None
            else jnp.asarray(prior))
    pipe = SDFPipeline(config, device="cpu")
    with pytest.raises(error):
        pipe(_t(depth), _t(depth > 0), prior_orientation_distribution=prior)
