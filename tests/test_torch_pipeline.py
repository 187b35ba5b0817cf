"""Parity of the PyTorch port's estimation pipeline with the JAX package
(CPU), on the committed mug weights at a small 128x96 camera.

On the CPU the JAX pipeline renders with its XLA backend, which has no coarse
culling or adaptive relaxation; the tight trajectory test therefore turns
both off on the port, and a second test holds the port's default march
(both on) to a looser bar.
"""
import os
import subprocess
import sys

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
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import pipeline as tpipeline
from sdfest_torch.pipeline.pipeline import NoDepthError, SDFPipeline
from sdfest_torch.utils.presets import preset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
              pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
KEYS = ("position", "orientation", "scale", "latent")


def _config(**overrides):
    config = preset("mug_procedural")
    config["camera"] = dict(CAMERA)
    config["max_iterations"] = 3
    config.update(overrides)
    return config


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def scene():
    """JAX pipeline, an observation of a decoded mug at a ground-truth
    pose, its lifted tile-order cloud and a perturbed start state."""
    jpipe = JPipeline(_config(fused_call=False))
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                                 camera=JCamera(**CAMERA), threshold=0.005))
    assert (depth > 0).sum() > 150
    points, mask = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(depth), JCamera(**CAMERA), order="tile"
    )
    turn = Rotation.from_euler("XYZ", [4, -3, 5], degrees=True)
    start = {
        "position": (GT_POSITION + [0.01, -0.008, 0.015])[None].astype(
            np.float32),
        "orientation": (turn * Rotation.from_quat(GT_QUAT)).as_quat()[None]
        .astype(np.float32),
        "scale": np.asarray([0.11], np.float32),
        "latent": (latent + 0.1 * rng.normal(size=(1, 8))).astype(np.float32),
    }
    state, best, log = jpipe._refine(
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(depth)[None],
        points[None], mask[None], jnp.zeros((1, 3), jnp.float32),
        jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32), True, None, None, 1,
        5,
    )
    return dict(jpipe=jpipe, depth=depth, points=_np(points),
                mask=np.array(mask), start=start, jstate=state, jbest=best,
                jlog=log)


def _port_refine(scene, n, **overrides):
    pipe = SDFPipeline(_config(**overrides), device="cpu")
    return pipe._refine(
        {k: torch.from_numpy(v) for k, v in scene["start"].items()},
        torch.from_numpy(scene["depth"]), torch.from_numpy(scene["points"]),
        torch.from_numpy(scene["mask"]), num_iterations=n,
    )


def test_refine_trajectory_matches_jax(scene):
    state, best, log = _port_refine(scene, 5, coarse_culling=False,
                                    adaptive_relaxation=False)
    want = _np(scene["jlog"]["loss"])
    assert want[-1] < want[0]
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(log["inlier_ratio"].numpy(),
                               _np(scene["jlog"]["inlier_ratio"]), atol=1e-6)
    for k in KEYS:
        np.testing.assert_allclose(state[k].numpy(), _np(scene["jstate"][k]),
                                   atol=1e-4)
        np.testing.assert_allclose(best[k].numpy(), _np(scene["jbest"][k]),
                                   atol=1e-4)


def test_refine_with_culling_and_adaptive_march_tracks_jax(scene):
    _, _, log = _port_refine(scene, 3)  # the preset: both on
    want = _np(scene["jlog"]["loss"])[:3]
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=0.05)


@pytest.mark.parametrize("camera_pose", [None, "tilted"])
def test_call_matches_jax(scene, monkeypatch, camera_pose):
    """__call__ end to end, init included, fed JAX's subsampling draws; once
    with the identity camera and once with a camera pose in the world."""
    jpipe, depth = scene["jpipe"], scene["depth"]
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    monkeypatch.setattr(tpointset, "_uniform",
                        lambda n, g, d: torch.from_numpy(u))
    pipe = SDFPipeline(
        _config(coarse_culling=False, adaptive_relaxation=False),
        device="cpu",
    )
    cam_pos = np.zeros(3, np.float32)
    cam_quat = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
    if camera_pose == "tilted":
        cam_pos = np.asarray([0.1, -0.05, 0.2], np.float32)
        cam_quat = Rotation.from_euler("XYZ", [10, -20, 5], degrees=True
                                       ).as_quat().astype(np.float32)
    mask = depth > 0
    want_init = jpipe._nn_init(
        jnp.asarray(depth)[None], jnp.asarray(cam_pos)[None],
        jnp.asarray(cam_quat)[None], jax.random.PRNGKey(0),
    )
    got_init = pipe._nn_init(
        pipe._preprocess_depth(torch.from_numpy(depth),
                               torch.from_numpy(mask)),
        torch.from_numpy(cam_pos), torch.from_numpy(cam_quat), None,
    )
    for g, w in zip(got_init, want_init):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    kwargs = {} if camera_pose is None else dict(
        camera_positions=cam_pos, camera_orientations=cam_quat)
    want = jpipe(jnp.asarray(depth), jnp.asarray(mask), **{
        k: jnp.asarray(v) for k, v in kwargs.items()})
    got = pipe(torch.from_numpy(depth), torch.from_numpy(mask), **kwargs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    assert pipe.last_log["loss"].shape == (3,)


def test_call_takes_the_reference_parameters_in_order():
    """__call__'s parameters are the JAX package's, by name, order and
    default, except ``generator`` in place of ``key``."""
    import inspect

    want = list(inspect.signature(JPipeline.__call__).parameters.values())
    got = list(inspect.signature(SDFPipeline.__call__).parameters.values())
    assert [p.name for p in got] == [
        "generator" if p.name == "key" else p.name for p in want]
    assert [p.default for p in got] == [p.default for p in want]


def test_call_ignores_color_images_and_binds_positions_as_jax(scene):
    """A call with ``color_images`` equals the call without it, and a
    reference-style positional call (color_images, visualize,
    camera_positions, camera_orientations) binds as the keyword call."""
    depth = torch.from_numpy(scene["depth"])
    mask = depth > 0
    pipe = SDFPipeline(_config(), device="cpu")
    cam_pos = torch.tensor([0.1, -0.05, 0.2])
    cam_quat = torch.from_numpy(Rotation.from_euler(
        "XYZ", [10, -20, 5], degrees=True).as_quat().astype(np.float32))
    want = pipe(depth, mask, camera_positions=cam_pos,
                camera_orientations=cam_quat)
    color = torch.rand(*depth.shape, 3, generator=torch.Generator(
        ).manual_seed(0))
    for got in (pipe(depth, mask, color_images=color, camera_positions=cam_pos,
                     camera_orientations=cam_quat),
                pipe(depth, mask, color, False, cam_pos, cam_quat)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_losses_match_jax():
    from sdfest_tpu.pipeline import losses as jlosses
    from sdfest_torch.pipeline import losses as tlosses

    from conftest import make_sphere_sdf

    rng = np.random.default_rng(6)
    sdf = make_sphere_sdf(64)
    pts = (GT_POSITION + rng.normal(scale=0.1, size=(300, 3))).astype(
        np.float32)
    pmask = rng.uniform(size=300) < 0.7
    a = rng.uniform(0.3, 1.0, size=(48, 64)).astype(np.float32)
    b = (a * rng.uniform(0.95, 1.05, size=a.shape)).astype(np.float32)
    a[:10] = 0.0
    b[:, :5] = 0.0
    t = lambda x: torch.from_numpy(np.asarray(x))
    values = tlosses.pc_loss(t(pts), t(GT_POSITION), t(GT_QUAT), t(GT_HALF),
                             t(sdf), t(pmask))
    want = jlosses.pc_loss(pts, GT_POSITION, GT_QUAT, GT_HALF, sdf, pmask,
                           backend="xla")
    np.testing.assert_allclose(values.numpy(), _np(want), atol=1e-6)
    pairs = [
        (tlosses.masked_mean_abs(values, t(pmask)),
         jlosses.masked_mean_abs(want, pmask)),
        (tlosses.masked_pc_loss(t(pts), t(pmask), t(GT_POSITION), t(GT_QUAT),
                                t(GT_HALF), t(sdf)),
         jlosses.masked_pc_loss(pts, pmask, GT_POSITION, GT_QUAT, GT_HALF,
                                sdf)),
        (tlosses.depth_l1_loss(t(a), t(b)), jlosses.depth_l1_loss(a, b)),
        (tlosses.inlier_ratio(t(a), t(b)), jlosses.inlier_ratio(a, b)),
    ]
    for got, w in pairs:
        np.testing.assert_allclose(float(got), float(w), rtol=1e-6)


def test_empty_observation_raises():
    pipe = SDFPipeline(_config(), device="cpu")
    depth = torch.ones(96, 128)
    with pytest.raises(NoDepthError):
        pipe(depth, torch.zeros(96, 128))
    with pytest.raises(NoDepthError):  # everything beyond the far field
        pipe(depth * 3.0, torch.ones(96, 128))


def test_nonzero_nn_weight_raises():
    with pytest.raises(ValueError, match="nn_weight"):
        SDFPipeline(_config(nn_weight=1.0), device="cpu")


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with jax, flax,
    optax and the JAX package blocked, and without PyYAML, matplotlib and
    PIL (the card's machine has none of them)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'sdfest_tpu', 'yaml', 'msgpack',\n"
        "          'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import sdfest_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    sdfest_torch.__path__, 'sdfest_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


# ---------------------------------------------------------------------------
# slice 2: ROI crop + multires (the fast.yaml schedule)
# ---------------------------------------------------------------------------

FAST = dict(roi_size="auto", multires_factor=[4, 2],
            multires_iterations="auto")
SMALL_CAMERA = dict(width=256, height=192, fx=128, fy=128, cx=128, cy=96,
                    pixel_center=0.5)


@pytest.fixture(scope="module")
def planners():
    """A JAX and a port pipeline whose config and camera each planner test
    swaps in (the planners read nothing else)."""
    jpipe = JPipeline(preset("mug_procedural"))
    pipe = SDFPipeline(preset("mug_procedural"), device="cpu")

    def use(**overrides):
        config = preset("mug_procedural")
        config.update(overrides)
        for p, cam in ((jpipe, JCamera), (pipe, Camera)):
            p.config = config
            p.camera = cam(**config["camera"])
        return jpipe, pipe

    return use


PLAN_CASES = {
    # chip_smoke's four poses at 640x480 under fast.yaml
    "fast_poses": (FAST, [(90, 77)]),
    "fast_pose_4": (FAST, [(69, 72)]),
    "fast_no_view": (FAST, []),
    "explicit_roi": (dict(roi_size=[200, 240], multires_factor=[4, 2],
                          multires_iterations=[10, 10]), [(90, 77)]),
    "object_too_big": (FAST, [(400, 500)]),
    "coarse_fits_fine_not": (dict(FAST, roi_margin=60), [(120, 100)]),
    "single_level_auto": (dict(roi_size="auto", multires_factor=2,
                               multires_iterations="auto"), [(90, 77)]),
    "single_level_no_iterations": (dict(multires_factor=2), [(90, 77)]),
    "single_level_clamped": (dict(max_iterations=4, multires_factor=2,
                                  multires_iterations=99), [(30, 30)]),
    "non_dividing_level": (dict(max_iterations=8, multires_factor=[7, 2],
                                multires_iterations=[3, 2],
                                roi_size="auto"), [(90, 77)]),
    "roi_only": (dict(roi_size="auto"), [(90, 77)]),
    "neither": ({}, [(90, 77)]),
    "small_camera": (dict(FAST, camera=SMALL_CAMERA, max_iterations=5,
                          roi_margin=16), [(60, 50)]),
    # temporal coherence rules out ROI and multires: one full-frame phase
    # (on the JAX package's pallas backend, whose counterpart the port's
    # kernels are; its xla backend turns the warm path off)
    "temporal_fast": (dict(FAST, temporal_coherence=True,
                           renderer_backend="pallas"), [(90, 77)]),
    "temporal_single_level": (dict(roi_size="auto", multires_factor=2,
                                   multires_iterations="auto",
                                   temporal_coherence=True,
                                   renderer_backend="pallas"), [(90, 77)]),
    "temporal_xla_backend": (dict(FAST, temporal_coherence=True,
                                  renderer_backend="xla"), [(90, 77)]),
    "temporal_relaxed": (dict(FAST, temporal_coherence=True,
                              renderer_backend="pallas", relaxation=1.5),
                         [(90, 77)]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_planner_matches_jax(planners, case):
    overrides, spans = PLAN_CASES[case]
    jpipe, pipe = planners(**overrides)
    assert pipe._multires_for() == jpipe._multires_for()
    for factor in (1, 2, 4):
        assert pipe._roi_from_spans(spans, factor) == jpipe._roi_from_spans(
            spans, factor)
    assert pipe._plan_for(spans) == jpipe._plan_for(spans)


def test_temporal_gate_matches_jax(planners):
    """The warm path's gate equals the JAX package's on its pallas backend,
    and the temporal plan is one full-frame phase."""
    for overrides, on in ((dict(temporal_coherence=True,
                                renderer_backend="pallas"), True),
                          (dict(temporal_coherence=True,
                                renderer_backend="xla"), False),
                          (dict(temporal_coherence=True, coarse_culling=False,
                                renderer_backend="pallas"), False),
                          (dict(temporal_coherence=False,
                                renderer_backend="pallas"), False)):
        jpipe, pipe = planners(**FAST, **overrides)
        assert pipe._use_temporal_coherence() is on
        assert jpipe._use_temporal_coherence() is on
    _, pipe = planners(**FAST, temporal_coherence=True)  # "auto": the kernels
    assert pipe._plan_for([(90, 77)]) == ((), None, None)


def test_plan_of_chip_smoke_poses(planners):
    """fast.yaml at 640x480: ROI at every level, 20/20/10 iterations."""
    _, pipe = planners(**FAST)
    for spans in ([(90, 77)], [(91, 90)], [(92, 100)], [(69, 72)]):
        assert pipe._plan_for(spans) == (
            ((4, 20, (64, 80)), (2, 20, (128, 160))), (240, 320), 10)


@pytest.mark.parametrize("overrides,match", [
    (dict(multires_factor=[4, 2], multires_iterations=[3]), "must match"),
    (dict(multires_factor=[4, 2], multires_iterations=3), "matching list"),
    (dict(max_iterations=5, multires_factor=[4, 2],
          multires_iterations=[3, 2]), "full-resolution"),
])
def test_multires_config_errors_match_jax(planners, overrides, match):
    for p in planners(**overrides):
        with pytest.raises(ValueError, match=match):
            p._multires_for()


@pytest.mark.parametrize("roi", [(32, 48), (16, 16), (64, 96)])
def test_roi_offset_and_probe_match_jax(roi):
    from sdfest_tpu.pipeline.pipeline import _roi_offset_for as j_offset

    rng = np.random.default_rng(11)
    depth = np.zeros((4, 64, 96), np.float32)
    depth[0, 10:30, 20:50] = 0.5  # inside
    depth[1, 0:6, 80:96] = 0.5  # at a corner: the offset clamps
    depth[2] = rng.uniform(size=(64, 96)) < 0.02  # scattered pixels
    # depth[3] stays empty: offset (0, 0), span 0
    jpipe = JPipeline(_config(fused_call=False))
    want_valid, want_spans = jpipe._probe(jnp.asarray(depth),
                                          jnp.asarray(depth > 0))
    for v in range(4):
        got = tpipeline._roi_offset_for(torch.from_numpy(depth[v]), roi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_offset(jnp.asarray(depth[v]), roi)))
        probe = tpipeline._probe(torch.from_numpy(depth[v])).tolist()
        assert probe == [int(want_valid[v]), *map(int, want_spans[v])]


@pytest.mark.parametrize("roi,ds_factor", [((64, 64), 1), ((32, 32), 2),
                                           (None, 2), ((48, 64), 2)])
def test_refine_roi_and_stride_trajectory_matches_jax(scene, roi, ds_factor):
    """One refinement phase with an ROI and/or a stride, 5 iterations,
    against JAX's _refine (culling and adaptive off, as the XLA march)."""
    jpipe, depth = scene["jpipe"], scene["depth"]
    depth_c, jpoints, jmask = jpipe._multires_inputs(
        jnp.asarray(depth)[None], ds_factor)
    cam_pos = jnp.zeros((1, 3), jnp.float32)
    cam_quat = jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)
    start = {k: jnp.asarray(v) for k, v in scene["start"].items()}
    want_state, want_best, want_log = jpipe._refine(
        start, depth_c, jpoints, jmask, cam_pos, cam_quat, True, None, roi,
        ds_factor, 5)
    pipe = SDFPipeline(_config(coarse_culling=False,
                               adaptive_relaxation=False), device="cpu")
    tdepth = torch.from_numpy(np.array(depth_c[0], dtype=np.float32))
    points, mask = (None, None) if roi else pipe._lift(tdepth, ds_factor)
    state, best, log = pipe._refine(
        {k: torch.from_numpy(v) for k, v in scene["start"].items()}, tdepth,
        points, mask, num_iterations=5, roi=roi, ds_factor=ds_factor)
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


def test_fast_call_matches_jax(monkeypatch):
    """__call__ under the fast overlay (ROI at every level of the [4, 2]
    schedule, auto split 2/2/1) against JAX's fused __call__, init
    included, fed JAX's subsampling draws."""
    config = preset("mug_procedural_fast")
    config.update(camera=dict(SMALL_CAMERA), max_iterations=5, roi_margin=16,
                  coarse_culling=False, adaptive_relaxation=False)
    jpipe = JPipeline(dict(config))
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                                 camera=JCamera(**SMALL_CAMERA),
                                 threshold=0.005))
    mask = depth > 0
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    monkeypatch.setattr(tpointset, "_uniform",
                        lambda n, g, d: torch.from_numpy(u))
    want = jpipe(jnp.asarray(depth), jnp.asarray(mask))
    pipe = SDFPipeline(config, device="cpu")
    got = pipe(torch.from_numpy(depth), torch.from_numpy(mask))
    assert pipe.last_plan == jpipe._cached_plan
    levels, fine_roi, fine_iters = pipe.last_plan
    assert [lv[:2] for lv in levels] == [(4, 2), (2, 2)] and fine_iters == 1
    assert all(lv[2] is not None for lv in levels) and fine_roi is not None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    assert pipe.last_log["loss"].shape == (5,)


def test_fast_preset_matches_merged_yaml():
    """mug_procedural_fast is the JAX package's merge of the model config,
    default.yaml and the fast.yaml overlay."""
    from sdfest_tpu.utils import config as jconfig

    base = os.path.join(ROOT, "sdfest_tpu", "configs", "estimation")
    merged = {}
    for name in ("models/mug_procedural.yaml", "default.yaml", "fast.yaml"):
        merged = jconfig._deep_merge(
            merged, jconfig.load_config_from_file(os.path.join(base, name)))
    assert preset("mug_procedural_fast") == merged


@pytest.mark.parametrize("name,overlay,extra", [
    ("mug_procedural_fast_adaptive", "fast_adaptive.yaml", {}),
    ("mug_procedural_temporal", None, {"temporal_coherence": True}),
    ("mug_procedural_bf16", None, {"bf16_march": True}),
])
def test_temporal_and_adaptive_presets_match_merged_yaml(name, overlay,
                                                         extra):
    """mug_procedural_fast_adaptive is the JAX package's merge of the model
    config, default.yaml and fast_adaptive.yaml (which includes fast.yaml);
    mug_procedural_temporal and mug_procedural_bf16 are default.yaml with
    temporal_coherence or bf16_march on."""
    from sdfest_tpu.utils import config as jconfig

    base = os.path.join(ROOT, "sdfest_tpu", "configs", "estimation")
    merged = {}
    for f in ("models/mug_procedural.yaml", "default.yaml", overlay):
        if f is not None:
            merged = jconfig._deep_merge(
                merged, jconfig.load_config_from_file(os.path.join(base, f)))
    merged.update(extra)
    assert preset(name) == merged


# the JAX init's orientation error on chip_smoke's four poses (degrees)
REFERENCE_INIT_DEG = (31.6, 173.5, 171.3, 177.0)


@pytest.mark.parametrize("pose", range(4))
def test_init_start_is_the_reference_networks_at_full_size(monkeypatch,
                                                           pose):
    """At 640x480 on chip_smoke's poses, the port's init equals the JAX
    package's, and on poses 1-3 both start more than 150 deg from the true
    orientation: the committed init network gives that start, not the
    port."""
    from chip_smoke import GT_POSES

    jpipe = JPipeline(preset("mug_procedural"))
    pipe = SDFPipeline(preset("mug_procedural"), device="cpu")
    latent = 0.5 * torch.randn(1, 8, generator=torch.Generator(
        ).manual_seed(0))
    sdf = jpipe._decode(jnp.asarray(latent.numpy()))[0, 0]
    pos, half, quat = GT_POSES[pose]
    quat = np.asarray(quat, np.float32) / np.linalg.norm(quat)
    depth = _np(xla.render_depth(sdf, np.asarray(pos, np.float32), quat,
                                 np.float32(1.0 / half),
                                 camera=JCamera(**preset("mug_procedural")[
                                     "camera"]), threshold=0.005))
    assert (depth > 0).sum() > 3000
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    monkeypatch.setattr(tpointset, "_uniform",
                        lambda n, g, d: torch.from_numpy(u))
    cam_pos, cam_quat = np.zeros(3, np.float32), np.asarray(
        [0.0, 0.0, 0.0, 1.0], np.float32)
    want = jpipe._nn_init(jnp.asarray(depth)[None], jnp.asarray(cam_pos)[None],
                          jnp.asarray(cam_quat)[None], jax.random.PRNGKey(0))
    tdepth = torch.from_numpy(depth)
    got = pipe._nn_init(pipe._preprocess_depth(tdepth, tdepth > 0),
                        torch.from_numpy(cam_pos), torch.from_numpy(cam_quat),
                        None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-4)
    deg = np.degrees((Rotation.from_quat(quat.astype(np.float64)).inv()
                      * Rotation.from_quat(np.array(want[3])[0])).magnitude())
    assert abs(deg - REFERENCE_INIT_DEG[pose]) < 0.05, deg
    assert pose == 0 or deg > 150.0
