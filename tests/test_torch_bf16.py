"""Parity of the port's bf16-verified march (``bf16_march``) with the JAX
package (CPU).

The JAX march runs as the JAX package's own tests run it: the Pallas kernel
in interpret mode (``render_depth_pallas_fwd(..., bf16=True)``).  On the CPU
its one-pass sample (``Precision.DEFAULT``) is float32, so only the stepping
differs from the port's, whose bf16 sample rounds the 8 corners to bf16.
Depths are held to the JAX package's kernel bar (hit agreement > 0.995,
|ddepth| < 5e-3 where both hit); the corridor fields of the warm march to
being certified lower bounds, as ``tests/test_torch_warm.py`` holds them.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_tpu.render import pallas_kernel, xla
from sdfest_tpu.render.pallas_kernel import render_depth_pallas_fwd
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import sample_sdf
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.render import api, kernels, plain
from sdfest_torch.utils.presets import preset

from conftest import make_box_sdf, make_sphere_sdf

CAM_ARGS = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
                pixel_center=0.5)
CAM, JCAM = Camera(**CAM_ARGS), JCamera(**CAM_ARGS)
H, W = 48, 64
THR = 0.005
POSITION = np.asarray([0.03, -0.01, -0.55], np.float32)
QUAT = Rotation.from_euler("XYZ", [15, 30, -10], degrees=True).as_quat(
).astype(np.float32)
SCALE = np.float32(0.18)
NAMES = ["sphere", "box", "mug"]


def _np(x):
    return np.array(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def sdfs():
    """The sphere and box SDFs and a mug decoded by the port's decoder from
    a seeded latent (the committed weights)."""
    pipe = SDFPipeline(preset("mug_procedural"), device="cpu")
    latent = 0.5 * torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 8)).astype(np.float32))
    with torch.no_grad():
        mug = pipe._decode(latent)[0, 0].numpy()
    return {"sphere": make_sphere_sdf(64, radius=0.5),
            "box": make_box_sdf(64), "mug": mug}


def _pose(position=POSITION, quat=QUAT, scale=SCALE):
    return kernels.pose_params(_t(position), _t(quat), _t(1.0 / scale))


def _dirs():
    return api.ray_set(CAM, "cpu").march.reshape(-1, 3)


def _depth_bar(got, want):
    hit_g, hit_w = got > 0, want > 0
    assert hit_w.sum() > 50
    assert (hit_g == hit_w).mean() > 0.995
    both = hit_g & hit_w
    assert np.abs(got[both] - want[both]).max() < 5e-3


@pytest.mark.parametrize("name", NAMES)
def test_max_table_matches_jax(sdfs, name):
    """The max-|value| table is the second block of the JAX package's
    coarse_min_table, bit for bit, and bounds |sample| in every cell."""
    sdf = sdfs[name]
    nc = plain.NC
    want = np.asarray(pallas_kernel.coarse_min_table(jnp.asarray(sdf)))
    want = want[:, nc:].T.reshape(nc, nc, nc)  # Ttc[j*nc + k, nc + i]
    table = plain.coarse_max_table(_t(sdf))
    np.testing.assert_array_equal(table.numpy(), _np(want))
    pair = plain.coarse_pair_table(_t(sdf))
    assert torch.equal(pair[..., 0], plain.coarse_min_table(_t(sdf)))
    assert torch.equal(pair[..., 1], table)
    pts = _t(np.random.default_rng(1).uniform(-1.0, 1.0, size=(5000, 3)))
    assert bool((sample_sdf(_t(sdf), pts).abs()
                 <= plain.coarse_lookup(table, pts)).all())


@pytest.mark.parametrize("name", NAMES)
def test_bf16_sample_error_is_bounded(sdfs, name):
    """On 100k points in [-1, 1]^3 the bf16 sample (corners rounded, weights
    and sums in float32) is within BF16_ERR * amax of the fp32 sample, and
    within the derived 2^-8 * amax (+ float32 rounding)."""
    sdf = _t(sdfs[name])
    pts = _t(np.random.default_rng(2).uniform(-1.0, 1.0, size=(100_000, 3)))
    err = (sample_sdf(plain.bf16_corners(sdf), pts)
           - sample_sdf(sdf, pts)).abs()
    amax = plain.coarse_lookup(plain.coarse_max_table(sdf), pts)
    assert bool((err <= plain.BF16_ERR * amax).all())
    assert float((err / amax).max()) <= 2.0 ** -8 + 2e-6
    assert float(err.max()) > 0.0  # the rounding is real


@pytest.mark.parametrize("relaxation", [1.0, 1.5])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_march_matches_jax(sdfs, name, relaxation):
    """The bf16 culling march (relaxation 1) and relaxed culling march (1.5)
    against the JAX package's bf16 branches, through render_depth."""
    sdf = sdfs[name]
    got = api.render_depth(sdf, POSITION, QUAT, 1.0 / SCALE, camera=CAM,
                           threshold=THR, relaxation=relaxation, bf16=True,
                           device="cpu").numpy()
    want = render_depth_pallas_fwd(
        jnp.asarray(sdf), POSITION, QUAT, np.float32(1.0 / SCALE), JCAM,
        threshold=THR, max_steps=500, relaxation=relaxation, culling=True,
        bf16=True, interpret=True)
    _depth_bar(got, _np(want))
    steps = {}
    plain.march_plain(_t(sdf), _dirs(), _pose(), THR, 500, True, True,
                      steps=steps, relaxation=relaxation, bf16=True)
    assert steps["fast"] > 0 and steps["fine"] > 0  # both kinds of step ran


def _field(sdf, pose, dirs_o, tt):
    p = (pose[9:12] + tt[:, None] * dirs_o) * pose[12]
    return sample_sdf(sdf, p) * pose[13]


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_bf16_warm_march_matches_jax(sdfs, name, warm_start):
    """The bf16 warm/aux march, cold and with the inputs of a warm step (the
    rays that hit in a cold render start 0.01 before their hit, a band of
    missing rays is skipped), against render_depth_pallas_fwd(aux=True,
    bf16=True); its corridor values are lower bounds of the field."""
    sdf = _t(sdfs[name])
    dirs = _dirs()
    pose = _pose()
    t_init, skip = -torch.ones(H, W), torch.zeros(H, W)
    if warm_start:
        cold = kernels.march_warm(sdf, dirs.reshape(H, W, 3), pose, t_init,
                                  skip, THR, 500)
        hit = cold[0] > 0
        t_init = torch.where(hit, cold[1] - 0.01, t_init)
        skip = ((~hit) & (torch.arange(W) < W // 4)).float()
        assert int(hit.sum()) > 50 and int(skip.sum()) > 50
    depth, t, v0, min_dip, v_last, t_last = kernels.march_warm(
        sdf, dirs.reshape(H, W, 3), pose, t_init, skip, THR, 500, bf16=True)
    want, _ = render_depth_pallas_fwd(
        jnp.asarray(sdfs[name]), POSITION, QUAT, np.float32(1.0 / SCALE),
        JCAM, threshold=THR, max_steps=500, bf16=True, aux=True,
        t_init=jnp.asarray(t_init.numpy()), skip=jnp.asarray(skip.numpy()))
    _depth_bar(depth.numpy(), _np(want))
    hit, t_min, t_max = plain.ray_interval(dirs, pose)
    ti = t_init.reshape(-1)
    t0 = torch.where(ti >= 0, torch.maximum(t_min, ti), t_min)
    m = hit & (t0 < t_max) & (skip.reshape(-1) <= 0)
    assert int(m.sum()) > 200
    dirs_o = plain.object_rays(dirs, pose)
    v0, v_last, t_last = (x.reshape(-1) for x in (v0, v_last, t_last))
    assert bool((v0[m] <= _field(sdf, pose, dirs_o, t0)[m] + 1e-6).all())
    assert bool((v_last[m] <= _field(sdf, pose, dirs_o, t_last)[m]
                 + 1e-6).all())
    assert bool((t.reshape(-1)[~m] == t0[~m]).all())


@pytest.mark.parametrize("name", NAMES)
def test_bf16_dispatch_matches_jax(sdfs, name):
    """As the JAX package dispatches: bf16 turns adaptive over-relaxation
    off (bf16 + adaptive equals bf16 without it, bit for bit), and without
    culling bf16 has no effect (the fp32 plain and relaxed marches, bit for
    bit)."""
    sdf, dirs, pose = _t(sdfs[name]), _dirs(), _pose()
    run = lambda *a, **k: plain.march_plain(sdf, dirs, pose, THR, 500, *a,
                                            **k)
    assert torch.equal(run(True, True, bf16=True), run(True, False, bf16=True))
    for relaxation in (1.0, 1.5):
        assert torch.equal(
            run(False, False, relaxation=relaxation, bf16=True),
            run(False, False, relaxation=relaxation))
    # the wrapper takes the same dispatch
    got = kernels.march(sdf, dirs, pose, THR, 500, False, True, bf16=True)
    assert torch.equal(got, run(False, True))


# ---------------------------------------------------------------------------
# the pipeline with bf16_march
# ---------------------------------------------------------------------------

PIPE_CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
                   pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)


def _pipe_config(**overrides):
    config = preset("mug_procedural")
    config["camera"] = dict(PIPE_CAMERA)
    config["max_iterations"] = 3
    config.update(overrides)
    return config


@pytest.fixture(scope="module")
def scene():
    """An observation of a decoded mug, its cloud, a perturbed start state
    and JAX's _refine from it (3 iterations, its XLA march)."""
    jpipe = JPipeline(_pipe_config(fused_call=False))
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    sdf = jpipe._decode(jnp.asarray(latent))[0, 0]
    depth = _np(xla.render_depth(sdf, GT_POSITION, GT_QUAT, 10.0,
                                 camera=JCamera(**PIPE_CAMERA),
                                 threshold=THR))
    points, mask = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(depth), JCamera(**PIPE_CAMERA), order="tile")
    turn = Rotation.from_euler("XYZ", [4, -3, 5], degrees=True)
    start = {
        "position": (GT_POSITION + [0.01, -0.008, 0.015])[None].astype(
            np.float32),
        "orientation": (turn * Rotation.from_quat(GT_QUAT)).as_quat()[None]
        .astype(np.float32),
        "scale": np.asarray([0.11], np.float32),
        "latent": (latent + 0.1 * rng.normal(size=(1, 8))).astype(np.float32),
    }
    _, _, jlog = jpipe._refine(
        {k: jnp.asarray(v) for k, v in start.items()},
        jnp.asarray(depth)[None], points[None], mask[None],
        jnp.zeros((1, 3), jnp.float32),
        jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32), True, None, None,
        1, 3)
    return dict(depth=depth, points=_np(points), mask=np.array(mask),
                start=start, jlog=jlog)


def test_refine_with_bf16_march_tracks_jax(scene, monkeypatch):
    """_refine under bf16_march (culling and adaptive on, as the preset)
    tracks JAX's _refine within rtol 0.05 over 3 iterations, the bar of
    test_refine_with_culling_and_adaptive_march_tracks_jax, and every
    render goes through the bf16 march."""
    flags = []
    march_plain = kernels.march_plain

    def spy(*args, **kwargs):
        flags.append(kwargs.get("bf16"))
        return march_plain(*args, **kwargs)

    monkeypatch.setattr(kernels, "march_plain", spy)
    pipe = SDFPipeline(_pipe_config(bf16_march=True), device="cpu")
    _, _, log = pipe._refine(
        {k: torch.from_numpy(v) for k, v in scene["start"].items()},
        torch.from_numpy(scene["depth"]), torch.from_numpy(scene["points"]),
        torch.from_numpy(scene["mask"]), num_iterations=3)
    want = _np(scene["jlog"]["loss"])
    np.testing.assert_allclose(log["loss"].numpy(), want, rtol=0.05)
    assert flags == [True] * 3


def test_bf16_preset_runs_end_to_end_on_the_cpu(scene):
    """SDFPipeline(preset("mug_procedural_bf16")).__call__ at a small
    camera: finite estimate, lower loss at the end."""
    config = preset("mug_procedural_bf16")
    config.update(camera=dict(PIPE_CAMERA), max_iterations=4)
    pipe = SDFPipeline(config, device="cpu")
    depth = torch.from_numpy(scene["depth"])
    out = pipe(depth, depth > 0)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    loss = pipe.last_log["loss"]
    assert loss.shape == (4,) and float(loss[-1]) < float(loss[0])
