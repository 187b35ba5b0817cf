"""Parity of the port's warm/aux corridor march, relaxed march and
temporal-coherence render step with the JAX package (CPU).

The JAX march branches run as the JAX package's own tests run them: the
Pallas kernel in interpret mode (``render_depth_pallas_fwd``) and the XLA
plain march.  The port runs the CUDA kernels' plain twins.  The depth is
held to the JAX package's kernel bar (hit agreement > 0.995, |ddepth| <
5e-3 where both hit).  The corridor fields (``t``, ``v0``, ``min_dip``,
``v_last``, ``t_last``) of a ray that marched are not the TPU's to the bit
(the TPU decided coarse or fine steps per 16x16 tile, the port per ray), so
they are held to what the skip rule needs: certified lower bounds.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.render import api as japi
from sdfest_tpu.render import warm as jwarm
from sdfest_tpu.render import xla
from sdfest_tpu.render.pallas_kernel import render_depth_pallas_fwd
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import sample_sdf
from sdfest_torch.render import api, kernels, plain, warm
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
# an Adam-sized pose change: positions ~1e-3, the quaternion ~1e-2
STEP_POSITION = POSITION + np.asarray([1e-3, -6e-4, 8e-4], np.float32)
STEP_QUAT = (Rotation.from_rotvec([0.012, -0.008, 0.01])
             * Rotation.from_quat(QUAT)).as_quat().astype(np.float32)
STEP_SCALE = np.float32(0.1805)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def sdfs():
    """The sphere and box SDFs and a mug decoded by the port's decoder from
    a seeded latent (the committed weights)."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline

    pipe = SDFPipeline(preset("mug_procedural"), device="cpu")
    latent = 0.5 * torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 8)).astype(np.float32))
    with torch.no_grad():
        mug = pipe._decode(latent)[0, 0].numpy()
    return {"sphere": make_sphere_sdf(64, radius=0.5),
            "box": make_box_sdf(64), "mug": mug}


def _pose(position, quat, scale):
    return kernels.pose_params(_t(position), _t(quat), _t(1.0 / scale))


def _warm_state(sdf, position=POSITION, quat=QUAT, scale=SCALE):
    """The port's warm state after one full-refresh render at a pose."""
    views = {k: v[0, 0]
             for k, v in warm.init_warm_views(1, H, W, 1, "cpu").items()}
    _, state = warm.warm_render_step(
        _t(sdf), _t(position), _t(quat), _t(scale), views, torch.zeros(()),
        True, CAM, THR, device="cpu")
    return state


def _step_inputs(sdf):
    """``(t_init, skip, motion)`` of one real warm step: the state of a full
    render at POSITION/QUAT/SCALE, then the move to the STEP pose."""
    state = _warm_state(sdf)
    prev = {"position": _t(POSITION), "orientation": _t(QUAT),
            "scale": _t(SCALE), "sdf": _t(sdf)}
    motion = warm.motion_bound(_t(STEP_POSITION), _t(STEP_QUAT),
                               _t(STEP_SCALE), _t(sdf), prev)
    rays = api.ray_set(CAM, "cpu").march
    t_init, skip, _ = warm.warm_inputs(
        state, rays, _pose(STEP_POSITION, STEP_QUAT, STEP_SCALE), motion,
        False, THR)
    return t_init, skip, motion


def _jax_warm(sdf, position, quat, scale, t_init, skip):
    depth, aux = render_depth_pallas_fwd(
        jnp.asarray(sdf), position, quat, np.float32(1.0 / scale), JCAM,
        threshold=THR, max_steps=500, t_init=jnp.asarray(t_init.numpy()),
        skip=jnp.asarray(skip.numpy()), aux=True)
    return _np(depth), {k: _np(v) for k, v in aux.items()}


def _depth_bar(got, want):
    hit_g, hit_w = got > 0, want > 0
    assert hit_w.sum() > 50
    assert (hit_g == hit_w).mean() > 0.995
    both = hit_g & hit_w
    assert np.abs(got[both] - want[both]).max() < 5e-3


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("name", ["sphere", "box", "mug"])
def test_warm_march_matches_jax(sdfs, name, warm_start):
    """Cold (t_init -1, skip 0) and with the inputs of one real warm step,
    at the pose of that step."""
    sdf = sdfs[name]
    if warm_start:
        t_init, skip, _ = _step_inputs(sdf)
        pose = (STEP_POSITION, STEP_QUAT, STEP_SCALE)
        assert int((t_init >= 0).sum()) > 50 and int(skip.sum()) > 0
    else:
        t_init, skip = -torch.ones(H, W), torch.zeros(H, W)
        pose = (POSITION, QUAT, SCALE)
    want, jaux = _jax_warm(sdf, *pose, t_init, skip)
    got, aux = api.render_depth_warm(
        _t(sdf), _t(pose[0]), _t(pose[1]), _t(1.0 / pose[2]), t_init, skip,
        CAM, threshold=THR, device="cpu")
    got, aux = got.numpy(), {k: v.numpy() for k, v in aux.items()}
    _depth_bar(got, want)
    hit, _, _ = plain.ray_interval(api.ray_set(CAM, "cpu").march.reshape(
        -1, 3), _pose(*pose))
    hit = hit.reshape(H, W).numpy()
    for k in ("t0", "t_min", "t_max"):
        np.testing.assert_allclose(aux[k][hit], jaux[k][hit], atol=1e-6)
    # rays that do not march: the zeros of both packages exactly, t at t0
    still = ~(hit & (aux["t0"] < aux["t_max"]) & (skip.numpy() <= 0))
    assert still.sum() > 100
    for k in ("v0", "min_dip", "v_last"):
        assert (aux[k][still] == 0).all() and (jaux[k][still] == 0).all()
    assert (got[still] == 0).all() and (want[still] == 0).all()
    for k in ("t", "t_last"):
        np.testing.assert_array_equal(aux[k][still], aux["t0"][still])
        np.testing.assert_allclose(aux[k][still & hit], jaux[k][still & hit],
                                   atol=1e-6)


def test_all_rays_skipped_gives_zeros_at_t0(sdfs):
    """Every ray skipped (after ``test_pallas.py:221-238``): depth 0 and the
    corridor outputs at their start, in both packages."""
    sdf = sdfs["sphere"]
    t_init, skip = -torch.ones(H, W), torch.ones(H, W)
    depth, aux = api.render_depth_warm(
        _t(sdf), _t(POSITION), _t(QUAT), _t(1.0 / SCALE), t_init, skip, CAM,
        threshold=THR, device="cpu")
    assert float(depth.abs().sum()) == 0.0
    assert torch.equal(aux["t"], aux["t0"])
    assert torch.equal(aux["t_last"], aux["t0"])
    for k in ("v0", "min_dip", "v_last"):
        assert float(aux[k].abs().sum()) == 0.0
    jdepth, jaux = _jax_warm(sdf, POSITION, QUAT, SCALE, t_init, skip)
    assert float(np.abs(jdepth).sum()) == 0.0
    np.testing.assert_allclose(jaux["t"], jaux["t0"])


@pytest.mark.parametrize("warm_start", [False, True])
@pytest.mark.parametrize("name", ["sphere", "mug"])
def test_corridor_bounds_the_field(sdfs, name, warm_start):
    """On every marched ray of the twin, v0 and v_last lower-bound the
    field at t0 and t_last (+1e-6).  On the sphere, a 1-Lipschitz field,
    min_dip also lower-bounds it between t0 and t_last; the decoded mug's
    grid has slopes up to ~1.7, so there the dip bound (which assumes a
    1-Lipschitz field, as the JAX package's skip rule does) does not
    hold."""
    sdf = _t(sdfs[name])
    if warm_start:
        t_init, skip, _ = _step_inputs(sdfs[name])
        pose = _pose(STEP_POSITION, STEP_QUAT, STEP_SCALE)
    else:
        t_init, skip = -torch.ones(H, W), torch.zeros(H, W)
        pose = _pose(POSITION, QUAT, SCALE)
    dirs = api.ray_set(CAM, "cpu").march.reshape(-1, 3)
    depth, t, v0, min_dip, v_last, t_last = plain.march_warm_plain(
        sdf, dirs, pose, t_init.reshape(-1), skip.reshape(-1), THR, 500)
    hit, t_min, t_max = plain.ray_interval(dirs, pose)
    t0 = torch.where(t_init.reshape(-1) >= 0,
                     torch.maximum(t_min, t_init.reshape(-1)), t_min)
    marched = hit & (t0 < t_max) & (skip.reshape(-1) <= 0)
    assert int(marched.sum()) > 200
    dirs_o = plain.object_rays(dirs, pose)

    def field(tt):
        p = (pose[9:12] + tt[:, None] * dirs_o) * pose[12]
        return sample_sdf(sdf, p) * pose[13]

    m = marched
    assert bool((v0[m] <= field(t0)[m] + 1e-6).all())
    assert bool((v_last[m] <= field(t_last)[m] + 1e-6).all())
    several = m & (min_dip < 1e8)  # rays with two or more samples
    assert int(several.sum()) > 100
    if name != "sphere":
        return
    for frac in np.linspace(0.0, 1.0, 17):
        tt = t0 + float(frac) * (t_last - t0)
        assert bool((min_dip[several] <= field(tt)[several] + 1e-6).all())


@pytest.mark.parametrize("name", ["box", "mug"])
def test_warm_step_is_sound_at_an_adam_sized_step(sdfs, name):
    """The warm render at the step pose against a cold render there, in the
    port and in the JAX package; the rays the port skips stay misses.

    A warm start does not see a surface that sweeps sideways in front of
    the previous hit (the JAX package's ``render/warm.py`` says so; the
    periodic full refresh caps it).  On the mug one rim pixel does that at
    this step, 0.09 in front, in both packages: the pixels off the bar must
    be the same in both and fewer than 1%."""
    sdf = sdfs[name]
    t_init, skip, motion = _step_inputs(sdf)
    step = (STEP_POSITION, STEP_QUAT, STEP_SCALE)
    got, _ = api.render_depth_warm(
        _t(sdf), _t(step[0]), _t(step[1]), _t(1.0 / step[2]), t_init, skip,
        CAM, threshold=THR, device="cpu")
    cold, _ = api.render_depth_warm(
        _t(sdf), _t(step[0]), _t(step[1]), _t(1.0 / step[2]),
        -torch.ones(H, W), torch.zeros(H, W), CAM, threshold=THR,
        device="cpu")
    got, cold = got.numpy(), cold.numpy()
    skipped = skip.numpy() > 0
    assert skipped.sum() > 50
    assert (cold[skipped] > 0).mean() < 0.005
    # the JAX package's own warm step, from its own full render
    jsdf = jnp.asarray(sdf)
    views = {k: v[0] for k, v in jwarm.init_warm_views(1, H, W).items()}
    _, views = jwarm.warm_render_step(
        jsdf, POSITION, QUAT, SCALE, views, jnp.zeros(()), True, JCAM, THR)
    jmotion = jwarm.motion_bound(STEP_POSITION, STEP_QUAT, STEP_SCALE, jsdf, {
        "position": POSITION, "orientation": QUAT, "scale": SCALE,
        "sdf": jsdf})
    np.testing.assert_allclose(float(motion), float(jmotion), rtol=1e-5)
    jgot, _ = jwarm.warm_render_step(jsdf, *step, views, jmotion, False,
                                     JCAM, THR)
    jcold = render_depth_pallas_fwd(jsdf, *step[:2], np.float32(1 / step[2]),
                                    JCAM, threshold=THR, max_steps=500,
                                    t_init=jnp.full((H, W), -1.0), aux=True)
    jgot, jcold = _np(jgot), _np(jcold[0])
    stale = []
    for warm_depth, cold_depth in ((got, cold), (jgot, jcold)):
        hit_w, hit_c = warm_depth > 0, cold_depth > 0
        assert hit_c.sum() > 100 and (hit_w == hit_c).mean() > 0.995
        both = hit_w & hit_c
        stale.append(both & (np.abs(warm_depth - cold_depth) >= 5e-3))
        assert stale[-1].sum() < 0.01 * both.sum()
    np.testing.assert_array_equal(stale[0], stale[1])
    assert (name == "mug") == bool(stale[0].any())


@pytest.mark.parametrize("culling", [True, False])
@pytest.mark.parametrize("name", ["sphere", "box", "mug"])
def test_relaxed_march_matches_jax(sdfs, name, culling):
    """relaxation 1.5 against the JAX pallas relaxed branch and the XLA
    plain march."""
    sdf = sdfs[name]
    got = api.render_depth(sdf, POSITION, QUAT, 1.0 / SCALE, camera=CAM,
                           threshold=THR, culling=culling, relaxation=1.5,
                           device="cpu").numpy()
    relaxed = render_depth_pallas_fwd(
        jnp.asarray(sdf), POSITION, QUAT, np.float32(1.0 / SCALE), JCAM,
        threshold=THR, max_steps=500, relaxation=1.5, culling=culling)
    plain_xla = xla.render_depth(sdf, POSITION, QUAT, np.float32(1 / SCALE),
                                 camera=JCAM, threshold=THR)
    for want in (relaxed, plain_xla):
        _depth_bar(got, _np(want))


def test_relaxed_march_ignores_adaptive(sdfs):
    sdf = _t(sdfs["box"])
    dirs = api.ray_set(CAM, "cpu").march.reshape(-1, 3)
    pose = _pose(POSITION, QUAT, SCALE)
    a, b = (plain.march_plain(sdf, dirs, pose, THR, 500, True, adaptive,
                              relaxation=1.5) for adaptive in (True, False))
    assert torch.equal(a, b)


def _grad_close(got, want, tol):
    got, want = np.asarray(got), _np(want)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (
        np.abs(got - want).max(), np.abs(want).max())


def test_render_depth_warm_gradients_match_jax(sdfs):
    """Gradients of a weighted depth through render_depth_warm (the
    surrogate VJP) against JAX's render_depth_warm on the same warm
    inputs.  The scene is one where both depths agree: the box at a
    threshold of 1e-5, where both marches end within 1.2e-7 of each other
    (at 5e-3 they end up to 1.1e-3 apart, a third of a grid cell, which
    moves the SDF gradient's corner weights by up to 1.7e-2)."""
    sdf = sdfs["box"]
    thr = 1e-5
    t_init, skip, _ = _step_inputs(sdf)
    step = (sdf, STEP_POSITION, STEP_QUAT, np.float32(1.0 / STEP_SCALE))
    w = np.random.default_rng(3).normal(size=(H, W)).astype(np.float32)
    ti, sk = jnp.asarray(t_init.numpy()), jnp.asarray(skip.numpy())

    def jloss(s, p, q, i):
        depth, _ = japi.render_depth_warm(s, p, q, i, ti, sk, camera=JCAM,
                                          threshold=thr)
        return jnp.sum(depth * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, step))
    jdepth, _ = japi.render_depth_warm(*map(jnp.asarray, step), ti, sk,
                                       camera=JCAM, threshold=thr)
    leaves = [_t(a).requires_grad_() for a in step]
    depth, aux = api.render_depth_warm(*leaves, t_init, skip, CAM,
                                       threshold=thr, device="cpu")
    assert not any(v.requires_grad for v in aux.values())
    assert int((_np(jdepth) > 0).sum()) > 50
    np.testing.assert_array_equal(depth.detach().numpy() > 0,
                                  _np(jdepth) > 0)
    np.testing.assert_allclose(depth.detach().numpy(), _np(jdepth),
                               atol=1e-6)
    (depth * _t(w)).sum().backward()
    for leaf, g, tol in zip(leaves, want, (1e-3, 1e-4, 1e-4, 1e-4)):
        _grad_close(leaf.grad.numpy(), g, tol)


# ---------------------------------------------------------------------------
# hypotheses: the warm march and the warm bookkeeping with a batch dim
# ---------------------------------------------------------------------------


def _hyp_inputs(sdfs):
    """Three hypotheses (mug, sphere, and the mug behind the camera): their
    grids, poses, and per-hypothesis warm inputs of a real warm step (the
    first two) and a cold start (the third)."""
    grids = torch.stack([_t(sdfs["mug"]), _t(sdfs["sphere"]),
                         _t(sdfs["mug"])])
    behind = POSITION * np.asarray([1, 1, -1], np.float32)
    poses = torch.stack([_pose(STEP_POSITION, STEP_QUAT, STEP_SCALE),
                         _pose(STEP_POSITION, STEP_QUAT, STEP_SCALE),
                         _pose(behind, QUAT, SCALE)])
    steps = [_step_inputs(sdfs["mug"]), _step_inputs(sdfs["sphere"])]
    t_init = torch.stack([s[0] for s in steps] + [torch.full((H, W), -1.0)])
    skip = torch.stack([s[1] for s in steps] + [torch.zeros(H, W)])
    return grids, poses, t_init, skip


@pytest.mark.parametrize("bf16", [False, True])
def test_batched_warm_march_equals_each_hypothesis_alone(sdfs, bf16):
    grids, poses, t_init, skip = _hyp_inputs(sdfs)
    rays = api.ray_set(CAM, "cpu").march
    assert int(skip[0].sum()) > 100 and int((t_init[0] >= 0).sum()) > 50
    got = kernels.march_warm(grids, rays, poses, t_init, skip, THR, 500,
                             bf16=bf16)
    for b in range(3):
        want = kernels.march_warm(grids[b], rays, poses[b], t_init[b],
                                  skip[b], THR, 500, bf16=bf16)
        for g, w in zip(got, want):
            assert g.shape == (3, H, W) and torch.equal(g[b], w)
    assert not bool(got[0][2].any())


def test_batched_warm_step_keeps_each_hypothesis_state(sdfs):
    """motion_bound, warm_inputs and warm_render_step of a batch equal each
    hypothesis alone: one bound and one warm state per hypothesis."""
    grids, _, _, _ = _hyp_inputs(sdfs)
    positions = _t([STEP_POSITION, STEP_POSITION + 0.01, STEP_POSITION])
    quats = _t([STEP_QUAT, QUAT, STEP_QUAT])
    scales = _t([STEP_SCALE, SCALE, 0.17])
    states = [_warm_state(sdfs[k]) for k in ("mug", "sphere", "mug")]
    batch_state = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    prev = {"position": _t([POSITION] * 3), "orientation": _t([QUAT] * 3),
            "scale": _t([SCALE] * 3), "sdf": grids * 0.99}
    motion = warm.motion_bound(positions, quats, scales, grids, prev)
    assert motion.shape == (3,)
    depth, new = warm.warm_render_step(grids, positions, quats, scales,
                                       batch_state, motion, False, CAM, THR,
                                       device="cpu")
    for b in range(3):
        prev_b = {k: v[b] for k, v in prev.items()}
        m_b = warm.motion_bound(positions[b], quats[b], scales[b], grids[b],
                                prev_b)
        assert torch.equal(motion[b], m_b)
        d_b, new_b = warm.warm_render_step(grids[b], positions[b], quats[b],
                                           scales[b], states[b], m_b, False,
                                           CAM, THR, device="cpu")
        assert torch.equal(depth[b], d_b)
        for k in warm.WARM_VIEW_KEYS:
            assert torch.equal(new[k][b], new_b[k]), k
