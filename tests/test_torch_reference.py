"""The port's numpy golden renderer (``sdfest_torch/render/reference.py``)
against the JAX package's, the port's CPU march against the golden renderer
(the second oracle of the march, beside ``render/plain.py``), and
``nn_loss`` against the JAX package's (CPU).

The scenes are ``test_renderer.py``'s: an analytic sphere and box SDF at
64^3, posed at its ``POSITION``/``QUAT``/``INV_SCALE`` before its 64x48
camera.  Tolerances are stated where they are used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline.losses import nn_loss
from sdfest_torch.render import reference, render_depth
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline.losses import nn_loss as jnn_loss
from sdfest_tpu.render import reference as jreference

from conftest import make_box_sdf, make_sphere_sdf
from test_renderer import INV_SCALE, POSITION, QUAT

CAMERA = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
              pixel_center=0.5)
SDFS = {"sphere": make_sphere_sdf, "box": make_box_sdf}


@pytest.fixture(scope="module", params=sorted(SDFS))
def sdf(request):
    return SDFS[request.param](64)


def test_pixel_directions_equal_jax():
    got = reference.pixel_directions(Camera(**CAMERA))
    want = jreference.pixel_directions(JCamera(**CAMERA))
    assert got.dtype == np.float64 and got.shape == (48, 64, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_obb_intersect_and_trilinear_equal_jax(sdf):
    """The slab test's hits and interval, and trilinear samples at the
    march's first points and at points outside the volume (the clamped
    base extrapolates), within 1e-12 (float64)."""
    dirs = reference.pixel_directions(Camera(**CAMERA))
    position = POSITION.astype(np.float64)
    rot = reference._quat_to_matrix(QUAT.astype(np.float64))
    np.testing.assert_array_equal(
        rot, jreference._quat_to_matrix(QUAT.astype(np.float64)))
    scale = 1.0 / float(INV_SCALE)
    got = reference._obb_intersect(dirs, position, rot, scale)
    want = jreference._obb_intersect(dirs, position, rot, scale)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].sum() > 100
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g[got[0]], w[got[0]], rtol=0, atol=1e-12)
    rng = np.random.default_rng(0)
    points = np.concatenate([
        (rot.T @ (-position) + got[1][got[0]][:, None] * (dirs[got[0]] @ rot))
        * float(INV_SCALE),
        rng.uniform(-1.3, 1.3, size=(500, 3))])
    np.testing.assert_allclose(reference.trilinear(sdf, points),
                               jreference.trilinear(sdf, points), rtol=0,
                               atol=1e-12)


def test_render_depth_np_equals_jax(sdf):
    args = (sdf, POSITION, QUAT, float(INV_SCALE))
    got = reference.render_depth_np(*args, Camera(**CAMERA), threshold=0.005)
    want = jreference.render_depth_np(*args, JCamera(**CAMERA),
                                      threshold=0.005)
    assert (got > 0).sum() > 50
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# the bars of the port's march against the golden renderer: the plain march
# (no culling, no adaptive relaxation: the JAX package's XLA march) by
# test_forward_matches_numpy_golden's (hit agreement > 0.995, median
# |ddepth| < 2e-4 and max < 0.01 where both hit); the culling march and the
# adaptive over-relaxed one by ROADMAP's march tolerance (hit agreement >
# 0.995, |ddepth| < 5e-3: two termination bands of threshold * t, since
# they step differently and stop elsewhere in the band)
GOLDEN_BARS = {"plain": (False, False, 2e-4, 0.01),
               "culling": (True, False, 5e-3, 5e-3),
               "culling_adaptive": (True, True, 5e-3, 5e-3)}


@pytest.mark.parametrize("march", sorted(GOLDEN_BARS))
def test_port_march_matches_golden(sdf, march):
    """The port's CPU march (the kernels' plain twin) against the golden
    renderer, by GOLDEN_BARS."""
    culling, adaptive, median_tol, max_tol = GOLDEN_BARS[march]
    golden = reference.render_depth_np(sdf, POSITION, QUAT, float(INV_SCALE),
                                       Camera(**CAMERA), threshold=0.005)
    depth = render_depth(torch.from_numpy(sdf), torch.from_numpy(POSITION),
                         torch.from_numpy(QUAT), float(INV_SCALE),
                         camera=Camera(**CAMERA), threshold=0.005,
                         culling=culling, adaptive=adaptive,
                         device="cpu").numpy()
    assert depth.shape == (48, 64)
    assert (depth > 0).sum() > 50
    assert ((depth > 0) == (golden > 0)).mean() > 0.995
    both = (depth > 0) & (golden > 0)
    diffs = np.abs(depth[both] - golden[both])
    assert np.median(diffs) < median_tol
    assert diffs.max() < max_tol


@pytest.mark.parametrize("n,m,d", [(50, 70, 3), (7, 1, 2), (64, 64, 8)])
def test_nn_loss_matches_jax(n, m, d):
    """Seeded sets, float32 on both sides: within 1e-5."""
    rng = np.random.default_rng(n + m + d)
    a = rng.normal(size=(n, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    got = nn_loss(torch.from_numpy(a), torch.from_numpy(b))
    with jax.enable_x64(False):
        want = np.asarray(jnn_loss(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    brute = ((a[:, None] - b[None]) ** 2).sum(-1).min(1)
    np.testing.assert_allclose(got.numpy(), brute, rtol=1e-4, atol=1e-5)


def test_nn_loss_is_zero_on_coincident_points():
    """Points present in both sets: exactly 0 (the expansion's rounding
    below 0 is clamped), as in the JAX package."""
    rng = np.random.default_rng(3)
    a = (100.0 * rng.normal(size=(40, 3))).astype(np.float32)
    got = nn_loss(torch.from_numpy(a), torch.from_numpy(a[::-1].copy()))
    with jax.enable_x64(False):
        want = np.asarray(jnn_loss(jnp.asarray(a), jnp.asarray(a[::-1])))
    assert bool((got >= 0).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # integer coordinates: every product is exact, so coincident points
    # give exactly 0
    grid = rng.integers(-8, 9, size=(30, 3)).astype(np.float32)
    zero = nn_loss(torch.from_numpy(grid),
                   torch.from_numpy(np.concatenate([grid[::-1], grid + 50])))
    np.testing.assert_array_equal(zero.numpy(), np.zeros(30, np.float32))
