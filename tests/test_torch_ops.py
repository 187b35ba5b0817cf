"""Parity of the PyTorch port's geometry ops with the JAX package (CPU).

Inputs are float32 numpy arrays from a seed, fed to both packages; the JAX
outputs are cast to float32 before comparing (the test session runs JAX in
x64 mode).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdfest_tpu.ops import camera as jcamera
from sdfest_tpu.ops import interpolation as jinterp
from sdfest_tpu.ops import pointset as jpointset
from sdfest_tpu.ops import quaternion as jquat
from sdfest_tpu.ops import so3grid as jso3grid
from sdfest_torch.ops import camera as tcamera
from sdfest_torch.ops import interpolation as tinterp
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.ops import quaternion as tquat
from sdfest_torch.ops import so3grid as tso3grid

from conftest import make_box_sdf, make_sphere_sdf


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(_np(x))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_ops_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = _unit_quats(rng, 16), _unit_quats(rng, 16)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    pairs = [
        (jquat.multiply(q1, q2), tquat.multiply(_t(q1), _t(q2))),
        (jquat.invert(q1), tquat.invert(_t(q1))),
        (jquat.apply(q1, pts), tquat.apply(_t(q1), _t(pts))),
        (jquat.to_rotation_matrix(q1), tquat.to_rotation_matrix(_t(q1))),
        (jquat.geodesic_distance(q1, q2),
         tquat.geodesic_distance(_t(q1), _t(q2))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6)
    # R @ p == apply(q, p)
    rot = tquat.to_rotation_matrix(_t(q1))
    np.testing.assert_allclose(
        (rot @ _t(pts)[..., None])[..., 0].numpy(),
        tquat.apply(_t(q1), _t(pts)).numpy(), atol=1e-5,
    )


def test_camera_matches_jax():
    args = dict(width=64, height=48, fx=30.5, fy=31.0, cx=32.2, cy=23.9,
                pixel_center=0.5)
    jc, tc = jcamera.Camera(**args), tcamera.Camera(**args)
    for pc in (0.0, 0.5):
        assert tc.get_pinhole_camera_parameters(pc) == (
            jc.get_pinhole_camera_parameters(pc)
        )
    assert tcamera.Camera.from_fov(640, 480, 90.0).__dict__ == (
        jcamera.Camera.from_fov(640, 480, 90.0).__dict__
    )
    hash(tc)  # cameras key the ray-direction caches


@pytest.mark.parametrize("sdf_fn", [make_sphere_sdf, make_box_sdf])
@pytest.mark.parametrize("span", [0.95, 1.25])
def test_sample_sdf_values_match_jax(sdf_fn, span):
    rng = np.random.default_rng(1)
    sdf = sdf_fn(64)
    pts = rng.uniform(-span, span, size=(2000, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tinterp.sample_sdf(_t(sdf), _t(pts)).numpy(),
        _np(jinterp.sample_sdf(jnp.asarray(sdf), jnp.asarray(pts))),
        atol=1e-5,
    )
    got, got_inside = tinterp.sample_sdf_masked(_t(sdf), _t(pts))
    want, want_inside = jinterp.sample_sdf_masked(
        jnp.asarray(sdf), jnp.asarray(pts)
    )
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    np.testing.assert_array_equal(got_inside.numpy(), np.asarray(want_inside))


def test_sample_sdf_gradients_match_jax_grad():
    rng = np.random.default_rng(2)
    sdf = make_sphere_sdf(64)
    pts = rng.uniform(-1.1, 1.1, size=(500, 3)).astype(np.float32)
    cot = rng.normal(size=(500,)).astype(np.float32)

    def jloss(s, p):
        return jnp.sum(jinterp.sample_sdf(s, p) * cot)

    want_s, want_p = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(sdf), jnp.asarray(pts)
    )
    s = _t(sdf).requires_grad_()
    p = _t(pts).requires_grad_()
    (tinterp.sample_sdf(s, p) * _t(cot)).sum().backward()
    np.testing.assert_allclose(s.grad.numpy(), _np(want_s), atol=1e-4)
    np.testing.assert_allclose(p.grad.numpy(), _np(want_p), atol=1e-4)
    # closed-form gradient and corner weights (the kernels' plain twins)
    value, grad = tinterp.sample_sdf_value_and_grad(_t(sdf), _t(pts))
    np.testing.assert_allclose(
        value.numpy(), _np(jinterp.sample_sdf(sdf, pts)), atol=1e-5
    )
    np.testing.assert_allclose(
        (grad * _t(cot)[:, None]).numpy(), _np(want_p), atol=1e-4
    )
    idx, w = tinterp.trilinear_weights(_t(pts), 64)
    acc = torch.zeros(64 ** 3).index_add_(
        0, idx.reshape(-1), (w * _t(cot)[:, None]).reshape(-1)
    )
    np.testing.assert_allclose(acc.reshape(64, 64, 64).numpy(), _np(want_s),
                               atol=1e-4)


@pytest.mark.parametrize("order", ["raster", "tile"])
def test_depth_to_pointcloud_dense_matches_jax(order):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.3, 1.0, size=(48, 64)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.4] = 0.0
    mask = (rng.uniform(size=depth.shape) < 0.8).astype(np.float32)
    args = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
                pixel_center=0.5)
    want_p, want_m = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(depth), jcamera.Camera(**args), mask=jnp.asarray(mask),
        order=order,
    )
    got_p, got_m = tpointset.depth_to_pointcloud_dense(
        _t(depth), tcamera.Camera(**args), mask=_t(mask), order=order
    )
    np.testing.assert_allclose(got_p.numpy(), _np(want_p), atol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_normalize_and_subsample_masked_match_jax(monkeypatch):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    mask = rng.uniform(size=300) < 0.3
    want_n, want_c = jpointset.normalize_points_masked(
        jnp.asarray(pts), jnp.asarray(mask)
    )
    got_n, got_c = tpointset.normalize_points_masked(
        _t(pts), torch.from_numpy(mask)
    )
    np.testing.assert_allclose(got_n.numpy(), _np(want_n), atol=1e-6)
    np.testing.assert_allclose(got_c.numpy(), _np(want_c), atol=1e-6)

    key = jax.random.PRNGKey(7)
    want_s, want_any = jpointset.subsample_masked(
        jnp.asarray(pts), jnp.asarray(mask), 100, key
    )
    u = torch.from_numpy(np.array(jax.random.uniform(key, (100,))))
    monkeypatch.setattr(tpointset, "_uniform", lambda n, g, d: u)
    got_s, got_any = tpointset.subsample_masked(
        _t(pts), torch.from_numpy(mask), 100
    )
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    assert bool(got_any) == bool(want_any)
    # only valid rows are ever drawn
    assert set(map(tuple, got_s.numpy())) <= set(map(tuple, pts[mask]))


@pytest.mark.parametrize("resol", [0, 1])
def test_so3grid_quaternions_equal(resol):
    want = jso3grid.SO3Grid(resol)
    got = tso3grid.SO3Grid(resol)
    assert got.num_cells() == want.num_cells()
    np.testing.assert_array_equal(got.quaternions(), want.quaternions())


def test_resize_trilinear_matches_jax():
    rng = np.random.default_rng(5)
    vol = rng.normal(size=(1, 3, 6, 6, 6)).astype(np.float32)
    for size in (16, 13):  # the decoder only upsamples
        np.testing.assert_allclose(
            tinterp.resize_trilinear(_t(vol), size).numpy(),
            _np(jinterp.resize_trilinear(jnp.asarray(vol), size)),
            atol=1e-5,
        )


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_camera_strided_matches_jax(factor):
    args = dict(width=640, height=480, fx=320.0, fy=310.0, cx=320.3,
                cy=239.6, pixel_center=0.5)
    want = jcamera.Camera(**args).strided(factor)
    got = tcamera.Camera(**args).strided(factor)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("factor,skew", [(3, 0.0), (0, 0.0), (7, 0.0),
                                         (2, 0.1)])
def test_camera_strided_rejects_like_jax(factor, skew):
    args = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24, s=skew)
    for cls in (jcamera.Camera, tcamera.Camera):
        with pytest.raises(ValueError):
            cls(**args).strided(factor)


def _offset_scene():
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.3, 1.0, size=(64, 96)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    args = dict(width=96, height=64, fx=48, fy=47, cx=48.5, cy=31.5,
                pixel_center=0.5)
    return depth, args


@pytest.mark.parametrize("order", ["raster", "tile"])
@pytest.mark.parametrize("roi,offset", [((32, 48), (16, 32)),
                                        ((20, 40), (7, 13))])
def test_depth_to_pointcloud_dense_offset_matches_jax(order, roi, offset):
    """A crop lifted with its pixel offset, against JAX; a 16-aligned crop
    takes tile order, another stays raster (as JAX does)."""
    depth, args = _offset_scene()
    sub = depth[offset[0]:offset[0] + roi[0], offset[1]:offset[1] + roi[1]]
    want_p, want_m = jpointset.depth_to_pointcloud_dense(
        jnp.asarray(sub), jcamera.Camera(**args), order=order,
        pixel_offset=jnp.asarray(offset, jnp.int32),
    )
    got_p, got_m = tpointset.depth_to_pointcloud_dense(
        _t(sub), tcamera.Camera(**args), order=order,
        pixel_offset=torch.tensor(offset, dtype=torch.int32),
    )
    np.testing.assert_allclose(got_p.numpy(), _np(want_p), atol=1e-6)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_crop_lift_equals_matching_rows_of_full_lift():
    depth, args = _offset_scene()
    cam = tcamera.Camera(**args)
    full_p, full_m = tpointset.depth_to_pointcloud_dense(_t(depth), cam)
    full_p, full_m = full_p.reshape(64, 96, 3), full_m.reshape(64, 96)
    for (r, c), (h, w) in [((16, 32), (32, 48)), ((5, 9), (21, 30))]:
        got_p, got_m = tpointset.depth_to_pointcloud_dense(
            _t(depth[r:r + h, c:c + w]), cam,
            pixel_offset=torch.tensor([r, c], dtype=torch.int32),
        )
        assert torch.equal(got_p, full_p[r:r + h, c:c + w].reshape(-1, 3))
        assert torch.equal(got_m, full_m[r:r + h, c:c + w].reshape(-1))
