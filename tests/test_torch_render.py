"""Parity of the PyTorch port's renderer with the JAX package (CPU).

The plain march is held against ``sdfest_tpu.render.xla`` (the JAX
package's CPU backend); the culling + adaptive-relaxation march (the CUDA
kernel's algorithm, here in its plain twin) is held to the JAX package's own
kernel bar.  Gradients are compared as ``max|d| <= tol * max(1, max|want|)``.
"""
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.pipeline import losses as jlosses
from sdfest_tpu.render import pallas_kernel
from sdfest_tpu.render import xla
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.interpolation import sample_sdf
from sdfest_torch.render import kernels, plain
from sdfest_torch.render import render_depth, render_depth_with_pc_values

from conftest import make_box_sdf, make_sphere_sdf

CAM_ARGS = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
                pixel_center=0.5)
CAM, JCAM = Camera(**CAM_ARGS), JCamera(**CAM_ARGS)
POSITION = np.asarray([0.03, -0.01, -0.55], np.float32)
QUAT = Rotation.from_euler("XYZ", [15, 30, -10], degrees=True).as_quat().astype(
    np.float32)
INV_SCALE = np.float32(1.0 / 0.18)
SDFS = {"sphere": make_sphere_sdf(64, radius=0.5), "box": make_box_sdf(64)}


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol):
    got, want = np.asarray(got), _np(want)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (
        np.abs(got - want).max(), np.abs(want).max())


def _jax_depth(sdf):
    return _np(xla.render_depth(sdf, POSITION, QUAT, INV_SCALE, camera=JCAM,
                                threshold=0.005))


def _torch_depth(sdf, culling, adaptive):
    return render_depth(sdf, POSITION, QUAT, INV_SCALE, camera=CAM,
                        threshold=0.005, culling=culling, adaptive=adaptive,
                        device="cpu").numpy()


@pytest.mark.parametrize("name", ["sphere", "box"])
def test_plain_march_matches_xla(name):
    want = _jax_depth(SDFS[name])
    got = _torch_depth(SDFS[name], culling=False, adaptive=False)
    assert (want > 0).sum() > 50
    assert ((got > 0) == (want > 0)).mean() >= 0.999
    both = (got > 0) & (want > 0)
    assert np.abs(got[both] - want[both]).max() < 1e-4


@pytest.mark.parametrize("name", ["sphere", "box"])
def test_culling_adaptive_march_matches_xla(name):
    want = _jax_depth(SDFS[name])
    got = _torch_depth(SDFS[name], culling=True, adaptive=True)
    assert ((got > 0) == (want > 0)).mean() > 0.995
    both = (got > 0) & (want > 0)
    assert np.abs(got[both] - want[both]).max() < 5e-3


def test_coarse_table_bounds_and_matches_jax():
    sdf = SDFS["box"]
    want = np.asarray(pallas_kernel.coarse_min_table(jnp.asarray(sdf)))
    nc = plain.NC
    want = want[:, :nc].T.reshape(nc, nc, nc)  # Ttc[j*nc + k, i] -> [i, j, k]
    table = plain.coarse_min_table(_t(sdf))
    np.testing.assert_array_equal(table.numpy(), _np(want))
    # a lower bound of the interpolant everywhere (the culling invariant)
    rng = np.random.default_rng(0)
    pts = _t(rng.uniform(-1.0, 1.0, size=(5000, 3)))
    assert bool((plain.coarse_lookup(table, pts) <= sample_sdf(_t(sdf), pts))
                .all())


def test_render_depth_gradients_match_jax_grad():
    sdf = SDFS["sphere"]
    rng = np.random.default_rng(1)
    w = rng.normal(size=(48, 64)).astype(np.float32)
    args = (sdf, POSITION, QUAT, INV_SCALE)

    def jloss(s, p, q, i):
        return jnp.sum(xla.render_depth(s, p, q, i, camera=JCAM,
                                        threshold=0.005) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    leaves = [_t(a).requires_grad_() for a in args]
    depth = render_depth(*leaves, camera=CAM, threshold=0.005, culling=False,
                         adaptive=False, device="cpu")
    np.testing.assert_array_equal(depth.detach().numpy() > 0,
                                  _jax_depth(sdf) > 0)
    (depth * _t(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        _close(leaf.grad.numpy(), g, 1e-4)


def test_raster_order_backward_matches_jax_grad():
    """A camera whose size is not a multiple of the 16-pixel tile takes the
    raster-order surrogate queries; both fused ops still match jax.grad."""
    args = dict(width=60, height=44, fx=30, fy=30, cx=30, cy=22,
                pixel_center=0.5)
    cam, jcam = Camera(**args), JCamera(**args)
    sdf = SDFS["box"]
    rng = np.random.default_rng(5)
    w = rng.normal(size=(44, 60)).astype(np.float32)
    jargs = tuple(map(jnp.asarray, (sdf, POSITION, QUAT, INV_SCALE)))
    want = jax.grad(
        lambda s, p, q, i: jnp.sum(xla.render_depth(
            s, p, q, i, camera=jcam, threshold=0.005) * w),
        argnums=(0, 1, 2, 3),
    )(*jargs)
    for fused in (False, True):
        leaves = [_t(a).requires_grad_() for a in (sdf, POSITION, QUAT,
                                                   INV_SCALE)]
        kw = dict(threshold=0.005, culling=False, adaptive=False,
                  device="cpu")
        if fused:  # no observed points: only the depth term
            depth, _ = render_depth_with_pc_values(
                leaves[0], leaves[1], leaves[2], 1.0 / leaves[3],
                torch.zeros(1, 3), torch.zeros(1), cam, **kw)
        else:
            depth = render_depth(*leaves, camera=cam, **kw)
        assert int((depth > 0).sum()) > 50
        (depth * _t(w)).sum().backward()
        for leaf, g in zip(leaves, want):
            _close(leaf.grad.numpy(), g, 1e-4)


def test_render_depth_backward_equals_plain_surrogate():
    """The kernel-path backward (tile-order queries, sample-grad + scatter)
    equals autograd through the XLA-style raster surrogate."""
    sdf = SDFS["box"]
    rng = np.random.default_rng(2)
    w = _t(rng.normal(size=(48, 64)))
    args = (sdf, POSITION, QUAT, INV_SCALE)
    a = [_t(x).requires_grad_() for x in args]
    depth = render_depth(*a, camera=CAM, threshold=0.005, device="cpu")
    (depth * w).sum().backward()
    b = [_t(x).requires_grad_() for x in args]
    dirs = plain.pixel_directions(CAM, torch.device("cpu")).reshape(48, 64, 3)
    sur = plain.depth_surrogate(*b, depth.detach(), dirs)
    (sur * w).sum().backward()
    for x, y in zip(a, b):
        _close(x.grad.numpy(), y.grad.numpy(), 1e-5)


def test_render_depth_with_pc_values_matches_separate_jax_path():
    sdf = SDFS["sphere"]
    rng = np.random.default_rng(3)
    scale = np.float32(0.18)
    points = (POSITION + rng.normal(scale=0.12, size=(400, 3))).astype(
        np.float32)
    point_mask = (rng.uniform(size=400) < 0.8).astype(np.float32)
    w = rng.normal(size=(48, 64)).astype(np.float32)
    v = rng.normal(size=(400,)).astype(np.float32)

    def jfwd(s, p, q, sc, pts):
        depth = xla.render_depth(s, p, q, 1.0 / sc, camera=JCAM,
                                 threshold=0.005)
        values = jlosses.pc_loss(pts, p, q, sc, s, point_mask, backend="xla")
        return depth, values

    jargs = tuple(map(jnp.asarray, (sdf, POSITION, QUAT, scale, points)))
    want_depth, want_values = jfwd(*jargs)
    want = jax.grad(
        lambda *a: jnp.sum(jfwd(*a)[0] * w) + jnp.sum(jfwd(*a)[1] * v),
        argnums=(0, 1, 2, 3, 4),
    )(*jargs)
    leaves = [_t(a).requires_grad_() for a in (sdf, POSITION, QUAT, scale,
                                               points)]
    depth, values = render_depth_with_pc_values(
        *leaves, _t(point_mask), CAM, threshold=0.005, culling=False,
        adaptive=False, device="cpu",
    )
    np.testing.assert_allclose(depth.detach().numpy(), _np(want_depth),
                               atol=1e-4)
    np.testing.assert_allclose(values.detach().numpy(), _np(want_values),
                               atol=1e-5)
    ((depth * _t(w)).sum() + (values * _t(v)).sum()).backward()
    for leaf, g in zip(leaves, want):
        _close(leaf.grad.numpy(), g, 1e-4)


def test_sampler_plain_twins_match_jax():
    sdf = SDFS["sphere"]
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.1, 1.1, size=(600, 3)).astype(np.float32)
    mask = (np.arange(600) % 3 != 0).astype(np.float32)
    cot = rng.normal(size=600).astype(np.float32)
    want_v = _np(jnp.asarray(mask) * xla.sample_sdf(sdf, pts))
    want_g = _np(jax.vmap(jax.grad(lambda p: xla.sample_sdf(sdf, p[None])[0]))(
        jnp.asarray(pts))) * mask[:, None]
    _, vjp = jax.vjp(lambda s: xla.sample_sdf(s, pts), jnp.asarray(sdf))
    (want_s,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(
        kernels.sample(_t(sdf), _t(pts), _t(mask)).numpy(), want_v, atol=1e-5)
    value, grad = kernels.sample_grad(_t(sdf), _t(pts), _t(mask))
    np.testing.assert_allclose(value.numpy(), want_v, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_g, atol=1e-4)
    np.testing.assert_allclose(
        kernels.scatter(_t(pts), _t(cot), 64).numpy(), _np(want_s), atol=1e-4)


def test_tile_order_matches_jax():
    x = np.arange(48 * 64 * 3, dtype=np.float32).reshape(48, 64, 3)
    want = np.asarray(pallas_kernel._tile_image(jnp.asarray(x), 48, 64))
    got = kernels.tile_image(torch.from_numpy(x), 48, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = got[:, 0].contiguous()
    np.testing.assert_array_equal(kernels.untile_image(flat, 48, 64).numpy(),
                                  x[..., 0])
    # host ray planes: the JAX package's camera constants
    np.testing.assert_array_equal(
        plain.pixel_directions_np(CAM), pallas_kernel._camera_ray_planes(JCAM)[0]
    )


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launches()
    leaves = [_t(a).requires_grad_() for a in (SDFS["sphere"], POSITION, QUAT,
                                               0.18)]
    depth, values = render_depth_with_pc_values(
        *leaves, _t(np.tile(POSITION, (10, 1))), torch.ones(10), CAM,
        threshold=0.005, device="cpu",
    )
    (depth.sum() + values.sum()).backward()
    assert kernels.launches() == {k: 0 for k in kernels.KERNELS}


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.utils.presets import preset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_depth(SDFS["sphere"], POSITION, QUAT, INV_SCALE, camera=CAM)
    with pytest.raises(RuntimeError, match="CUDA"):
        render_depth_with_pc_values(SDFS["sphere"], POSITION, QUAT, 0.18,
                                    np.zeros((3, 3)), np.ones(3), CAM)
    with pytest.raises(RuntimeError, match="CUDA"):
        SDFPipeline(preset("mug_procedural"))
    with pytest.raises(ValueError):  # kernels refuse non-CPU, non-CUDA input
        kernels.sample(torch.zeros(4, 4, 4, device="meta"),
                       torch.zeros(2, 3, device="meta"),
                       torch.zeros(2, device="meta"))


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without CUDA."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv = ['chip_smoke.py']; import runpy; "
            "runpy.run_path('chip_smoke.py', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


ROI_CAM_ARGS = dict(width=96, height=64, fx=48, fy=48, cx=48, cy=32,
                    pixel_center=0.5)
ROI_QUAT = (np.asarray([0.2, 0.1, 0.0, 0.97]) / np.linalg.norm(
    [0.2, 0.1, 0.0, 0.97])).astype(np.float32)
ROI_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)


@pytest.mark.parametrize("flags", [True, False])
@pytest.mark.parametrize("name", ["sphere", "box"])
def test_roi_render_equals_full_crop(name, flags):
    """An ROI render equals the same crop of the full render bit for bit
    (the camera and offsets of the JAX package's own ROI test), with
    culling + adaptive relaxation on and off."""
    cam = Camera(**ROI_CAM_ARGS)
    kw = dict(camera=cam, threshold=0.005, culling=flags, adaptive=flags,
              device="cpu")
    args = (SDFS[name], ROI_POSITION, ROI_QUAT, 5.0)
    full = render_depth(*args, **kw)
    for off in ((0, 0), (16, 32), (32, 48)):
        roi = render_depth(*args, roi=(32, 48), roi_offset=off, **kw)
        assert roi.shape == (32, 48)
        assert torch.equal(roi, full[off[0]:off[0] + 32, off[1]:off[1] + 48])
    assert int((full > 0).sum()) > 300


@pytest.mark.parametrize("roi,offset", [((32, 48), (16, 24)),
                                        ((24, 40), (21, 30))])
def test_roi_render_with_pc_values_matches_jax(roi, offset):
    """Forward and gradients of the fused op on an ROI (16-aligned: tile
    order surrogate; unaligned: raster order) against the JAX package's
    XLA ROI path (full render + crop + pc_loss)."""
    from sdfest_tpu.render.api import (
        render_depth_with_pc_values as jrender_pc,
    )

    sdf = SDFS["box"]
    cam, jcam = Camera(**ROI_CAM_ARGS), JCamera(**ROI_CAM_ARGS)
    rng = np.random.default_rng(7)
    scale = np.float32(0.2)
    points = (ROI_POSITION + rng.normal(scale=0.12, size=(300, 3))).astype(
        np.float32)
    point_mask = (rng.uniform(size=300) < 0.8).astype(np.float32)
    w = rng.normal(size=roi).astype(np.float32)
    v = rng.normal(size=(300,)).astype(np.float32)
    off = jnp.asarray(offset, jnp.int32)

    def jfwd(s, p, q, sc, pts):
        return jrender_pc(s, p, q, sc, pts, point_mask, camera=jcam,
                          threshold=0.005, backend="xla", roi=roi,
                          roi_offset=off)

    jargs = tuple(map(jnp.asarray, (sdf, ROI_POSITION, ROI_QUAT, scale,
                                    points)))
    want_depth, want_values = jfwd(*jargs)
    want = jax.grad(
        lambda *a: jnp.sum(jfwd(*a)[0] * w) + jnp.sum(jfwd(*a)[1] * v),
        argnums=(0, 1, 2, 3, 4),
    )(*jargs)
    leaves = [_t(a).requires_grad_() for a in (sdf, ROI_POSITION, ROI_QUAT,
                                               scale, points)]
    depth, values = render_depth_with_pc_values(
        *leaves, _t(point_mask), cam, threshold=0.005, culling=False,
        adaptive=False, device="cpu", roi=roi, roi_offset=offset,
    )
    assert depth.shape == roi and int((depth > 0).sum()) > 100
    np.testing.assert_allclose(depth.detach().numpy(), _np(want_depth),
                               atol=1e-4)
    np.testing.assert_allclose(values.detach().numpy(), _np(want_values),
                               atol=1e-4)
    ((depth * _t(w)).sum() + (values * _t(v)).sum()).backward()
    for leaf, g in zip(leaves, want):
        _close(leaf.grad.numpy(), g, 1e-3)


def test_prebuilt_ray_set_equals_roi_arguments():
    """The refinement loop's prebuilt ray set gives the same depth and
    gradients as roi/roi_offset; passing both is refused."""
    from sdfest_torch.render.api import ray_set

    cam = Camera(**ROI_CAM_ARGS)
    off = torch.tensor([16, 32], dtype=torch.int32)
    rays = ray_set(cam, "cpu", (32, 48), off)
    assert rays.shape == (32, 48)
    full = plain.pixel_directions(cam, torch.device("cpu")).reshape(64, 96, 3)
    assert torch.equal(rays.march, full[16:48, 32:80])
    assert torch.equal(rays.surrogate, kernels.tile_image(rays.march, 32, 48))
    outs = []
    for kw in (dict(roi=(32, 48), roi_offset=off), dict(rays=rays)):
        leaves = [_t(a).requires_grad_() for a in (SDFS["sphere"],
                                                   ROI_POSITION, ROI_QUAT)]
        depth, values = render_depth_with_pc_values(
            *leaves, 0.2, torch.zeros(1, 3), torch.zeros(1), cam,
            threshold=0.005, device="cpu", **kw)
        depth.sum().backward()
        outs.append([depth.detach()] + [x.grad for x in leaves])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="either"):
        render_depth_with_pc_values(
            SDFS["sphere"], ROI_POSITION, ROI_QUAT, 0.2, torch.zeros(1, 3),
            torch.zeros(1), cam, device="cpu", roi=(32, 48), rays=rays)
    with pytest.raises(ValueError, match="fit"):
        render_depth(SDFS["sphere"], ROI_POSITION, ROI_QUAT, 5.0, camera=cam,
                     device="cpu", roi=(80, 48))


# ---------------------------------------------------------------------------
# hypotheses: a leading batch dim through the wrappers and the render ops
# ---------------------------------------------------------------------------

MARCHES = {"culling_adaptive": dict(culling=True, adaptive=True),
           "plain": dict(culling=False, adaptive=False),
           "relaxed": dict(culling=True, adaptive=True, relaxation=1.5),
           "bf16": dict(culling=True, adaptive=True, bf16=True)}
# three hypotheses: the test pose, a moved and turned one, one behind the
# camera (it misses the frame)
HYP_POSITIONS = np.asarray([POSITION, POSITION + [0.02, 0.01, 0.03],
                            POSITION * [1, 1, -1]], np.float32)
HYP_QUATS = np.asarray([QUAT, (Rotation.from_euler("XYZ", [5, -8, 4],
                                                    degrees=True)
                               * Rotation.from_quat(QUAT)).as_quat(), QUAT],
                       np.float32)
HYP_SCALES = np.asarray([0.18, 0.16, 0.18], np.float32)


def _hyp_grids():
    return torch.stack([_t(SDFS["sphere"]), _t(SDFS["box"]),
                        _t(SDFS["box"]) * 1.05])


def _hyp_poses():
    return kernels.pose_params(_t(HYP_POSITIONS), _t(HYP_QUATS),
                               1.0 / _t(HYP_SCALES))


def test_batched_pose_params_equal_each_alone():
    poses = _hyp_poses()
    assert poses.shape == (3, 14)
    for b in range(3):
        assert torch.equal(poses[b], kernels.pose_params(
            _t(HYP_POSITIONS[b]), _t(HYP_QUATS[b]),
            1.0 / _t(HYP_SCALES[b])))


@pytest.mark.parametrize("name", list(MARCHES))
def test_batched_march_equals_each_hypothesis_alone(name):
    """The march of a batch (grid (B, R, R, R), poses (B, 14), shared rays,
    full frame and an ROI crop) equals each hypothesis marched alone, bit
    for bit; the hypothesis behind the camera gives zeros."""
    from sdfest_torch.render import api

    grids, poses = _hyp_grids(), _hyp_poses()
    for rays in (api.ray_set(CAM, "cpu").march,
                 api.ray_set(CAM, "cpu", (32, 48), torch.tensor([8, 4])
                             ).march):
        got = kernels.march(grids, rays, poses, 0.005, 500, **MARCHES[name])
        assert got.shape == (3, *rays.shape[:2])
        for b in range(3):
            assert torch.equal(got[b], kernels.march(
                grids[b], rays, poses[b], 0.005, 500, **MARCHES[name]))
        assert int((got[0] > 0).sum()) > 50 and not bool(got[2].any())


def test_batched_samplers_and_scatter_equal_each_hypothesis_alone():
    grids = _hyp_grids()
    g = torch.Generator().manual_seed(0)
    pts = torch.rand(3, 700, 3, generator=g) * 2.2 - 1.1
    mask = (torch.rand(3, 700, generator=g) < 0.6).float()
    cot = torch.randn(3, 700, generator=g) * mask
    value = kernels.sample(grids, pts, mask)
    v, gr = kernels.sample_grad(grids, pts, mask)
    acc = kernels.scatter(pts, cot, 64)
    assert value.shape == v.shape == (3, 700) and gr.shape == (3, 700, 3)
    assert acc.shape == (3, 64, 64, 64)
    for b in range(3):
        assert torch.equal(value[b], kernels.sample(grids[b], pts[b],
                                                    mask[b]))
        want_v, want_g = kernels.sample_grad(grids[b], pts[b], mask[b])
        assert torch.equal(v[b], want_v) and torch.equal(gr[b], want_g)
        assert torch.equal(acc[b], kernels.scatter(pts[b], cot[b], 64))


def test_batched_coarse_tables_equal_each_grid_alone():
    grids = _hyp_grids()
    for fn in (plain.coarse_min_table, plain.coarse_max_table,
               plain.coarse_pair_table, plain.bf16_corners):
        got = fn(grids)
        for b in range(3):
            assert torch.equal(got[b], fn(grids[b])), fn.__name__


def _render_hypotheses(grids, positions, quats, scales, points, mask):
    """The fused render of hypotheses ``(B, ...)`` and the gradients of a
    fixed weighting of its outputs w.r.t. every input."""
    leaves = [x.clone().requires_grad_() for x in
              (grids, positions, quats, scales)]
    depth, values = render_depth_with_pc_values(
        *leaves, points, mask, CAM, threshold=0.005, device="cpu")
    w_d = torch.linspace(0.5, 1.5, H_W)
    loss = (depth.reshape(*depth.shape[:-2], -1) * w_d).sum() + (
        values * torch.linspace(1.0, 2.0, values.shape[-1])).sum()
    return depth, values, torch.autograd.grad(loss, leaves)


H_W = CAM.height * CAM.width


def test_batched_render_op_equals_each_hypothesis_alone():
    """The fused render + pc values of three hypotheses (one missing the
    frame) equal each hypothesis rendered alone: depth and values bit for
    bit, every gradient within 1e-6 (one backward of one sample-grad and one
    scatter for all)."""
    grids = _hyp_grids()
    points = _t(POSITION + np.random.default_rng(3).normal(
        scale=0.1, size=(200, 3)))
    mask = torch.ones(200)
    batch = _render_hypotheses(grids, _t(HYP_POSITIONS), _t(HYP_QUATS),
                               _t(HYP_SCALES), points, mask)
    assert batch[0].shape == (3, 48, 64) and batch[1].shape == (3, 200)
    for b in range(3):
        alone = _render_hypotheses(grids[b], _t(HYP_POSITIONS[b]),
                                   _t(HYP_QUATS[b]), _t(HYP_SCALES[b]),
                                   points, mask)
        assert torch.equal(batch[0][b], alone[0])
        assert torch.equal(batch[1][b], alone[1])
        for got, want in zip(batch[2], alone[2]):
            _close(got[b].numpy(), want.numpy(), 1e-6)


def test_quaternion_is_normalized_per_hypothesis():
    """A batch of a unit quaternion and the same scaled by 3 renders each
    row as that quaternion alone (depth, pc values, gradients: |q| and
    |q|^2 are taken per hypothesis), and the pc values of both rows agree
    (they normalize)."""
    grids = torch.stack([_t(SDFS["sphere"])] * 2)
    quats = torch.stack([_t(QUAT), 3.0 * _t(QUAT)])
    positions = torch.stack([_t(POSITION)] * 2)
    scales = _t([0.18, 0.18])
    points = _t(POSITION + np.random.default_rng(4).normal(
        scale=0.1, size=(200, 3)))
    mask = torch.ones(200)
    batch = _render_hypotheses(grids, positions, quats, scales, points, mask)
    for b in range(2):
        alone = _render_hypotheses(grids[b], positions[b], quats[b],
                                   scales[b], points, mask)
        assert torch.equal(batch[0][b], alone[0])
        assert torch.equal(batch[1][b], alone[1])
        for got, want in zip(batch[2], alone[2]):
            _close(got[b].numpy(), want.numpy(), 1e-6)
    np.testing.assert_allclose(batch[1][1].detach().numpy(),
                               batch[1][0].detach().numpy(), atol=1e-6)
