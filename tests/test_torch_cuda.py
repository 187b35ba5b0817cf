"""The port's CUDA kernels against their plain twins, on a CUDA card.

These tests need the card: a CUDA kernel has no CPU mode, so they skip
without one.  The file imports neither JAX nor the conftest (the machine
with the card has no JAX); run it there from the repository root with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from sdfest_torch.ops.camera import Camera
from sdfest_torch.render import api, kernels, plain

CAM = Camera(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
             pixel_center=0.5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _box_sdf(res=64, half=(0.4, 0.3, 0.5)):
    c = np.linspace(-1.0, 1.0, res)
    q = np.abs(np.stack(np.meshgrid(c, c, c, indexing="ij"), -1)) - half
    out = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    return torch.from_numpy((out + np.minimum(q.max(-1), 0.0)).astype(
        np.float32))


@pytest.mark.cuda
def test_samplers_and_scatter_match_plain_twins(dev):
    sdf = _box_sdf().to(dev)
    g = torch.Generator().manual_seed(0)
    pts = ((torch.rand(5000, 3, generator=g) * 2.2 - 1.1)).to(dev)
    mask = (torch.rand(5000, generator=g) < 0.7).float().to(dev)
    torch.testing.assert_close(kernels.sample(sdf, pts, mask),
                               kernels.sample_plain(sdf, pts, mask),
                               atol=1e-4, rtol=0)
    v, gr = kernels.sample_grad(sdf, pts, mask)
    wv, wg = kernels.sample_grad_plain(sdf, pts, mask)
    torch.testing.assert_close(v, wv, atol=1e-4, rtol=0)
    torch.testing.assert_close(gr, wg, atol=1e-3, rtol=0)
    cot = (torch.randn(5000, generator=g).to(dev) * mask).contiguous()
    want = kernels.scatter_plain(pts, cot, 64)
    got = kernels.scatter(pts, cot, 64)
    assert float((got - want).abs().max()) <= 1e-3 * max(
        1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [True, False])
def test_march_matches_plain_twin(dev, flags):
    sdf = _box_sdf().to(dev)
    dirs = plain.pixel_directions(CAM, dev)
    q = torch.tensor([0.13, 0.26, -0.05, 0.95], device=dev)
    pose = kernels.pose_params(torch.tensor([0.03, -0.01, -0.55], device=dev),
                               q / q.norm(), torch.tensor(1 / 0.18, device=dev))
    got = kernels.march(sdf, dirs, pose, 0.005, 500, flags, flags)
    want = plain.march_plain(sdf, dirs, pose, 0.005, 500, flags, flags)
    assert int((want > 0).sum()) > 50
    assert float(((got > 0) == (want > 0)).float().mean()) > 0.995
    both = (got > 0) & (want > 0)
    assert float((got - want)[both].abs().max()) < 5e-3


@pytest.mark.cuda
def test_fused_op_launches_each_kernel_once(dev):
    sdf = _box_sdf().to(dev).requires_grad_()
    pos = torch.tensor([0.03, -0.01, -0.55], device=dev, requires_grad=True)
    q = torch.tensor([0.13, 0.26, -0.05, 0.95], device=dev)
    q = (q / q.norm()).requires_grad_()
    scale = torch.tensor(0.18, device=dev, requires_grad=True)
    points = (pos.detach() + 0.1 * torch.randn(300, 3, device=dev))
    kernels.reset_launches()
    depth, values = api.render_depth_with_pc_values(
        sdf, pos, q, scale, points, torch.ones(300, device=dev), CAM,
        threshold=0.005, device=dev,
    )
    (depth.sum() + values.sum()).backward()
    torch.cuda.synchronize()
    assert kernels.launches() == {k: 1 for k in kernels.KERNELS}
    for t in (sdf, pos, q, scale):
        assert bool(torch.isfinite(t.grad).all())


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [True, False])
def test_roi_march_equals_crop_of_full_march(dev, flags):
    """On the card, the march on an ROI's rays equals the crop of the full
    render bit for bit, for aligned and unaligned crops."""
    cam = Camera(width=96, height=64, fx=48, fy=48, cx=48, cy=32,
                 pixel_center=0.5)
    sdf = _box_sdf().to(dev)
    q = torch.tensor([0.2, 0.1, 0.0, 0.97], device=dev)
    pose = kernels.pose_params(torch.tensor([0.02, -0.01, -0.5], device=dev),
                               q / q.norm(), torch.tensor(5.0, device=dev))
    full = kernels.march(sdf, api.ray_set(cam, dev).march, pose, 0.005, 500,
                         flags, flags)
    assert int((full > 0).sum()) > 300
    for roi, off in (((32, 48), (0, 0)), ((32, 48), (16, 32)),
                     ((32, 48), (32, 48)), ((20, 37), (9, 5))):
        rays = api.ray_set(cam, dev, roi,
                           torch.tensor(off, dtype=torch.int32, device=dev))
        kernels.reset_launches()
        got = kernels.march(sdf, rays.march, pose, 0.005, 500, flags, flags)
        torch.cuda.synchronize()
        assert kernels.march.rasters == {roi: 1}
        assert torch.equal(got, full[off[0]:off[0] + roi[0],
                                     off[1]:off[1] + roi[1]])
