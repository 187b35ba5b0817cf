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
    want = kernels.scatter_plain(pts.cpu(), cot.cpu(), 64)
    got = kernels.scatter(pts, cot, 64)
    assert torch.equal(got.cpu(), want)


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
    assert kernels.launches() == {k: int(k != "march_warm")
                                  for k in kernels.KERNELS}
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


_MUGS = {}


@pytest.fixture
def mug(dev):
    """A mug decoded from a seeded latent with the committed weights, and
    the 640x480 camera of the main path (made once per device)."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.utils.presets import preset

    if dev not in _MUGS:
        pipe = SDFPipeline(preset("mug_procedural"), device=dev)
        latent = 0.5 * torch.randn(1, 8, generator=torch.Generator(
            ).manual_seed(0))
        with torch.no_grad():
            sdf = pipe._decode(latent.to(dev))[0, 0].contiguous()
        _MUGS[dev] = sdf, pipe.camera
    return _MUGS[dev]


@pytest.mark.cuda
def test_decoder_runs_in_fp32_with_tf32_allowed(dev):
    """With cuDNN's TF32 switch at PyTorch's default (allowed), the decoder
    on the card equals the CPU decoder within 1e-5: the package runs its
    convolutions in full fp32 by itself."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.utils.presets import preset

    latent = 0.5 * torch.randn(1, 8, generator=torch.Generator(
        ).manual_seed(0))
    with torch.no_grad():
        want = SDFPipeline(preset("mug_procedural"), device="cpu")._decode(
            latent)
    pipe = SDFPipeline(preset("mug_procedural"), device=dev)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got = pipe._decode(latent.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    err = float((got - want).abs().max())
    assert err <= 1e-5, f"decoder on the card: max|d| {err:.3e} (tol 1e-5)"


def _latent_gradient(pipe, latent, cot):
    z = latent.clone().requires_grad_(True)
    return torch.autograd.grad((pipe._decode(z) * cot).sum(), z)[0]


@pytest.mark.cuda
def test_estimate_latent_gradient_in_fp32_matches_cpu(dev):
    """The latent gradient of one decoder forward and backward (batch 1,
    latent 8, a seeded cotangent on the 64^3 output) as the estimate takes
    it with shape optimization, inside fp32_convolutions(deterministic=
    True), with cuDNN's TF32 switch at PyTorch's default: on the card
    within 1e-5 of the largest value of the CPU port's, and equal on a
    second run.  The same gradient taken outside the context (cuDNN's
    default TF32 backward) is printed beside it."""
    from sdfest_torch.models.vae import fp32_convolutions
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.utils.presets import preset

    g = torch.Generator().manual_seed(3)
    latent = 0.5 * torch.randn(1, 8, generator=g)
    cot = torch.randn(1, 1, 64, 64, 64, generator=g)
    with fp32_convolutions(deterministic=True):
        want = _latent_gradient(SDFPipeline(preset("mug_procedural"),
                                            device="cpu"), latent, cot)
    pipe = SDFPipeline(preset("mug_procedural"), device=dev)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with fp32_convolutions(deterministic=True):
            got = [_latent_gradient(pipe, latent.to(dev), cot.to(dev)).cpu()
                   for _ in range(2)]
        bare = _latent_gradient(pipe, latent.to(dev), cot.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    scale = float(want.abs().max())
    err = float((got[0] - want).abs().max())
    print(f"latent gradient on the card against the CPU: max|d| {err:.3e} "
          f"of max|g| {scale:.3e} (tol 1e-5 of it); outside the context "
          f"{float((bare - want).abs().max()):.3e}")
    assert torch.equal(got[0], got[1])
    assert err <= 1e-5 * scale, err


def _mug_pose(dev, dp=(0.0, 0.0, 0.0), scale=0.1):
    q = torch.tensor([0.25, 0.35, 0.1, 0.895], device=dev)
    return kernels.pose_params(
        torch.tensor([0.02, -0.01, -0.5], device=dev) + torch.tensor(
            dp, device=dev), q / q.norm(), torch.tensor(1.0 / scale,
                                                        device=dev))


def _depth_bar(got, want):
    assert int((want > 0).sum()) > 3000
    assert float(((got > 0) == (want > 0)).float().mean()) > 0.995
    both = (got > 0) & (want > 0)
    assert float((got - want)[both].abs().max()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("warm_start", [False, True])
def test_march_warm_matches_plain_twin(dev, mug, warm_start):
    """At 640x480 on a decoded mug, cold and with the t_init/skip of a real
    warm step (a full render, then a small move)."""
    from sdfest_torch.render import warm

    sdf, cam = mug
    rays = api.ray_set(cam, dev).march
    shape = rays.shape[:2]
    t_init = torch.full(shape, -1.0, device=dev)
    skip = torch.zeros(shape, device=dev)
    pose = _mug_pose(dev)
    if warm_start:
        outs = kernels.march_warm(sdf, rays, pose, t_init, skip, 0.005, 500)
        hit = (outs[0] > 0).float()
        _, t_min, _ = (x.reshape(shape) for x in plain.ray_interval(
            rays.reshape(-1, 3), pose))
        state = dict(zip(plain.WARM_OUTPUTS[1:], outs[1:]), hit=hit,
                     t0=t_min, macc=torch.zeros(shape, device=dev))
        pose = _mug_pose(dev, dp=(1e-3, -6e-4, 8e-4))
        t_init, skip, _ = warm.warm_inputs(
            state, rays, pose, torch.tensor(3e-3, device=dev), False, 0.005)
        assert int(skip.sum()) > 1000 and int((t_init >= 0).sum()) > 1000
    kernels.reset_launches()
    got = kernels.march_warm(sdf, rays, pose, t_init, skip, 0.005, 500)
    torch.cuda.synchronize()
    assert kernels.march_warm.launches == 1
    want = [x.reshape(shape) for x in plain.march_warm_plain(
        sdf, rays.reshape(-1, 3), pose, t_init.reshape(-1),
        skip.reshape(-1), 0.005, 500)]
    _depth_bar(got[0], want[0])
    agree = (got[0] > 0) == (want[0] > 0)
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w)[agree].abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("culling", [True, False])
def test_relaxed_march_matches_plain_twin(dev, mug, culling):
    sdf, cam = mug
    rays = api.ray_set(cam, dev).march
    pose = _mug_pose(dev)
    got = kernels.march(sdf, rays, pose, 0.005, 500, culling, True,
                        relaxation=1.5)
    want = plain.march_plain(sdf, rays.reshape(-1, 3), pose, 0.005, 500,
                             culling, True, relaxation=1.5)
    _depth_bar(got, want.reshape(rays.shape[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("relaxation", [1.0, 1.5])
def test_bf16_march_matches_plain_twin(dev, mug, relaxation):
    """The bf16-verified march (culling; relaxation 1 and 1.5) at 640x480
    on the decoded mug: the march's bar against its twin, one launch of a
    bf16 instance; with culling off bf16 is the fp32 march bit for bit."""
    sdf, cam = mug
    rays = api.ray_set(cam, dev).march
    pose = _mug_pose(dev)
    kernels.reset_launches()
    got = kernels.march(sdf, rays, pose, 0.005, 500, True, True,
                        relaxation=relaxation, bf16=True)
    torch.cuda.synchronize()
    assert kernels.march.bf16_launches == 1 == kernels.march.launches
    want = plain.march_plain(sdf, rays.reshape(-1, 3), pose, 0.005, 500, True,
                             True, relaxation=relaxation, bf16=True)
    _depth_bar(got, want.reshape(rays.shape[:2]))
    no_cull = kernels.march(sdf, rays, pose, 0.005, 500, False, False,
                            relaxation=relaxation, bf16=True)
    assert kernels.march.bf16_launches == 1
    assert torch.equal(no_cull, kernels.march(sdf, rays, pose, 0.005, 500,
                                              False, False,
                                              relaxation=relaxation))


MARCHES = {  # instance: (culling, adaptive, relaxation, bf16)
    "culling_adaptive": (True, True, 1.0, False),
    "culling_no_adaptive": (True, False, 1.0, False),
    "relaxed_culling": (True, True, 1.5, False),
    "relaxed_no_culling": (False, True, 1.5, False),
    "bf16_culling": (True, True, 1.0, True),
    "bf16_relaxed": (True, True, 1.5, True),
}


def _march_case(dev, cam, case):
    """Rays and pose of one launch shape: ragged crops of the 640x480 frame
    around the mug, the flat (N, 3) frame, an all-miss pose (the mug behind
    the camera) and a pose whose box fills the frame."""
    full = api.ray_set(cam, dev).march
    pose = _mug_pose(dev)
    if case == "ragged_37x53":
        return full[228:265, 306:359].contiguous(), pose
    if case == "ragged_1x200":
        return full[246:247, 233:433].contiguous(), pose
    if case == "flat":
        return full.reshape(-1, 3), pose
    if case == "all_miss":
        return full, _mug_pose(dev, dp=(0.0, 0.0, 1.0))
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    return full, kernels.pose_params(torch.tensor([0.0, 0.0, -0.15], device=dev),
                                     q, torch.tensor(10.0, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_37x53", "ragged_1x200", "flat",
                                  "all_miss", "fills_frame"])
@pytest.mark.parametrize("instance", list(MARCHES))
def test_tiled_march_equals_its_twin_bit_for_bit(dev, mug, instance, case):
    """Every instance of march_kernel equals its CUDA twin bit for bit on
    ragged rasters, a flat ray set, an all-miss pose (zeros) and a pose
    where every tile meets the box."""
    sdf, cam = mug
    culling, adaptive, relaxation, bf16 = MARCHES[instance]
    rays, pose = _march_case(dev, cam, case)
    flat = rays.reshape(-1, 3)
    hit, t_min, t_max = plain.ray_interval(flat, pose)
    marches = hit & (t_min < t_max)
    if case == "all_miss":
        assert not bool(marches.any())
    elif case == "fills_frame":
        assert bool(marches.all())
    else:
        assert int(marches.sum()) > min(flat.shape[0] // 4, 1000)
    want = plain.march_plain(sdf, flat, pose, 0.005, 500, culling, adaptive,
                             relaxation=relaxation, bf16=bf16).reshape(
                                 rays.shape[:-1])
    if case != "all_miss":
        assert int((want > 0).sum()) > 0
    kernels.reset_launches()
    got = kernels.march(sdf, rays, pose, 0.005, 500, culling, adaptive,
                        relaxation=relaxation, bf16=bf16)
    torch.cuda.synchronize()
    assert kernels.march.launches == 1
    assert kernels.march.bf16_launches == int(bf16)
    assert torch.equal(got, want), float((got - want).abs().max())


def _one_cell(g, res, m, n):
    """``n`` rows in random order, ``m`` of them with a cotangent and all
    in base cell 40 of each axis at ``res``: 8 cells of ``m``
    contributions each."""
    pts = torch.rand(n, 3, generator=g) * 2.0 - 1.0
    cot = torch.zeros(n)
    rows = torch.randperm(n, generator=g)[:m]
    pts[rows] = -1.0 + (40.25 + 0.5 * torch.rand(m, 3, generator=g)) * (
        2.0 / (res - 1))
    cot[rows] = torch.randn(m, generator=g)
    return pts, cot


def _dense_queries(dev, mug, distance):
    """The fused backward's rows at 640x480 with the mug at ``distance`` m
    straight ahead (the surrogate queries of a render at a moved pose and
    the observed cloud's pc queries), seeded cotangents on the active
    rows."""
    from sdfest_torch.ops import pointset

    sdf, cam = mug
    rays = api.ray_set(cam, dev)
    g = torch.Generator().manual_seed(12)
    q = torch.tensor([0.25, 0.35, 0.1, 0.895])
    obs = kernels.march(sdf, rays.march, kernels.pose_params(
        torch.tensor([0.0, 0.0, -distance], device=dev),
        (q / q.norm()).to(dev), torch.tensor(10.0, device=dev)), 0.005, 500)
    points, pmask = pointset.depth_to_pointcloud_dense(obs, cam,
                                                       order="tile")
    d = 0.01 * torch.randn(8, generator=g)
    pos = (torch.tensor([0.0, 0.0, -distance]) + d[:3]).to(dev)
    q = ((q + d[3:7]) / (q + d[3:7]).norm()).to(dev)
    inv_s = torch.tensor(1.0 / (0.1 * (1 + float(d[7]))), device=dev)
    depth = kernels.march(sdf, rays.march, kernels.pose_params(pos, q, inv_s),
                          0.005, 500)
    sur, sur_m, _ = api._surrogate_queries(pos, q, inv_s, depth, rays)
    obj, pc_m = api._pc_object_points(pos, q, inv_s, points, pmask,
                                      sdf.shape[0])
    m = torch.cat([sur_m.float(), pc_m.float()])
    cot = torch.randn(m.shape[0], generator=g).to(dev) * m
    return torch.cat([sur, obj]).contiguous(), cot.contiguous()


def _scatter_case(dev, mug, case, res=64):
    """Points and cotangents of one scatter input."""
    g = torch.Generator().manual_seed(7)
    if case == "single_cell_614400":  # every row in one base cell: 8 cells
        # of 614,400 contributions, past any block's shared memory
        pts, cot = _one_cell(g, res, 614_400, 614_400)
        return pts.to(dev), cot.to(dev)
    if case.startswith("cell_"):  # one base cell of m active rows among
        # m + 1,000: the sizes around each of the gather's thresholds
        m = int(case.split("_")[1])
        pts, cot = _one_cell(g, res, m, m + 1000)
        return pts.to(dev), cot.to(dev)
    if case == "dense_0.12m":  # the mug filling the frame (longest chains
        # ~1,800)
        return _dense_queries(dev, mug, 0.12)
    if case == "zeros":
        pts = torch.rand(614_400, 3, generator=g) * 2.0 - 1.0
        return pts.to(dev), torch.zeros(614_400, device=dev)
    if case == "one_cell":  # 4,096 rows in base cell 40 of each axis (res
        # 64; two cells per axis at res 63)
        pts = -1.0 + (40.25 + 0.5 * torch.rand(4096, 3, generator=g)) * (
            2.0 / 63.0)
        return pts.to(dev), torch.randn(4096, generator=g).to(dev)
    if case == "dense_box":  # 100,000 rows in 3 cells per axis: 8 buckets
        # of ~3,700 rows each meet in every inner cell, finely interleaved
        pts = -1.0 + (40.0 + 3.0 * torch.rand(100_000, 3, generator=g)) * (
            2.0 / 63.0)
        return pts.to(dev), torch.randn(100_000, generator=g).to(dev)
    if case.startswith("ragged_"):  # n neither a multiple of 32 nor 256
        n = int(case.split("_")[1])
        pts = torch.rand(n, 3, generator=g) * 2.2 - 1.1
        cot = torch.randn(n, generator=g) * (torch.rand(n, generator=g) < 0.5)
        return pts.to(dev), cot.to(dev)
    # the realistic set: the mug's observed cloud in 16x16 tile order, in
    # the object frame of a slightly moved pose, cotangents on its rows
    from sdfest_torch.ops import pointset

    sdf, cam = mug
    pose = _mug_pose(dev)
    depth = kernels.march(sdf, api.ray_set(cam, dev).march, pose, 0.005, 500)
    points, pmask = pointset.depth_to_pointcloud_dense(depth, cam,
                                                       order="tile")
    q = torch.tensor([0.25, 0.35, 0.1, 0.895], device=dev)
    obj, valid = api._pc_object_points(
        torch.tensor([0.021, -0.01, -0.5], device=dev), q / q.norm(),
        torch.tensor(1.0 / 0.1, device=dev), points, pmask, sdf.shape[0])
    cot = torch.randn(obj.shape[0], generator=g).to(dev) * valid
    assert int(valid.sum()) > 3000
    return obj.contiguous(), cot.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("res", [64, 63])
@pytest.mark.parametrize("case", [
    "zeros", "one_cell", "dense_box", "ragged_1000", "ragged_4099",
    "tile_ordered", "single_cell_614400", "dense_0.12m",
    *[f"cell_{m}" for m in (31, 32, 33, 64, 65, 128, 129, 256, 257, 4095,
                            4096, 4097, 8192, 8193)]])
def test_aggregated_scatter_matches_plain_twin(dev, mug, case, res):
    """The scatter equals scatter_plain on CPU copies of its inputs bit for
    bit (each cell adds its rows in increasing row index, without float
    atomics), on a grid of even and of odd res, in one launch; all-zero
    cotangents give exact zeros.  The cases reach every path of the
    gather: groups of lanes for up to 8, 16 or 32 contributions, a warp's
    windows for up to 64, 128 or 256, a block's for up to 4,096 and its
    narrower windows beyond, a big bucket (more than 4,096 rows) sorted in
    place, and one base cell of 614,400 rows."""
    pts, cot = _scatter_case(dev, mug, case, res)
    kernels.reset_launches()
    got = kernels.scatter(pts, cot, res)
    torch.cuda.synchronize()
    assert kernels.scatter.launches == 1
    want = kernels.scatter_plain(pts.cpu(), cot.cpu(), res)
    assert torch.equal(got.cpu(), want), float((got.cpu() - want).abs().max())
    if case == "zeros":
        assert not bool(got.any())
    else:
        assert float(want.abs().max()) > 0


def _main_path_queries(dev, mug, n_hyp):
    """``n_hyp`` sets of the fused backward's rows at 640x480: the
    surrogate queries of a render at a moved pose and the observed cloud's
    pc queries, concatenated, with seeded cotangents on the active rows."""
    from sdfest_torch.ops import pointset

    sdf, cam = mug
    rays = api.ray_set(cam, dev)
    g = torch.Generator().manual_seed(11)
    obs = kernels.march(sdf, rays.march, _mug_pose(dev), 0.005, 500)
    points, pmask = pointset.depth_to_pointcloud_dense(obs, cam,
                                                       order="tile")
    pts, cots = [], []
    for _ in range(n_hyp):
        d = 0.01 * torch.randn(8, generator=g)
        pos = torch.tensor([0.021, -0.01, -0.5]) + d[:3]
        q = torch.tensor([0.25, 0.35, 0.1, 0.895]) + d[3:7]
        pos, q = pos.to(dev), (q / q.norm()).to(dev)
        inv_s = torch.tensor(1.0 / (0.1 * (1 + float(d[7]))), device=dev)
        depth = kernels.march(sdf, rays.march,
                              kernels.pose_params(pos, q, inv_s), 0.005, 500)
        sur, sur_m, _ = api._surrogate_queries(pos, q, inv_s, depth, rays)
        obj, pc_m = api._pc_object_points(pos, q, inv_s, points, pmask,
                                          sdf.shape[0])
        m = torch.cat([sur_m.float(), pc_m.float()])
        pts.append(torch.cat([sur, obj]))
        cots.append(torch.randn(m.shape[0], generator=g).to(dev) * m)
    return (torch.stack(pts).contiguous(), torch.stack(cots).contiguous())


@pytest.mark.cuda
def test_scatter_repeats_and_batches_bit_for_bit(dev, mug):
    """On 8 sets of the main path's backward rows (2 x 640 x 480 each): one
    launch of 8 hypotheses equals the 8 launches of one and scatter_plain on
    CPU copies bit for bit, and 20 repeated launches of one set are
    identical."""
    pts, cot = _main_path_queries(dev, mug, 8)
    assert pts.shape[1] == 2 * 640 * 480
    assert all(int((c != 0).sum()) > 3000 for c in cot)
    kernels.reset_launches()
    batched = kernels.scatter(pts, cot, 64)
    torch.cuda.synchronize()
    assert (kernels.scatter.launches, kernels.scatter.hypotheses) == (1, 8)
    for b in range(8):
        assert torch.equal(batched[b], kernels.scatter(pts[b], cot[b], 64))
    assert torch.equal(batched.cpu(), kernels.scatter_plain(
        pts.cpu(), cot.cpu(), 64))
    first = kernels.scatter(pts[0], cot[0], 64)
    for _ in range(20):
        assert torch.equal(kernels.scatter(pts[0], cot[0], 64), first)


@pytest.mark.cuda
def test_bf16_warm_march_matches_plain_twin(dev, mug):
    """The bf16 warm/aux march, cold, at 640x480 on the decoded mug."""
    sdf, cam = mug
    rays = api.ray_set(cam, dev).march
    shape = rays.shape[:2]
    t_init = torch.full(shape, -1.0, device=dev)
    skip = torch.zeros(shape, device=dev)
    pose = _mug_pose(dev)
    kernels.reset_launches()
    got = kernels.march_warm(sdf, rays, pose, t_init, skip, 0.005, 500,
                             bf16=True)
    torch.cuda.synchronize()
    assert kernels.march_warm.bf16_launches == 1
    want = [x.reshape(shape) for x in plain.march_warm_plain(
        sdf, rays.reshape(-1, 3), pose, t_init.reshape(-1), skip.reshape(-1),
        0.005, 500, bf16=True)]
    _depth_bar(got[0], want[0])
    agree = (got[0] > 0) == (want[0] > 0)
    for g, w in zip(got[1:], want[1:]):
        assert float((g - w)[agree].abs().max()) < 1e-4


def _warm_case(dev, mug, case):
    """Rays, pose, t_init and skip of one warm-march launch: the march's
    launch shapes, cold; every ray of the frame skipped; and the inputs of
    a real warm step (a cold render, then a small move)."""
    from sdfest_torch.render import warm

    sdf, cam = mug
    if case not in ("all_skip", "mid_refinement"):
        rays, pose = _march_case(dev, cam, case)
        shape = rays.shape[:-1]
        return (rays, pose, torch.full(shape, -1.0, device=dev),
                torch.zeros(shape, device=dev))
    rays = api.ray_set(cam, dev).march
    shape = rays.shape[:2]
    t_init = torch.full(shape, -1.0, device=dev)
    pose = _mug_pose(dev)
    if case == "all_skip":
        return rays, pose, t_init, torch.ones(shape, device=dev)
    outs = kernels.march_warm(sdf, rays, pose, t_init,
                              torch.zeros(shape, device=dev), 0.005, 500)
    _, t_min, _ = (x.reshape(shape) for x in plain.ray_interval(
        rays.reshape(-1, 3), pose))
    state = dict(zip(plain.WARM_OUTPUTS[1:], outs[1:]),
                 hit=(outs[0] > 0).float(), t0=t_min,
                 macc=torch.zeros(shape, device=dev))
    pose = _mug_pose(dev, dp=(1e-3, -6e-4, 8e-4))
    t_init, skip, _ = warm.warm_inputs(
        state, rays, pose, torch.tensor(3e-3, device=dev), False, 0.005)
    assert int(skip.sum()) > 1000 and int((t_init >= 0).sum()) > 1000
    return rays, pose, t_init.contiguous(), skip.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_37x53", "ragged_1x200", "flat",
                                  "all_miss", "fills_frame", "all_skip",
                                  "mid_refinement"])
@pytest.mark.parametrize("bf16", [False, True])
def test_tiled_warm_march_equals_its_twin_bit_for_bit(dev, mug, bf16, case):
    """Both instances of march_warm_kernel equal their CUDA twin in all six
    outputs bit for bit: on the march's launch shapes (cold), on a frame
    where every ray is skipped and on mid-refinement inputs.  Where no ray
    marches, depth, v0, min_dip and v_last are 0 and t == t_last == t0."""
    sdf, _ = mug
    rays, pose, t_init, skip = _warm_case(dev, mug, case)
    flat = rays.reshape(-1, 3)
    kernels.reset_launches()
    got = kernels.march_warm(sdf, rays, pose, t_init, skip, 0.005, 500,
                             bf16=bf16)
    torch.cuda.synchronize()
    assert kernels.march_warm.launches == 1
    assert kernels.march_warm.bf16_launches == int(bf16)
    want = plain.march_warm_plain(sdf, flat, pose, t_init.reshape(-1),
                                  skip.reshape(-1), 0.005, 500, bf16=bf16)
    for name, g, w in zip(plain.WARM_OUTPUTS, got, want):
        w = w.reshape(g.shape)
        assert torch.equal(g, w), (name, float((g - w).abs().max()))
    if case in ("all_miss", "all_skip"):
        _, t0, _ = plain.ray_interval(flat, pose)
        t0 = t0.reshape(got[0].shape)
        for x in (got[0], got[2], got[3], got[4]):
            assert not bool(x.any())
        assert torch.equal(got[1], t0) and torch.equal(got[5], t0)
    else:
        assert int((got[0] > 0).sum()) > 0


def _sample_case(dev, mug, case):
    """Points and mask of one sampler input: the mug's observed cloud in
    tile order in the object frame of a slightly moved pose, with its
    validity as the mask (the main path), all-zero, all-one and non-binary
    masks, a row count that is not a multiple of 4, and views whose base is
    one or two rows past the tensor's (4 or 8 bytes past a 16-byte
    boundary)."""
    pts, valid = _scatter_case(dev, mug, "tile_ordered")
    valid = (valid != 0).float()
    g = torch.Generator().manual_seed(8)
    if case == "zeros":
        return pts, torch.zeros_like(valid)
    if case == "ones":  # every row, in the volume or not
        return pts, torch.ones_like(valid)
    if case == "non_binary":
        return pts, (valid * torch.rand(valid.shape[0], generator=g).to(dev)
                     - 0.25 * (torch.rand(valid.shape[0], generator=g) < 0.01
                               ).float().to(dev)).contiguous()
    if case == "ragged_4099":  # from a 16-byte boundary before the object
        start = int(valid.nonzero()[0]) // 4 * 4
        return pts[start:start + 4099], valid[start:start + 4099]
    if case == "offset_1":
        return pts[1:], valid[1:]
    if case == "offset_2_ragged":
        return pts[2:-1], valid[2:-1]
    return pts, valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main_path", "zeros", "ones", "non_binary",
                                  "ragged_4099", "offset_1",
                                  "offset_2_ragged"])
def test_sampler_equals_its_twin_bit_for_bit(dev, mug, case):
    """The sample kernel (one row per thread, the point loaded with the
    mask) equals sample_plain bit for bit on every input."""
    sdf, _ = mug
    pts, mask = _sample_case(dev, mug, case)
    assert pts.is_contiguous() and mask.is_contiguous()
    if case.startswith("offset"):
        assert mask.data_ptr() % 16 and pts.data_ptr() % 16
    kernels.reset_launches()
    got = kernels.sample(sdf, pts, mask)
    torch.cuda.synchronize()
    assert kernels.sample.launches == 1
    want = kernels.sample_plain(sdf, pts, mask)
    assert torch.equal(got, want), float((got - want).abs().max())
    if case == "zeros":
        assert not bool(got.any())
    else:
        assert bool(got.any())


# ---------------------------------------------------------------------------
# hypotheses: one launch for a batch equals one launch per hypothesis
# ---------------------------------------------------------------------------


def _hypotheses(dev, mug):
    """Four hypotheses on the 640x480 mug: their grids (B, R, R, R) and
    poses (B, 14); hypothesis 2 has the mug behind the camera (it misses
    the frame) beside three that hit."""
    sdf, _ = mug
    grids = torch.stack([sdf, sdf * 1.02 + 1e-3, sdf, sdf * 0.98])
    poses = torch.stack([
        _mug_pose(dev), _mug_pose(dev, dp=(0.01, -0.005, 0.02), scale=0.11),
        _mug_pose(dev, dp=(0.0, 0.0, 1.0)),
        _mug_pose(dev, dp=(-0.01, 0.01, -0.02), scale=0.09)])
    return grids.contiguous(), poses.contiguous()


def _hyp_rays(dev, cam, case):
    full = api.ray_set(cam, dev).march
    if case == "frame":
        return full
    if case == "roi":
        return api.ray_set(cam, dev, (240, 320),
                           torch.tensor([120, 160], device=dev)).march
    if case == "strided":
        return api.ray_set(cam.strided(2), dev).march
    return full.reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["frame", "roi", "strided", "flat"])
@pytest.mark.parametrize("instance", list(MARCHES) + ["plain"])
def test_batched_march_equals_unbatched_launches(dev, mug, instance, case):
    """Every march instance: one launch of a batch of 4 hypotheses (one
    missing the frame) equals 4 launches of one, and the batched twin, bit
    for bit, on the frame, an ROI crop, a strided raster and a flat set."""
    culling, adaptive, relaxation, bf16 = MARCHES.get(
        instance, (False, False, 1.0, False))
    kw = dict(relaxation=relaxation, bf16=bf16)
    grids, poses = _hypotheses(dev, mug)
    rays = _hyp_rays(dev, mug[1], case)
    kernels.reset_launches()
    got = kernels.march(grids, rays, poses, 0.005, 500, culling, adaptive,
                        **kw)
    torch.cuda.synchronize()
    assert kernels.march.launches == 1 and kernels.march.hypotheses == 4
    assert got.shape == (4, *rays.shape[:-1])
    for b in range(4):
        want = kernels.march(grids[b], rays, poses[b], 0.005, 500, culling,
                             adaptive, **kw)
        assert torch.equal(got[b], want), (b, float((got[b] - want).abs()
                                                    .max()))
    twin = plain.march_plain(grids, rays.reshape(-1, 3), poses, 0.005, 500,
                             culling, adaptive, **kw)
    assert torch.equal(got.reshape(4, -1), twin)
    assert not bool(got[2].any()) and int((got[0] > 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", ["cold", "mid_refinement", "all_skip"])
def test_batched_warm_march_equals_unbatched_launches(dev, mug, case, bf16):
    """The warm march of 4 hypotheses (one missing the frame) with their
    own t_init/skip: one launch equals 4 launches of one and the batched
    twin, all six outputs bit for bit."""
    from sdfest_torch.render import warm

    sdf, cam = mug
    grids, poses = _hypotheses(dev, mug)
    rays = api.ray_set(cam, dev).march
    shape = (4, *rays.shape[:2])
    t_init = torch.full(shape, -1.0, device=dev)
    skip = torch.zeros(shape, device=dev)
    if case == "all_skip":
        skip = torch.ones(shape, device=dev)
    elif case == "mid_refinement":
        outs = kernels.march_warm(grids, rays, poses, t_init, skip, 0.005,
                                  500)
        _, t_min, _ = (x.reshape(shape) for x in plain.ray_interval(
            rays.reshape(-1, 3), poses))
        state = dict(zip(plain.WARM_OUTPUTS[1:], outs[1:]),
                     hit=(outs[0] > 0).float(), t0=t_min,
                     macc=torch.zeros(shape, device=dev))
        moved = poses.clone()
        moved[:, 9:12] += torch.tensor([1e-3, -6e-4, 8e-4], device=dev)
        t_init, skip, _ = warm.warm_inputs(
            state, rays, moved, torch.full((4,), 3e-3, device=dev), False,
            0.005)
        poses = moved
        assert int(skip.sum()) > 1000 and int((t_init >= 0).sum()) > 1000
    t_init, skip = t_init.contiguous(), skip.contiguous()
    kernels.reset_launches()
    got = kernels.march_warm(grids, rays, poses, t_init, skip, 0.005, 500,
                             bf16=bf16)
    torch.cuda.synchronize()
    assert kernels.march_warm.launches == 1
    assert kernels.march_warm.hypotheses == 4
    twin = plain.march_warm_plain(grids, rays.reshape(-1, 3), poses,
                                  t_init.reshape(4, -1),
                                  skip.reshape(4, -1), 0.005, 500, bf16=bf16)
    for b in range(4):
        want = kernels.march_warm(grids[b], rays, poses[b], t_init[b],
                                  skip[b], 0.005, 500, bf16=bf16)
        for g, w in zip(got, want):
            assert torch.equal(g[b], w)
    for g, w in zip(got, twin):
        assert torch.equal(g.reshape(4, -1), w)
    assert not bool(got[0][2].any())


@pytest.mark.cuda
def test_batched_samplers_and_scatter_equal_unbatched_launches(dev, mug):
    """Sample, sample-grad and the scatter of 4 hypotheses: one launch
    equals 4 launches of one bit for bit, one launch each."""
    grids, _ = _hypotheses(dev, mug)
    g = torch.Generator().manual_seed(9)
    n = 307_200
    pts = (torch.rand(4, n, 3, generator=g) * 2.2 - 1.1).to(dev)
    mask = (torch.rand(4, n, generator=g) < 0.1).float().to(dev)
    cot = (torch.randn(4, n, generator=g).to(dev) * mask).contiguous()
    kernels.reset_launches()
    value = kernels.sample(grids, pts, mask)
    v, gr = kernels.sample_grad(grids, pts, mask)
    acc = kernels.scatter(pts, cot, 64)
    torch.cuda.synchronize()
    for name in ("sample", "sample_grad", "scatter"):
        assert kernels.KERNELS[name].launches == 1
        assert kernels.KERNELS[name].hypotheses == 4
    for b in range(4):
        assert torch.equal(value[b], kernels.sample(grids[b], pts[b],
                                                    mask[b]))
        want_v, want_g = kernels.sample_grad(grids[b], pts[b], mask[b])
        assert torch.equal(v[b], want_v) and torch.equal(gr[b], want_g)
        assert torch.equal(acc[b], kernels.scatter(pts[b], cot[b], 64))


# ---------------------------------------------------------------------------
# slice 9: training
# ---------------------------------------------------------------------------


def _mug_vae(dev):
    """The committed mug VAE (encoder and decoder) on ``dev``."""
    from sdfest_torch.models.vae import create_vae_from_config
    from sdfest_torch.utils import msgpack_reader, weights
    from sdfest_torch.utils.presets import preset

    vae = create_vae_from_config(preset("vae_mug_procedural"))
    weights.load_flax_into(vae, msgpack_reader.load(
        "trained_models/mug_procedural/mug_procedural.msgpack"))
    return vae.to(dev)


def _decoded_mugs(dev, n):
    vae = _mug_vae(dev)
    latent = torch.randn(n, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        return vae.decoder(0.7 * latent.to(dev)).contiguous()


@pytest.mark.cuda
def test_pc_loss_sample_op_on_distinct_grids_matches_plain(dev):
    """The VAE trainer's pc loss on 8 distinct grids, each rendered from its
    own orientation at 640x480: one march, one sample-grad forward and one
    scatter backward; the values within 1e-5 of the sample-grad twin, the
    grid gradient within the scatter's 1e-3 * max(1, max|want|)."""
    from sdfest_torch.ops import quaternion
    from sdfest_torch.training.vae_trainer import VAETrainer
    from sdfest_torch.utils.presets import preset

    trainer = VAETrainer(preset("vae_mug_procedural"), device=dev)
    x = _decoded_mugs(dev, 8)
    quats = quaternion.random_uniform(
        (8,), torch.Generator().manual_seed(2)).to(dev)
    recon = x.clone().requires_grad_(True)
    kernels.reset_launches()
    depth = trainer.pc_depth(x, quats)
    loss = trainer.pc_loss(recon, depth, quats)
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.launches() == {"march": 1, "march_warm": 0, "sample": 0,
                                  "sample_grad": 1, "scatter": 1}
    assert kernels.hypotheses()["scatter"] == 8
    assert int((depth > 0).sum()) > 8 * 5000
    # the plain versions on the same rows
    from sdfest_torch.ops import pointset
    from sdfest_torch.ops.interpolation import _base_and_frac

    points, valid = pointset.depth_to_pointcloud_dense(depth, trainer.camera)
    q = quaternion.invert(quaternion.normalize(quats))[:, None, :]
    obj = quaternion.apply(q, points - points.new_tensor([0.0, 0.0, -5.0]))
    _, _, inside = _base_and_frac(obj, 64)
    mask = (inside & valid).float()
    value, _ = kernels.sample_grad_plain(x[:, 0], obj, mask)
    total = float(loss.detach())
    assert abs(total - float((value ** 2).sum())) <= 1e-5 * total
    want = kernels.scatter_plain(obj, 2 * value * mask, 64)
    err = float((recon.grad[:, 0] - want).abs().max())
    assert err <= 1e-3 * max(1.0, float(want.abs().max())), err


@pytest.mark.cuda
def test_generated_views_march_b16_320x240_matches_plain(dev):
    """The init trainer's generation batch: 16 decoded grids, 16 poses, one
    march launch at 320x240, bit for bit its CUDA twin."""
    from sdfest_torch.datasets.generated import SDFVAEViewDataset
    from sdfest_torch.render.api import _posed
    from sdfest_torch.utils.presets import preset

    cfg = dict(preset("init_mug_procedural_v3")["datasets"][
        "generated_dataset"]["config_dict"], orientation_repr="discretized",
        orientation_grid_resolution=1)
    ds = SDFVAEViewDataset(cfg, _mug_vae(dev).decoder, device=dev)
    draws = ds.draw(16, torch.Generator(device=dev).manual_seed(3))
    kernels.reset_launches()
    depth = ds.render(draws)
    torch.cuda.synchronize()
    assert kernels.launches()["march"] == 1
    assert depth.shape == (16, 240, 320) and int((depth > 0).sum()) > 16 * 500
    with torch.no_grad():
        sdf = ds.decoder(draws["latent"])[:, 0].contiguous()
    grid, pos, quat, inv = _posed(sdf, ds.position(draws),
                                  draws["quaternion"], 1.0 / draws["scale"],
                                  dev)
    twin = plain.march_plain(grid, plain.pixel_directions(ds.camera, dev),
                             kernels.pose_params(pos, quat, inv),
                             cfg["render_threshold"], 500, True, True)
    assert torch.equal(depth.reshape(16, -1), twin)
    batch = ds.views_from_depth(depth, draws)
    assert batch["pointset"].shape == (16, 2500, 3)
    assert bool(torch.isfinite(batch["pointset"]).all())


@pytest.mark.cuda
def test_encoder_and_its_gradients_run_in_fp32_with_tf32_allowed(dev):
    """With cuDNN's TF32 switch allowed, the encoder on the card equals the
    CPU's within 1e-5, and a training step's weight gradients (the
    reconstruction loss, the backward's convolutions included) within 1e-4
    of each weight's largest gradient (TF32 would part them by ~1e-3)."""
    from sdfest_torch.models.vae import fp32_convolutions
    from sdfest_torch.training.vae_trainer import VAETrainer
    from sdfest_torch.utils import msgpack_reader, weights
    from sdfest_torch.utils.presets import preset

    x = _decoded_mugs(dev, 2)
    eps = torch.randn(2, 8, generator=torch.Generator().manual_seed(4))
    grads = {}
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for device in ("cpu", dev):
            t = VAETrainer(dict(preset("vae_mug_procedural"), pc_weight=0.0),
                           device=device)
            weights.load_flax_into(t.vae, msgpack_reader.load(
                "trained_models/mug_procedural/mug_procedural.msgpack"))
            with torch.no_grad():
                grads[device, "means"] = t.vae.encode_mean(
                    x.to(device))[0].cpu()
            with fp32_convolutions():
                loss, _ = t.loss(x.to(device), 5, eps=eps.to(device))
                loss.backward()
            for k, p in t.vae.named_parameters():
                grads[device, k] = p.grad.cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = before
    err = float((grads[dev, "means"] - grads["cpu", "means"]).abs().max())
    assert err <= 1e-5, f"encoder on the card: max|d| {err:.3e} (tol 1e-5)"
    for (device, k), want in grads.items():
        if device == "cpu" and k != "means":
            got = grads[dev, k]
            assert float((got - want).abs().max()) <= 1e-4 * float(
                want.abs().max()), k


@pytest.mark.cuda
def test_training_batchnorm_on_card_matches_float64_cpu(dev):
    """The init network's training-mode BatchNorm on the card (PyTorch's
    fused batch-norm forward and backward on the flax statistics) against
    the same layer in float64 on the CPU, at a backbone's shape: output
    within 1e-5, gradients within 1e-5 of each one's largest, running
    statistics within 1e-6."""
    from sdfest_torch.models.pointnet import BatchNorm

    g = torch.Generator().manual_seed(11)
    x = 0.5 + 2.0 * torch.randn(16384, 128, generator=g)
    dy = torch.randn(16384, 128, generator=g)
    out = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        bn = BatchNorm(128).to(device=device, dtype=dtype).train()
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 128))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, 128))
        tx = x.to(device=device, dtype=dtype, copy=True).requires_grad_()
        y = bn(tx)
        y.backward(dy.to(device=device, dtype=dtype))
        out[device == "cpu"] = [t.detach().double().cpu() for t in (
            y, tx.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var)]
    card, want = out[False], out[True]
    assert float((card[0] - want[0]).abs().max()) <= 1e-5
    for got, ref in zip(card[1:4], want[1:4]):
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    for got, ref in zip(card[4:], want[4:]):
        assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [True, False])
def test_march_on_a_nocs_like_camera_equals_plain_twin(dev, flags):
    """A NOCS-like camera (``pixel_center`` 0, an off-centre principal
    point, fx != fy): the march through ``render_depth`` equals its plain
    version bit for bit."""
    cam = Camera(width=96, height=72, fx=88.65, fy=88.53, cx=48.38,
                 cy=36.62, pixel_center=0)
    sdf = _box_sdf().to(dev)
    q = torch.tensor([0.2, 0.1, 0.0, 0.97], device=dev)
    q = q / q.norm()
    pos = torch.tensor([0.02, -0.03, -0.6], device=dev)
    inv_s = torch.tensor(1 / 0.2, device=dev)
    depth = api.render_depth(sdf, pos, q, inv_s, camera=cam, threshold=0.005,
                             culling=flags, adaptive=flags, device=dev)
    rays = api.ray_set(cam, dev).march
    want = plain.march_plain(sdf, rays.reshape(-1, 3),
                             kernels.pose_params(pos, q, inv_s), 0.005, 500,
                             flags, flags).reshape(depth.shape)
    assert int((want > 0).sum()) > 300
    assert torch.equal(depth, want)


# ---------------------------------------------------------------------------
# the pipeline's captured graphs (sdfest_torch/utils/graphs.py)
# ---------------------------------------------------------------------------

GRAPH_CAMERA = dict(width=128, height=96, fx=64, fy=64, cx=64, cy=48,
                    pixel_center=0.5)
GRAPH_PRESETS = {"full_frame": ("mug_procedural", {}),
                 "fast": ("mug_procedural_fast", dict(roi_margin=16)),
                 "temporal": ("mug_procedural_temporal", {})}


def _graph_pipe(dev, name, **overrides):
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.utils.presets import preset

    config = preset(name)
    config.update(camera=dict(GRAPH_CAMERA), max_iterations=6, **overrides)
    return SDFPipeline(config, device=dev)


def _observation(pipe, shift=0.0):
    """Depth of a decoded mug at a tilted pose (``shift`` moves it
    sideways)."""
    g = torch.Generator().manual_seed(0)
    latent = (0.5 * torch.randn(1, 8, generator=g)).to(pipe.device)
    q = torch.tensor([0.17, 0.30, 0.09, 0.93], device=pipe.device)
    with torch.no_grad():
        sdf = pipe._decode(latent)[0, 0]
        return api.render_depth(
            sdf, torch.tensor([0.02 + shift, -0.01, -0.5],
                              device=pipe.device),
            q / q.norm(), 10.0, camera=pipe.camera, threshold=0.005,
            device=pipe.device)


def _counted_call(pipe, depth, **kwargs):
    kernels.reset_launches()
    out = pipe(depth, depth > 0, **kwargs)
    torch.cuda.synchronize()
    return out, {k: v.clone() for k, v in pipe.last_log.items()}, dict(
        kernels.counts())


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(GRAPH_PRESETS))
def test_graph_call_equals_eager_bit_for_bit_without_shape_optimization(
        dev, path):
    """Without shape optimization no launch adds in a varying order (the
    scatter is not launched), so the graph call equals the eager loop bit
    for bit at every iteration, with the same launch counts; a second call
    of the same shapes replays without capturing again."""
    from sdfest_torch.utils import graphs

    name, overrides = GRAPH_PRESETS[path]
    pipe = _graph_pipe(dev, name, **overrides)
    depth = _observation(pipe)
    with graphs.eager():
        want, want_log, want_counts = _counted_call(
            pipe, depth, shape_optimization=False)
    assert len(pipe.graphs) == 0
    got, log, counts = _counted_call(pipe, depth, shape_optimization=False)
    assert pipe.graphs.captures == 1 and pipe.graphs.replays == 1
    assert counts == want_counts and counts["launches"]["scatter"] == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in want_log:
        assert torch.equal(log[k], want_log[k]), k
    again, _, counts = _counted_call(pipe, depth, shape_optimization=False)
    assert pipe.graphs.captures == 1 and pipe.graphs.replays == 2
    assert counts == want_counts
    for g, w in zip(again, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(GRAPH_PRESETS))
def test_graph_call_with_shape_optimization_starts_as_eager(dev, path):
    """With shape optimization too no sum depends on the order blocks run
    in (the scatter's fixed order, the decoder's backward under
    fp32_convolutions(deterministic=True)): two eager calls and two graph
    calls on one frame all equal bit for bit, estimate and every log entry,
    with the same launch counts."""
    from sdfest_torch.utils import graphs

    name, overrides = GRAPH_PRESETS[path]
    pipe = _graph_pipe(dev, name, **overrides)
    depth = _observation(pipe)
    with graphs.eager():
        runs = [_counted_call(pipe, depth) for _ in range(2)]
    runs += [_counted_call(pipe, depth) for _ in range(2)]
    assert pipe.graphs.captures == 1 and pipe.graphs.replays == 2
    want, want_log, want_counts = runs[0]
    assert want_counts["launches"]["scatter"] > 0
    for i, (got, log, counts) in enumerate(runs[1:]):
        assert counts == want_counts, i
        for g, w in zip(got, want):
            assert torch.equal(g, w), i
        for k in want_log:
            assert torch.equal(log[k], want_log[k]), (i, k)


@pytest.mark.cuda
def test_graph_outputs_survive_the_next_call(dev):
    """The estimate and last_log of call k are the caller's own: call k + 1
    (another observation, the same graph) leaves them unchanged."""
    pipe = _graph_pipe(dev, "mug_procedural")
    first = pipe(*(lambda d: (d, d > 0))(_observation(pipe)))
    log = pipe.last_log
    kept = [t.clone() for t in first]
    kept_log = {k: v.clone() for k, v in log.items()}
    second = pipe(*(lambda d: (d, d > 0))(_observation(pipe, shift=0.01)))
    assert pipe.graphs.captures == 1 and pipe.graphs.replays == 2
    assert not torch.equal(second[0], first[0])
    for t, k in zip(first, kept):
        assert torch.equal(t, k)
    for k, v in kept_log.items():
        assert torch.equal(log[k], v), k


@pytest.mark.cuda
def test_graph_refine_batch_equals_eager_without_shape_optimization(dev):
    """refine_batch of 4 hypotheses through one phase graph equals the
    eager loop bit for bit, with one launch of each fused kernel per
    iteration for all of them."""
    from sdfest_torch.utils import graphs

    pipe = _graph_pipe(dev, "mug_procedural")
    depth = pipe._preprocess_depth(*(lambda d: (d, d > 0))(
        _observation(pipe)))[None]
    points, masks = pipe._lift(depth, 1)
    g = torch.Generator().manual_seed(1)
    states = {
        "position": (torch.tensor([0.02, -0.01, -0.5]) + 0.005 * torch.randn(
            4, 3, generator=g))[:, None].to(dev),
        "orientation": torch.tensor([[[0.17, 0.30, 0.09, 0.93]]] * 4,
                                    device=dev),
        "scale": torch.full((4, 1), 0.1, device=dev),
        "latent": (0.5 * torch.randn(4, 1, 8, generator=g)).to(dev)}
    views = (depth, points, masks, torch.zeros(1, 3, device=dev),
             torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev))
    with graphs.eager():
        kernels.reset_launches()
        want = pipe.refine_batch(states, *views, shape_optimization=False)
        want_counts = kernels.counts()
    kernels.reset_launches()
    got = pipe.refine_batch(states, *views, shape_optimization=False)
    assert kernels.counts() == want_counts
    assert kernels.launches()["march"] == 6
    assert kernels.hypotheses()["march"] == 24
    for g_part, w_part in zip(got, want):
        for k in w_part:
            assert torch.equal(g_part[k], w_part[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full_frame", "fast"])
def test_graph_owns_the_cached_rays_it_reads(dev, path):
    """A captured call reads the cameras' rays and the sampler's divisor
    from bounded caches.  With the caches cleared and their memory handed
    out again (filled with NaN), a replay still equals the eager call bit
    for bit: the graph keeps what it read alive."""
    import gc

    from sdfest_torch.ops import interpolation
    from sdfest_torch.utils import graphs

    name, overrides = GRAPH_PRESETS[path]
    pipe = _graph_pipe(dev, name, **overrides)
    depth = _observation(pipe)
    with graphs.eager():
        want, want_log, _ = _counted_call(pipe, depth,
                                          shape_optimization=False)
    _counted_call(pipe, depth, shape_optimization=False)
    cameras = [pipe.camera] + [pipe.camera.strided(f)
                               for f, _, _ in pipe.last_plan[0]]
    shapes = [(c.height * c.width, 3) for c in cameras] + [()]
    for cache in (plain.pixel_directions, api._tiled_directions,
                  interpolation._divisor):
        cache.cache_clear()
    gc.collect()
    filler = [torch.full(s, float("nan"), device=dev) for s in shapes
              for _ in range(8)]
    got, log, _ = _counted_call(pipe, depth, shape_optimization=False)
    assert pipe.graphs.captures == 1 and pipe.graphs.replays == 2
    del filler
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in want_log:
        assert torch.equal(log[k], want_log[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full_frame", "fast"])
def test_per_phase_call_replays_one_graph_per_phase(dev, path):
    """``fused_call: false``: one graph per phase of the plan (the first
    also takes preprocessing and the init), equal to the eager loop bit
    for bit without shape optimization, with the same launch counts."""
    from sdfest_torch.utils import graphs

    name, overrides = GRAPH_PRESETS[path]
    pipe = _graph_pipe(dev, name, fused_call=False, **overrides)
    depth = _observation(pipe)
    with graphs.eager():
        want, want_log, want_counts = _counted_call(
            pipe, depth, shape_optimization=False)
    got, log, counts = _counted_call(pipe, depth, shape_optimization=False)
    n_phases = len(pipe.last_plan[0]) + 1
    assert n_phases == (3 if path == "fast" else 1)
    assert pipe.graphs.captures == pipe.graphs.replays == n_phases
    assert counts == want_counts
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in want_log:
        assert torch.equal(log[k], want_log[k]), k


# ---------------------------------------------------------------------------
# the trainers' captured graphs (sdfest_torch/utils/graphs.py)
# ---------------------------------------------------------------------------


def _vae_trainers(dev, **overrides):
    """Two VAE trainers from the committed mug VAE (pc render 160x120)."""
    from sdfest_torch.training.vae_trainer import VAETrainer
    from sdfest_torch.utils import msgpack_reader, weights
    from sdfest_torch.utils.presets import preset

    cfg = dict(preset("vae_mug_procedural"), pc_render_width=160,
               pc_render_height=120, **overrides)
    tree = msgpack_reader.load("trained_models/mug_procedural/"
                               "mug_procedural.msgpack")
    pair = []
    for _ in range(2):
        t = VAETrainer(cfg, device=dev)
        weights.load_flax_into(t.vae, tree)
        pair.append(t)
    return pair


def _train_data(dev, n=6):
    return _decoded_mugs(dev, n).detach()


def _same_trainer_state(a, b):
    for (k, v), w in zip(a.state_dict()["model"].items(),
                         b.state_dict()["model"].values()):
        assert torch.equal(v, w), k
    for p, q in zip(a.optimizer.params(), b.optimizer.params()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["step", "chain"])
def test_vae_graph_equals_eager_bit_for_bit_without_pc_loss(dev, path):
    """With ``pc_weight: 0`` (no scatter): ``train_step`` and a
    chain of K = 3 (batch 2 on 6 grids held on the card) as graphs equal
    ``graphs.eager()`` bit for bit over two dispatches; the second replays
    on the generator's new draws (its metrics differ from the first's),
    with 0 kernel launches counted and one graph launch per dispatch."""
    from sdfest_torch.utils import graphs

    graph, eager = _vae_trainers(dev, pc_weight=0.0)
    data = _train_data(dev)
    runs = {}
    for t in (graph, eager):
        chained = t.make_chained_step(data, 2, 3)
        runs[id(t)] = ((lambda t: lambda g: t.train_step(data[:2], g))(t)
                       if path == "step" else
                       (lambda c: lambda g: c(data, g))(chained))
    gens = [torch.Generator(device=dev).manual_seed(4) for _ in range(2)]
    outs = []
    for turn in range(2):
        got = runs[id(graph)](gens[0])
        with graphs.eager():
            want = runs[id(eager)](gens[1])
        for k in want:
            assert torch.equal(got[k], want[k]), (turn, k)
        _same_trainer_state(graph, eager)
        outs.append(got["loss"].clone())
    assert graph.graphs.captures == 1 and graph.graphs.replays == 2
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["step", "chain"])
def test_vae_graph_step_with_pc_loss_starts_as_eager(dev, path):
    """With the pc loss (the scatter in the backward) ``train_step`` and a
    chain of K = 3 (batch 2 on 6 grids held on the card) as graphs equal
    ``graphs.eager()`` bit for bit over two dispatches: loss terms,
    parameters and Adam's state; one march, sample-grad and scatter launch
    per step counted on the graph path as on the eager one."""
    from sdfest_torch.utils import graphs

    graph, eager = _vae_trainers(dev)
    data = _train_data(dev)
    runs = {}
    for t in (graph, eager):
        chained = t.make_chained_step(data, 2, 3)
        runs[id(t)] = ((lambda t: lambda g: t.train_step(data[:2], g))(t)
                       if path == "step" else
                       (lambda c: lambda g: c(data, g))(chained))
    gens = [torch.Generator(device=dev).manual_seed(5) for _ in range(2)]
    steps = 1 if path == "step" else 3
    for turn in range(2):
        kernels.reset_launches()
        got = runs[id(graph)](gens[0])
        torch.cuda.synchronize()
        counts = kernels.launches()
        kernels.reset_launches()
        with graphs.eager():
            want = runs[id(eager)](gens[1])
        torch.cuda.synchronize()
        assert kernels.launches() == counts == {
            "march": steps, "march_warm": 0, "sample": 0,
            "sample_grad": steps, "scatter": steps}
        for k in want:
            assert torch.equal(got[k], want[k]), (turn, k)
        _same_trainer_state(graph, eager)
    assert graph.graphs.captures == 1 and graph.graphs.replays == 2


def _init_trainers(dev):
    from sdfest_torch.datasets.generated import SDFVAEViewDataset
    from sdfest_torch.training.init_trainer import InitTrainer
    from sdfest_torch.utils.presets import preset

    cfg = preset("init_mug_procedural_v3")
    cfg["head"].update(orientation_repr="discretized",
                       orientation_grid_resolution=1)
    pair = []
    for _ in range(2):
        torch.manual_seed(0)
        pair.append(InitTrainer(cfg, latent_size=8, device=dev))
    views = dict(cfg["datasets"]["generated_dataset"]["config_dict"],
                 width=160, height=120, num_points=500,
                 orientation_repr="discretized",
                 orientation_grid_resolution=1)
    ds = SDFVAEViewDataset(views, _mug_vae(dev).decoder, device=dev)
    return pair, ds


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["step", "chain", "replay"])
def test_init_graph_equals_eager_bit_for_bit(dev, path):
    """The init trainer's ``train_step``, a chain of K = 2 generation and
    training steps (batch 8, 160x120) and a replay chain of K = 2 units of
    3 steps (ring of 64) as graphs equal ``graphs.eager()`` bit for bit
    over two dispatches: metrics, parameters, BatchNorm statistics, Adam's
    state, the ring and its cursor; one march launch per generation
    batch."""
    from sdfest_torch.utils import graphs

    (graph, eager), ds = _init_trainers(dev)
    batch = ds.sample_batch(8, torch.Generator(device=dev).manual_seed(1))
    rings = {id(t): t.init_replay_buffer(64, 500, 8) for t in (graph, eager)}
    runs = {}
    for t in (graph, eager):
        if path == "step":
            runs[id(t)] = (lambda t: lambda g: t.train_step(batch))(t)
        elif path == "chain":
            runs[id(t)] = (lambda c: lambda g: c(g))(
                t.make_chained_step(ds, 8, 2))
        else:
            runs[id(t)] = (lambda c, r: lambda g: c(r, g))(
                t.make_replay_chained_step(ds, 8, 16, 3, 2), rings[id(t)])
    gens = [torch.Generator(device=dev).manual_seed(6) for _ in range(2)]
    for turn in range(2):
        kernels.reset_launches()
        got = runs[id(graph)](gens[0])
        torch.cuda.synchronize()
        counts = kernels.counts()
        kernels.reset_launches()
        with graphs.eager():
            want = runs[id(eager)](gens[1])
        torch.cuda.synchronize()
        assert kernels.counts() == counts
        assert counts["launches"]["march"] == (0 if path == "step" else 2)
        for k in want:
            assert torch.equal(got[k], want[k]), (turn, k)
        _same_trainer_state(graph, eager)
        for a, b in zip(rings[id(graph)].tensors(),
                        rings[id(eager)].tensors()):
            assert torch.equal(a, b)
    assert graph.graphs.captures == 1 and graph.graphs.replays == 2


@pytest.mark.cuda
def test_trace_marks_of_a_graph_replay_lie_inside_its_segment(dev):
    """A graph captured while recording holds its marks as event nodes,
    read from its last replay: in order, between that replay's segment
    marks on the host's clock.  It is a graph of its own: the unmarked
    graph of the same key stays, and both give the same result."""
    from sdfest_torch.utils import graphs, trace

    cache = graphs.GraphCache()
    x = torch.randn(1 << 20, device=dev)

    def body(a):
        trace.mark("iter.begin")
        for _ in range(20):
            a = torch.sin(a) * 1.0001
        trace.mark("decode")
        return a

    want = cache.run("k", body, x, dev).clone()
    with trace.recording() as rec:
        for _ in range(3):
            got = cache.run("k", body, x, dev)
    assert torch.equal(got, want)
    assert cache.captures == 2 and len(cache) == 2
    marked = [m for m in rec.marks if m.graph]
    assert [m.name for m in marked] == ["iter.begin", "decode"]
    last = {m.name: m.t_ns for m in rec.marks if m.graph == 0}
    assert last["segment.begin"] <= marked[0].t_ns <= marked[1].t_ns \
        <= last["segment.end"]
    assert abs(rec.drift_ns) < 1_000_000
    cache.run("k", body, x, dev)
    assert cache.captures == 2
