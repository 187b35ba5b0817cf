"""The order the port's sums keep, on the CPU.

The scatter kernel (``csrc/scatter.cu``) adds each cell's contributions in
increasing row index, the order of ``scatter_plain``; these tests define
that order against a float32 numpy loop.  The estimate's shape optimization
takes its decoder gradient as a trainer's step does: under
``fp32_convolutions(deterministic=True)``, through the resizes' fixed-order
adjoint.
"""
import numpy as np
import pytest
import torch

from sdfest_torch.ops import interpolation, pointset
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import pipeline as tpipeline
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.render import api, kernels
from sdfest_torch.utils.presets import preset

F32 = np.float32


def _scatter_loop(points: np.ndarray, cot: np.ndarray, res: int
                  ) -> np.ndarray:
    """Row by row, each row's 8 contributions ``((wx * wy) * wz) * cot``
    added to a float32 grid (clamped base cell, extrapolating fraction)."""
    grid_size = F32(2.0 / (res - 1))
    c = np.floor((points + F32(1.0)) * F32(res - 1) * F32(0.5))
    base = np.clip(c, F32(0.0), F32(res - 2))
    frac = (points - (base * grid_size - F32(1.0))) / grid_size
    base = base.astype(np.int64)
    out = np.zeros(res ** 3, F32)
    for i in range(points.shape[0]):
        w = [(F32(1.0) - frac[i, a], frac[i, a]) for a in range(3)]
        for k in range(8):
            dx, dy, dz = k >> 2, (k >> 1) & 1, k & 1
            cell = ((base[i, 0] + dx) * res + base[i, 1] + dy) * res + (
                base[i, 2] + dz)
            out[cell] = out[cell] + w[0][dx] * w[1][dy] * w[2][dz] * cot[i]
    return out.reshape(res, res, res)


def _rows(rng, n, span, zero_share):
    points = (rng.random((n, 3)) * 2 * span - span).astype(F32)
    # a few hundred rows in one cell: long runs of one cell's sums
    points[: n // 10] = (-0.4 + 0.01 * rng.random((n // 10, 3))).astype(F32)
    cot = rng.standard_normal(n).astype(F32)
    cot[rng.random(n) < zero_share] = 0.0
    return points, cot


def _dense_rows(rng, n):
    """``n`` rows in 3 base cells per axis (res 64): 27 buckets of ~n / 27
    rows, up to 8 of which meet in a cell, so its chain of contributions
    runs into the thousands."""
    points = (-1.0 + (40.0 + 3.0 * rng.random((n, 3))) * (2.0 / 63.0)
              ).astype(F32)
    cot = rng.standard_normal(n).astype(F32)
    cot[rng.random(n) < 0.1] = 0.0
    return points, cot


CASES = ["threads", "one_thread", "extrapolated", "res_63", "batch_3",
         "zero_cotangents", "dense"]


@pytest.mark.parametrize("case", CASES)
def test_scatter_plain_adds_rows_in_order(case):
    """``scatter_plain`` equals the numpy loop bit for bit (signed zeros
    included): with PyTorch's threads and with one, points up to 0.5
    outside the volume, res 64 and 63, a batch of 3 hypotheses (each its
    own loop), all-zero cotangents, and 20,000 rows in 3 cells per axis
    (chains of thousands of contributions per cell)."""
    rng = np.random.default_rng(CASES.index(case))
    res = 63 if case == "res_63" else 64
    n_hyp = 3 if case == "batch_3" else 1
    span = 1.5 if case == "extrapolated" else 1.0
    if case == "dense":
        rows = [_dense_rows(rng, 20_000)]
    else:
        rows = [_rows(rng, 2000, span, 1.0 if case == "zero_cotangents"
                      else 0.5) for _ in range(n_hyp)]
    points = torch.from_numpy(np.stack([p for p, _ in rows]))
    cot = torch.from_numpy(np.stack([c for _, c in rows]))
    threads = torch.get_num_threads()
    if case == "one_thread":
        torch.set_num_threads(1)
    try:
        got = (kernels.scatter(points, cot, res) if n_hyp > 1
               else kernels.scatter(points[0], cot[0], res)[None])
    finally:
        torch.set_num_threads(threads)
    for b, (p, c) in enumerate(rows):
        want = _scatter_loop(p, c, res)
        assert np.array_equal(got[b].numpy().view(np.int32),
                              want.view(np.int32)), b
    if case == "zero_cotangents":
        assert not bool(got.any())
    if case == "dense":
        idx, _ = interpolation.trilinear_weights(points[0][cot[0] != 0], res)
        assert int(torch.bincount(idx.reshape(-1)).max()) > 1000


CAMERA = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
              pixel_center=0.5)


@pytest.fixture(scope="module")
def refine_inputs():
    """A 64x48 pipeline on the committed mug weights, an observation of a
    decoded mug and a perturbed start."""
    config = preset("mug_procedural")
    config.update(camera=dict(CAMERA), max_iterations=2)
    pipe = SDFPipeline(config, device="cpu")
    g = torch.Generator().manual_seed(0)
    latent = 0.5 * torch.randn(1, 8, generator=g)
    q = torch.tensor([0.17, 0.30, 0.09, 0.93])
    with torch.no_grad():
        sdf = pipe._decode(latent)[0, 0]
        depth = api.render_depth(
            sdf, torch.tensor([0.02, -0.01, -0.5]), q / q.norm(), 10.0,
            camera=Camera(**CAMERA), threshold=0.005, device="cpu")
    assert int((depth > 0).sum()) > 40
    depth = pipe._preprocess_depth(depth, depth > 0)
    points, mask = pointset.depth_to_pointcloud_dense(depth, pipe.camera,
                                                      order="tile")
    start = {"position": torch.tensor([[0.03, -0.02, -0.49]]),
             "orientation": (q / q.norm())[None],
             "scale": torch.tensor([0.11]),
             "latent": latent + 0.1 * torch.randn(1, 8, generator=g)}
    return pipe, start, depth, points, mask


@pytest.mark.parametrize("shape_optimization", [True, False])
def test_refine_takes_the_decoder_gradient_in_fp32_with_a_fixed_order(
        refine_inputs, monkeypatch, shape_optimization):
    """With shape optimization every decoder convolution's backward runs
    with cuDNN's deterministic algorithms and TF32 off, and every resize's
    backward is the fixed-order adjoint (``_Resize.backward``); without it
    no gradient reaches the decoder (no convolution's and no resize's
    backward runs) and the iterations equal those without the context bit
    for bit."""
    pipe, start, depth, points, mask = refine_inputs
    cudnn = torch.backends.cudnn
    flags, resizes = [], {"forward": 0, "backward": 0}
    forward, backward = (interpolation._Resize.forward,
                         interpolation._Resize.backward)

    def spy(kind, fn):
        def run(ctx, *args):
            resizes[kind] += 1
            return fn(ctx, *args)
        return staticmethod(run)

    monkeypatch.setattr(interpolation._Resize, "forward",
                        spy("forward", forward))
    monkeypatch.setattr(interpolation._Resize, "backward",
                        spy("backward", backward))
    convs = [m for m in pipe.decoder.modules()
             if isinstance(m, torch.nn.Conv3d)]
    hooks = [m.register_full_backward_hook(lambda *_: flags.append(
        (cudnn.deterministic, cudnn.allow_tf32))) for m in convs]
    try:
        _, _, log = pipe._refine(dict(start), depth, points, mask,
                                 shape_optimization=shape_optimization,
                                 num_iterations=2)
    finally:
        for h in hooks:
            h.remove()
    if shape_optimization:
        assert len(flags) == 2 * len(convs)
        assert set(flags) == {(True, False)}
        assert resizes["backward"] == resizes["forward"] > 0
        assert float(log["latent"].sub(start["latent"]).abs().max()) > 0
        return
    assert flags == [] and resizes["backward"] == 0
    assert resizes["forward"] > 0
    monkeypatch.setattr(tpipeline, "fp32_convolutions",
                        lambda **_: pytest.fail("entered without shape "
                                                "optimization"))
    _, _, again = pipe._refine(dict(start), depth, points, mask,
                               shape_optimization=False, num_iterations=2)
    for k, v in log.items():
        assert torch.equal(v, again[k]), k
