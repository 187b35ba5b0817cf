#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one CUDA card and check it.

Run from the repository root on a machine with an H100 (or another sm_90a
card) and the CUDA toolkit:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --phases build,check   # build and check kernels only
    python3 chip_smoke.py --phases build,check,fast   # the fast.yaml path

Phases:
  build     compile the four kernels from sdfest_torch/csrc (nvcc, sm_90a)
  check     hold each kernel against its plain PyTorch twin at main-path
            shapes (640x480 camera, decoded 64^3 mug SDF, realistic masks);
            ROI marches against the crop of the full march (bit for bit)
            and against the plain ROI march, at strides 1, 2 and 4
  pipeline  SDFPipeline.__call__ of the mug_procedural preset with the
            committed weights on a self-rendered observation, 50 full-frame
            iterations; counts kernel launches per call and times 3 calls
  fast      the same under mug_procedural_fast (fast.yaml: ROI crop +
            [4, 2] multires): plan, launches and march rasters per call,
            rays marched, 3 timed calls
  time      each kernel and its plain twin over 30 distinct inputs (CUDA
            events), with the least time the card could take (bound); the
            march also at the three ROI shapes of the fast plan
  profile   torch.profiler over one full-frame and one fast call: device
            busy share and the ops that take the time

Prints one JSON line {"kernels": [...]}, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.  Any failed check
raises, and the script then exits non-zero without that line.  It exits
non-zero at once when CUDA is not available.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

PHASES = ("build", "check", "pipeline", "fast", "time", "profile")
# ~50 ms of spin at the H100's ~2 GHz: longer than the host takes to
# enqueue 30 launches of any wrapper (see cuda_ms)
SPIN_CYCLES = 100_000_000
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense fp32
# (non-tensor-core) operations/s; the kernels are all-fp32 gathers and adds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per unit of work, counted from the CUDA sources:
# locate (3 axes x ~9) + 8-corner lerp (21) + weights (3) + scale/mask (2)
OPS_SAMPLE = 53
# sample + 3 partials (~30) + 4 masked stores' multiplies
OPS_SAMPLE_GRAD = 90
# locate (27) + weights (3) + 8 corners x 3 multiplies + 8 atomic adds
OPS_SCATTER = 62
# march: per fine step = position (6) + sample (51) + test/update (~9);
# per bound step = position (6) + coarse index (15) + test/step (4);
# per ray = rotation (15) + slab test (~30)
OPS_MARCH_FINE, OPS_MARCH_BOUND, OPS_MARCH_RAY = 66, 25, 45
GT_POSES = [  # (position, half-width, quaternion xyzw), tilted views
    ((0.02, -0.01, -0.5), 0.1, (0.25, 0.35, 0.1, 0.895)),
    ((-0.03, 0.02, -0.55), 0.11, (-0.2, 0.4, 0.15, 0.88)),
    ((0.01, 0.03, -0.45), 0.09, (0.3, -0.25, 0.2, 0.9)),
    ((0.0, -0.02, -0.6), 0.1, (0.1, 0.6, -0.1, 0.78)),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, inputs, warmup: int = 2) -> float:
    """Mean device ms of ``fn(x)`` over the distinct ``inputs`` (CUDA
    events).

    A wrapper spends longer on the host than its kernel runs, so timing the
    launches as they are issued would measure the host's launch gaps.  A
    spin kernel queued first holds the stream until every launch is
    enqueued; the events then bracket the kernels running back to back.
    """
    import torch

    for x in inputs[:warmup]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(inputs)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bytes(points, active, res) -> int:
    """Bytes a sampler must read for its active rows: each row's point and
    each distinct grid cell their 8 corners touch."""
    import torch

    from sdfest_torch.ops.interpolation import trilinear_weights

    idx, _ = trilinear_weights(points[active], res)
    return 12 * int(active.sum()) + 4 * int(torch.unique(idx).numel())


def unit_quat(q, device):
    import torch

    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    return q / torch.linalg.norm(q)


class Smoke:
    def __init__(self):
        import torch

        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.utils.presets import preset

        self.dev = torch.device("cuda")
        self.pipe = SDFPipeline(preset("mug_procedural"), device=self.dev)
        self.fast_pipe = SDFPipeline(preset("mug_procedural_fast"),
                                     device=self.dev)
        self.camera = self.pipe.camera
        gen = torch.Generator(device="cpu").manual_seed(0)
        self.latent = (0.5 * torch.randn(1, 8, generator=gen)).to(self.dev)
        with torch.no_grad():
            self.sdf = self.pipe._decode(self.latent)[0, 0].contiguous()
        self.report = {}

    # -- helpers -----------------------------------------------------------

    def render(self, sdf, pos, q, half):
        """Depth of ``sdf`` at a pose (port's march)."""
        import torch

        from sdfest_torch.render import render_depth

        with torch.no_grad():
            return render_depth(
                sdf, torch.as_tensor(pos, device=self.dev),
                unit_quat(q, self.dev), 1.0 / half, camera=self.camera,
                threshold=self.pipe.config["threshold"], device=self.dev,
            )

    def observe(self, gt):
        """Depth of the decoded mug at a ground-truth pose."""
        pos, half, q = gt
        return self.render(self.sdf, pos, q, half)

    def asymmetry(self, q_rel) -> float:
        """Mean |sdf(R x) - sdf(x)| of the true shape over grid points x
        near its surface (|sdf| < 0.1) whose image R x stays in the grid."""
        import torch

        from sdfest_torch.ops import quaternion
        from sdfest_torch.ops.interpolation import sample_sdf

        res = self.sdf.shape[0]
        lin = torch.linspace(-1.0, 1.0, res, device=self.dev)
        x = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
        near = self.sdf.abs() < 0.1
        x, v = x[near], self.sdf[near]
        y = quaternion.apply(unit_quat(q_rel, self.dev), x)
        keep = y.abs().amax(dim=1) <= 1.0
        return float((sample_sdf(self.sdf, y[keep]) - v[keep]).abs().mean())

    def witness(self, gt, est):
        """What the observation says about an estimate's orientation: for
        renders at the estimate and at the truth, the mean |depth - observed|
        over the observed pixels (what the depth loss sees) and the
        silhouettes' intersection over union; the rotation that separates
        estimate and truth (object frame) and how far the true shape changes
        under it, beside its change under a half turn about each axis; the
        orientation error of the init network's start; and the
        refinement's loss at the estimate and at the truth."""
        import torch

        from sdfest_torch.ops import pointset, quaternion

        pos, orient, scale, latent = est
        gpos, ghalf, gq = gt
        obs = self.observe(gt)
        with torch.no_grad():
            sdf_est = self.pipe._decode(latent)[0, 0].contiguous()

        def fit(sdf, p, q, half):
            d = self.render(sdf, p, q, half)
            seen, hit = obs > 0, d > 0
            iou = float((seen & hit).sum()) / float((seen | hit).sum())
            return [float((d - obs)[seen].abs().mean()), iou]

        depth = self.pipe._preprocess_depth(obs, obs > 0)
        points, point_mask = pointset.depth_to_pointcloud_dense(
            depth, self.camera, order="tile")

        def loss(state):
            _, _, log = self.pipe._refine(state, depth, points, point_mask,
                                          num_iterations=1)
            return float(log["loss"][0])

        est_pose = (pos[0], orient[0], float(scale[0]))
        gt_pose = (gpos, gq, ghalf)
        truth = {"position": torch.tensor([gpos], device=self.dev),
                 "orientation": unit_quat(gq, self.dev)[None],
                 "scale": torch.tensor([ghalf], device=self.dev),
                 "latent": self.latent}
        rel = lambda q: quaternion.multiply(
            quaternion.invert(unit_quat(gq, self.dev)),
            q / torch.linalg.norm(q))
        deg = lambda q: math.degrees(2 * math.acos(min(1.0, abs(float(q[3])))))
        q_rel = rel(orient[0])
        with torch.no_grad():
            start = self.pipe._nn_init(
                depth, torch.zeros(3, device=self.dev),
                torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.dev),
                torch.Generator(device=self.dev).manual_seed(0))[3][0]
        axis = (q_rel[:3] / torch.linalg.norm(q_rel[:3])).tolist()
        out = {
            "l1_iou_est_shape_est_pose": fit(sdf_est, *est_pose),
            "l1_iou_est_shape_true_pose": fit(sdf_est, *gt_pose),
            "l1_iou_true_shape_est_pose": fit(self.sdf, *est_pose),
            "init_rotation_deg": deg(rel(start)),
            "rotation_deg": deg(q_rel), "rotation_axis": axis,
            "asymmetry_under_rotation": self.asymmetry(q_rel.tolist()),
            "loss_at_estimate": loss({"position": pos, "orientation": orient,
                                      "scale": scale, "latent": latent}),
            "loss_at_truth": loss(truth),
        }
        for i, name in enumerate("xyz"):
            half_turn = [0.0, 0.0, 0.0, 0.0]
            half_turn[i] = 1.0
            out[f"asymmetry_half_turn_{name}"] = self.asymmetry(half_turn)
        print("pipeline witness " + json.dumps(out))
        return out

    def queries(self, gt, perturb, seed):
        """Main-path sampler inputs at a refinement-like state: the
        surrogate queries of the render at a perturbed pose and the pc
        queries of the observed cloud, with their masks."""
        import torch

        from sdfest_torch.ops import pointset
        from sdfest_torch.render import api

        pos, half, q = gt
        g = torch.Generator(device="cpu").manual_seed(seed)
        d = lambda n, s: (s * torch.randn(n, generator=g)).to(self.dev)
        depth_obs = self.observe(gt)
        points, pmask = pointset.depth_to_pointcloud_dense(
            depth_obs, self.camera, order="tile"
        )
        p = torch.tensor(pos, device=self.dev) + d(3, perturb)
        quat = unit_quat(q, self.dev) + d(4, perturb)
        quat = quat / torch.linalg.norm(quat)
        inv_s = torch.tensor(1.0 / half, device=self.dev) * (1 + d(1, perturb)[0])
        depth = self.observe((p.tolist(), float(1 / inv_s), quat.tolist()))
        with torch.no_grad():
            sur, sur_mask, _ = api._surrogate_queries(
                p, quat, inv_s, depth, api.ray_set(self.camera, self.dev)
            )
            obj, pc_mask = api._pc_object_points(
                p, quat, inv_s, points, pmask, self.sdf.shape[0]
            )
        return (sur.contiguous(), sur_mask.float(), obj.contiguous(),
                pc_mask.float())

    # -- phases ------------------------------------------------------------

    def check(self):
        import torch

        from sdfest_torch.render import kernels, plain

        k = kernels
        gt = GT_POSES[0]
        sur, sur_m, obj, pc_m = self.queries(gt, 0.01, 1)
        res = self.sdf.shape[0]
        # sample: the pc values of the fused forward (N = H*W)
        got = k.sample(self.sdf, obj, pc_m)
        want = k.sample_plain(self.sdf, obj, pc_m)
        err = float((got - want).abs().max())
        print(f"check sample      N={obj.shape[0]} max|d|={err:.3e} "
              f"(tol 1e-4, active {int(pc_m.sum())})")
        assert err <= 1e-4, "sample kernel disagrees with its plain twin"
        self.report["sample"] = dict(max_err=err, tol=1e-4, n=obj.shape[0],
                                     active=int(pc_m.sum()))
        # sample-grad + scatter: the concatenated backward queries (2*H*W)
        pts = torch.cat([sur, obj]).contiguous()
        m = torch.cat([sur_m, pc_m]).contiguous()
        v, gr = k.sample_grad(self.sdf, pts, m)
        wv, wg = k.sample_grad_plain(self.sdf, pts, m)
        ev = float((v - wv).abs().max())
        eg = float((gr - wg).abs().max())
        print(f"check sample_grad N={pts.shape[0]} value max|d|={ev:.3e} "
              f"(tol 1e-4) grad max|d|={eg:.3e} (tol 1e-3)")
        assert ev <= 1e-4 and eg <= 1e-3, "sample_grad kernel disagrees"
        self.report["sample_grad"] = dict(
            max_err=max(ev, eg), max_err_value=ev, max_err_grad=eg,
            tol="value 1e-4, grad 1e-3", n=pts.shape[0],
            active=int(m.sum()))
        gen = torch.Generator(device="cpu").manual_seed(2)
        cot = (torch.randn(pts.shape[0], generator=gen).to(self.dev) * m)
        got = k.scatter(pts, cot.contiguous(), res)
        want = k.scatter_plain(pts, cot, res)
        es = float((got - want).abs().max())
        tol = 1e-3 * max(1.0, float(want.abs().max()))
        print(f"check scatter     N={pts.shape[0]} max|d|={es:.3e} "
              f"(tol {tol:.3e})")
        assert es <= tol, "scatter kernel disagrees with its plain twin"
        self.report["scatter"] = dict(max_err=es, tol=tol, n=pts.shape[0],
                                      active=int((cot != 0).sum()))
        # march, at every ground-truth pose, with and without culling +
        # adaptive relaxation
        dirs = plain.pixel_directions(self.camera, self.dev)
        self.report["march"] = dict(
            max_err=0.0, agreement=1.0,
            tol="hit agreement > 0.995, |ddepth| < 5e-3")
        for culling in (True, False):
            for pos, half, q in GT_POSES:
                pose = k.pose_params(torch.tensor(pos, device=self.dev),
                                     unit_quat(q, self.dev),
                                     torch.tensor(1.0 / half, device=self.dev))
                args = (self.sdf, dirs, pose, self.pipe.config["threshold"],
                        500, culling, culling)
                got = k.march(*args)
                steps = {}
                want = plain.march_plain(*args, steps=steps)
                hit_g, hit_w = got > 0, want > 0
                agree = float((hit_g == hit_w).float().mean())
                both = hit_g & hit_w
                dd = float((got - want)[both].abs().max()) if bool(
                    both.any()) else 0.0
                print(f"check march culling+adaptive={culling} hits "
                      f"{int(hit_w.sum())} agreement {agree:.6f} (> 0.995) "
                      f"max|ddepth| {dd:.3e} (< 5e-3) steps {steps}")
                assert int(hit_w.sum()) > dirs.shape[0] // 200, (
                    "the object covers too few pixels")
                assert agree > 0.995 and dd < 5e-3, "march disagrees"
                r = self.report["march"]
                r["max_err"] = max(r["max_err"], dd)
                r["agreement"] = min(r["agreement"], agree)
        self.check_roi()

    def roi_inputs(self, gt, factor, roi):
        """The fast plan's ROI march at one pose and stride: the full
        strided rays, the ROI's offset (from the strided observation, as the
        pipeline takes it) and the ROI's rays."""
        from sdfest_torch.pipeline.pipeline import _roi_offset_for
        from sdfest_torch.render import api

        camera = self.camera.strided(factor) if factor > 1 else self.camera
        obs = self.observe(gt)[::factor, ::factor].contiguous()
        offset = _roi_offset_for(obs, roi)
        return (api.ray_set(camera, self.dev).march, offset,
                api.ray_set(camera, self.dev, roi, offset).march)

    def check_roi(self):
        """At every pose, the ROI march (the fast plan's three shapes)
        equals the crop of the full march of its stride bit for bit, and
        holds the plain ROI march's bar."""
        import torch

        from sdfest_torch.render import api, kernels as k, plain

        thr = self.pipe.config["threshold"]
        r = self.report["march"]["roi"] = dict(
            crop_equal=True, agreement=1.0, max_err=0.0, shapes=[],
            tol="ROI == crop of full (torch.equal); vs plain ROI march: hit "
                "agreement > 0.995, |ddepth| < 5e-3")
        for factor, roi in ROI_SHAPES:
            r["shapes"].append([factor, *roi])
            for gt in GT_POSES:
                pos, half, q = gt
                full_rays, offset, rays = self.roi_inputs(gt, factor, roi)
                pose = k.pose_params(torch.tensor(pos, device=self.dev),
                                     unit_quat(q, self.dev),
                                     torch.tensor(1.0 / half, device=self.dev))
                args = (pose, thr, 500, True, True)
                full = k.march(self.sdf, full_rays, *args)
                got = k.march(self.sdf, rays, *args)
                want = plain.march_plain(self.sdf, rays.reshape(-1, 3),
                                         *args).reshape(roi)
                torch.cuda.synchronize()
                equal = torch.equal(got, api.crop(full, roi, offset))
                hit_g, hit_w = got > 0, want > 0
                agree = float((hit_g == hit_w).float().mean())
                both = hit_g & hit_w
                dd = float((got - want)[both].abs().max()) if bool(
                    both.any()) else 0.0
                print(f"check march ROI f={factor} {roi[0]}x{roi[1]} at "
                      f"{offset.tolist()}: equals crop of full {equal}; hits "
                      f"{int(hit_w.sum())} agreement with plain {agree:.6f} "
                      f"max|ddepth| {dd:.3e}")
                assert equal, "ROI march differs from the full march's crop"
                assert int(hit_w.sum()) > 100, "the ROI shows too few hits"
                assert agree > 0.995 and dd < 5e-3, "ROI march disagrees"
                r["agreement"] = min(r["agreement"], agree)
                r["max_err"] = max(r["max_err"], dd)

    def pipeline(self):
        import torch

        from sdfest_torch.ops import quaternion
        from sdfest_torch.render import kernels

        depth = self.observe(GT_POSES[0])
        torch.cuda.synchronize()
        kernels.reset_launches()
        pos, orient, scale, latent = self.pipe(depth, depth > 0)
        torch.cuda.synchronize()
        counts = kernels.launches()
        n_iter = self.pipe.config["max_iterations"]
        print(f"pipeline launches per call {counts} ({n_iter} iterations)")
        for name, c in counts.items():
            assert c == n_iter, f"{name} launched {c} times, not {n_iter}"
            self.report[name]["launches"] = c
        loss = self.pipe.last_log["loss"]
        l0, l_last = float(loss[0]), float(loss[-1])
        print(f"pipeline loss it0 {l0:.6f} it{n_iter - 1} {l_last:.6f}")
        assert math.isfinite(l0) and math.isfinite(l_last) and l_last < l0
        for t in (pos, orient, scale, latent):
            assert bool(torch.isfinite(t).all()), "non-finite estimate"
        walls, witnesses = [], []
        for gt in GT_POSES[1:]:
            depth = self.observe(gt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pos, orient, scale, latent = self.pipe(depth, depth > 0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            gpos, ghalf, gq = gt
            e_pos = float(torch.linalg.norm(
                pos[0] - torch.tensor(gpos, device=self.dev)))
            e_scale = abs(float(scale[0]) - ghalf)
            e_rot = math.degrees(float(quaternion.geodesic_distance(
                orient[0], unit_quat(gq, self.dev))))
            loss = self.pipe.last_log["loss"]
            print(f"pipeline call {len(walls)}: {walls[-1] * 1e3:.3f} ms "
                  f"({walls[-1] * 1e3 / n_iter:.3f} ms/iteration) position "
                  f"error {e_pos * 1e3:.2f} mm scale error {e_scale * 1e3:.2f}"
                  f" mm orientation error {e_rot:.2f} deg loss "
                  f"{float(loss[0]):.5f} -> {float(loss[-1]):.5f}")
            assert math.isfinite(e_pos + e_scale + e_rot)
            witnesses.append(self.witness(gt, (pos, orient, scale, latent)))
        mean = sum(walls) / len(walls)
        print(f"pipeline mean {mean * 1e3:.3f} ms/call, "
              f"{n_iter / mean:.1f} iterations/s")
        self.report["_pipeline"] = dict(ms_per_call=mean * 1e3,
                                        it_per_s=n_iter / mean,
                                        witness=witnesses)

    def fast(self):
        """SDFPipeline.__call__ under mug_procedural_fast: a warm-up call
        and 3 timed calls, each read for its plan, launches per kernel and
        the march's rasters (counts set to 0 just before the call)."""
        import torch

        from sdfest_torch.ops import quaternion
        from sdfest_torch.render import kernels

        pipe = self.fast_pipe
        n_iter = pipe.config["max_iterations"]
        walls, calls = [], []
        for i, gt in enumerate(GT_POSES):
            depth = self.observe(gt)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            pos, orient, scale, latent = pipe(depth, depth > 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launches()
            rasters = dict(kernels.march.rasters)
            levels, fine_roi, fine_iters = pipe.last_plan
            rays = sum(h * w * c for (h, w), c in rasters.items())
            print(f"fast call {i} plan levels {list(levels)} fine "
                  f"{fine_roi} x {fine_iters}; launches {counts}; march "
                  f"rasters {rasters}; rays marched {rays}")
            assert all(roi is not None for _, _, roi in levels) and (
                fine_roi is not None) and len(levels) == 2, (
                "the fast plan lacks an ROI at some level")
            for name, c in counts.items():
                assert c == n_iter, f"{name} launched {c} times, not {n_iter}"
            assert sum(rasters.values()) == n_iter
            loss = pipe.last_log["loss"]
            l0, l_last = float(loss[0]), float(loss[-1])
            assert loss.shape == (n_iter,)
            assert math.isfinite(l0) and math.isfinite(l_last) and l_last < l0
            for t in (pos, orient, scale, latent):
                assert bool(torch.isfinite(t).all()), "non-finite estimate"
            gpos, ghalf, gq = gt
            e_pos = float(torch.linalg.norm(
                pos[0] - torch.tensor(gpos, device=self.dev)))
            e_scale = abs(float(scale[0]) - ghalf)
            e_rot = math.degrees(float(quaternion.geodesic_distance(
                orient[0], unit_quat(gq, self.dev))))
            print(f"fast call {i}: {wall * 1e3:.3f} ms ("
                  f"{'warm-up' if i == 0 else 'timed'}) loss it0 {l0:.6f} "
                  f"it{n_iter - 1} {l_last:.6f}; position error "
                  f"{e_pos * 1e3:.2f} mm scale error {e_scale * 1e3:.2f} mm "
                  f"orientation error {e_rot:.2f} deg")
            calls.append(dict(plan=[list(levels), fine_roi, fine_iters],
                              launches=counts, rasters={
                                  f"{h}x{w}": c for (h, w), c in
                                  rasters.items()},
                              rays=rays, ms=wall * 1e3, loss=[l0, l_last],
                              errors_mm_mm_deg=[e_pos * 1e3, e_scale * 1e3,
                                                e_rot]))
            if i:
                walls.append(wall)
        mean = sum(walls) / len(walls)
        full = self.report.get("_pipeline", {}).get("ms_per_call")
        print(f"fast mean {mean * 1e3:.3f} ms/call, {n_iter / mean:.1f} "
              f"iterations/s (full-frame pipeline this run: "
              f"{'not run' if full is None else f'{full:.3f} ms/call'})")
        for name in kernels.KERNELS:
            self.report[name]["launches_fast"] = calls[0]["launches"][name]
        self.report["march"]["roi"]["rasters_per_call"] = calls[0]["rasters"]
        self.report["_fast"] = dict(ms_per_call=mean * 1e3,
                                    it_per_s=n_iter / mean, calls=calls)

    def time(self):
        import torch

        from sdfest_torch.render import kernels as k
        from sdfest_torch.render import plain

        reps = 30
        res = self.sdf.shape[0]
        sets = [self.queries(GT_POSES[i % len(GT_POSES)], 0.01, 100 + i)
                for i in range(reps)]
        # bytes each function must move on these inputs, averaged over the
        # sets: every row's mask or cotangent and its outputs, plus the point
        # of each active row and the grid cells those points touch (a row
        # with mask or cotangent 0 reads nothing else)
        mean = lambda xs: sum(xs) / len(xs)
        # sample
        inp = [(o, m) for _, _, o, m in sets]
        ms = cuda_ms(lambda x: k.sample(self.sdf, *x), inp)
        pms = cuda_ms(lambda x: k.sample_plain(self.sdf, *x), inp)
        n = inp[0][0].shape[0]
        active = mean([float(m.sum()) for _, m in inp])
        nbytes = n * 8 + mean([gather_bytes(o, m != 0, res) for o, m in inp])
        self._timed("sample", ms, pms, nbytes, active * OPS_SAMPLE)
        # sample-grad and scatter on the concatenated backward queries
        inp = [(torch.cat([s, o]).contiguous(), torch.cat([sm, m]).contiguous())
               for s, sm, o, m in sets]
        n = inp[0][0].shape[0]
        active = mean([float(m.sum()) for _, m in inp])
        ms = cuda_ms(lambda x: k.sample_grad(self.sdf, *x), inp)
        pms = cuda_ms(lambda x: k.sample_grad_plain(self.sdf, *x), inp)
        nbytes = n * 20 + mean([gather_bytes(p, m != 0, res) for p, m in inp])
        self._timed("sample_grad", ms, pms, nbytes, active * OPS_SAMPLE_GRAD)
        gen = torch.Generator(device="cpu").manual_seed(3)
        inp = [(p, (torch.randn(n, generator=gen).to(self.dev) * m)
                .contiguous()) for p, m in inp]
        ms = cuda_ms(lambda x: k.scatter(*x, res), inp)
        pms = cuda_ms(lambda x: k.scatter_plain(*x, res), inp)
        # cotangents in, the active rows' points in, the whole grid out
        nbytes = n * 4 + 12 * active + res ** 3 * 4
        self._timed("scatter", ms, pms, nbytes, active * OPS_SCATTER)
        # march at distinct poses (the coarse table is built once per grid,
        # outside the timed kernel)
        dirs = plain.pixel_directions(self.camera, self.dev)
        coarse = plain.coarse_min_table(self.sdf)
        g = torch.Generator(device="cpu").manual_seed(4)
        poses = []
        for i in range(reps):
            pos, half, q = GT_POSES[i % len(GT_POSES)]
            jitter = (0.01 * torch.randn(3, generator=g)).tolist()
            poses.append(k.pose_params(
                torch.tensor(pos, device=self.dev) + torch.tensor(
                    jitter, device=self.dev),
                unit_quat(q, self.dev),
                torch.tensor(1.0 / half, device=self.dev)))
        thr = self.pipe.config["threshold"]
        ms = cuda_ms(lambda pose: k.march(self.sdf, dirs, pose, thr, 500,
                                          True, True, coarse=coarse), poses)
        pms = cuda_ms(lambda pose: plain.march_plain(
            self.sdf, dirs, pose, thr, 500, True, True), poses, warmup=1)
        steps = {"rays": 0, "fine": 0, "bound": 0, "cells": 0}
        for pose in poses:
            s = {}
            plain.march_plain(self.sdf, dirs, pose, thr, 500, True, True,
                              steps=s)
            for key in steps:
                steps[key] += s[key] / reps
        n = dirs.shape[0]
        ops = (steps["rays"] * OPS_MARCH_RAY + steps["fine"] * OPS_MARCH_FINE
               + steps["bound"] * OPS_MARCH_BOUND)
        # directions in and depth out per ray, the grid cells the fine
        # steps read, the coarse table and the pose
        self._timed("march", ms, pms,
                    n * 16 + steps["cells"] * 4 + 16 ** 3 * 4 + 14 * 4, ops)
        self.report["march"]["steps_per_render"] = steps
        # the march at the fast plan's three ROI shapes, each at the same 30
        # poses with the ROI of its ground-truth pose
        timed = self.report["march"]["roi"]["timed"] = []
        for factor, roi in ROI_SHAPES:
            rays = [self.roi_inputs(gt, factor, roi)[2] for gt in GT_POSES]
            inp = [(pose, rays[i % len(rays)]) for i, pose in enumerate(poses)]
            ms = cuda_ms(lambda x: k.march(self.sdf, x[1], x[0], thr, 500,
                                           True, True, coarse=coarse), inp)
            pms = cuda_ms(lambda x: plain.march_plain(
                self.sdf, x[1].reshape(-1, 3), x[0], thr, 500, True, True),
                inp, warmup=1)
            steps = {"rays": 0, "fine": 0, "bound": 0, "cells": 0}
            for pose, r in inp:
                st = {}
                plain.march_plain(self.sdf, r.reshape(-1, 3), pose, thr, 500,
                                  True, True, steps=st)
                for key in steps:
                    steps[key] += st[key] / reps
            n = roi[0] * roi[1]
            ops = (steps["rays"] * OPS_MARCH_RAY
                   + steps["fine"] * OPS_MARCH_FINE
                   + steps["bound"] * OPS_MARCH_BOUND)
            nbytes = n * 16 + steps["cells"] * 4 + 16 ** 3 * 4 + 14 * 4
            b_ms, by = bound(nbytes, ops)
            print(f"time march ROI f={factor} {roi[0]}x{roi[1]} kernel "
                  f"{ms:.4f} ms plain {pms:.4f} ms bound {b_ms:.5f} ms ({by}: "
                  f"{nbytes / 1e6:.3f} MB, {ops / 1e6:.3f} Mop) steps {steps}")
            timed.append(dict(factor=factor, raster=list(roi), ms=ms,
                              plain_ms=pms, bound_ms=b_ms, bound_by=by,
                              bytes=nbytes, ops=ops, steps=steps))

    def profile(self):
        """torch.profiler over one full-frame and one fast call: device
        busy share and the ops that take the time."""
        self._profile_call(self.pipe, "full-frame")
        self._profile_call(self.fast_pipe, "fast")

    def _profile_call(self, pipe, label):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from torch.autograd import DeviceType

        depth = self.observe(GT_POSES[0])
        pipe(depth, depth > 0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(depth, depth > 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            pipe(depth, depth > 0)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        n_kernels = sum(e.count for e in kernels)
        n_iter = pipe.config["max_iterations"]
        print(f"profile {label}: unprofiled wall {wall_ms:.3f} ms/call; "
              f"device kernels {dev_ms:.3f} ms/call ({n_kernels} launches, "
              f"{n_kernels / n_iter:.1f} per iteration); device busy share "
              f"{dev_ms / wall_ms:.4f}, idle share {1 - dev_ms / wall_ms:.4f}")
        self.report[f"_profile_{label}"] = dict(
            wall_ms=wall_ms, device_ms=dev_ms, launches=n_kernels,
            busy_share=dev_ms / wall_ms)
        for name in SOURCES:  # the port's kernels, as the trace times them
            rows = [e for e in kernels if f"{name}_kernel(" in e.key]
            for e in rows:
                print(f"profile {label} kernel {name}: {e.count} launches, "
                      f"mean {e.self_device_time_total / e.count / 1e3:.4f} "
                      f"ms ({e.key})")
        print(events.table(sort_by="self_device_time_total", row_limit=15,
                           max_name_column_width=48))
        print(events.table(sort_by="self_cpu_time_total", row_limit=12,
                           max_name_column_width=48))

    def _timed(self, name, ms, plain_ms, nbytes, ops):
        b_ms, by = bound(nbytes, ops)
        print(f"time {name:<12} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {b_ms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e6:.2f} Mop)")
        self.report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=by, bytes=nbytes, ops=ops)


# (stride, ROI) of the fast plan on the GT_POSES observations at 640x480
ROI_SHAPES = [(4, (64, 80)), (2, (128, 160)), (1, (240, 320))]

SOURCES = {
    "march": ("sdfest_torch/csrc/march.cu",
              "sdfest_tpu/render/pallas_kernel.py:546"),
    "sample": ("sdfest_torch/csrc/sample.cu",
               "sdfest_tpu/render/pallas_kernel.py:1899"),
    "sample_grad": ("sdfest_torch/csrc/sample_grad.cu",
                    "sdfest_tpu/render/pallas_kernel.py:2055"),
    "scatter": ("sdfest_torch/csrc/scatter.cu",
                "sdfest_tpu/render/pallas_kernel.py:2243"),
}


def kernels_line(report) -> str:
    out = []
    for name, (source, replaces) in SOURCES.items():
        r = report.get(name, {})
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": r.get("launches"), "max_abs_err": r.get("max_err"),
            "tol": r.get("tol"), "launches_fast": r.get("launches_fast"),
            "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
            "bound_ms": r.get("bound_ms"), "bound_by": r.get("bound_by"),
            "library_ms": None,
        })
        if "roi" in r:
            out[-1]["roi"] = r["roi"]
    return json.dumps({"kernels": out})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES}")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        parser.error(f"unknown phase in {phases}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (the decoder's Conv3d runs in full "
          "fp32, as the CPU twin does)")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from sdfest_torch.render import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc {_build.build_seconds} s) -> {sorted(paths)}")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "error" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    smoke = Smoke()
    if set(phases) & {"check", "pipeline", "fast", "time"}:
        smoke.check()
    if "pipeline" in phases:
        smoke.pipeline()
    if "fast" in phases:
        smoke.fast()
    if "time" in phases:
        smoke.time()
    if "profile" in phases:
        smoke.profile()
    print(json.dumps({
        "pipeline": smoke.report.get("_pipeline"),
        "fast": smoke.report.get("_fast"),
        "profile": {k[len("_profile_"):]: v for k, v in smoke.report.items()
                    if k.startswith("_profile_")},
        "card": card}))
    print(kernels_line(smoke.report))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
