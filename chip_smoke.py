#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one CUDA card and check it.

Run from the repository root on a machine with an H100 (or another sm_90a
card) and the CUDA toolkit:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --phases build,check   # build and check kernels only
    python3 chip_smoke.py --phases build,check,fast   # the fast.yaml path
    python3 chip_smoke.py --phases build,check,temporal   # warm refinement
    python3 chip_smoke.py --phases build,check,bf16,multiview   # slice 4
    python3 chip_smoke.py --phases build,check,batch   # refine_batch
    python3 chip_smoke.py --phases build,check,mesh,evaluate   # slice 8
    python3 chip_smoke.py --phases build,check,train   # slices 9, 13: training
    python3 chip_smoke.py --phases build,check,category,runtime   # slice 10
    python3 chip_smoke.py --phases build,check,parallel,scripts   # slice 11
    python3 chip_smoke.py --phases graph   # captured graphs against eager

Phases:
  build     compile the kernels from sdfest_torch/csrc (nvcc, sm_90a)
  check     hold each kernel against its plain PyTorch twin at main-path
            shapes (640x480 camera, decoded 64^3 mug SDF, realistic masks);
            the sampler bit for bit also on row counts that are not a
            multiple of 4, views 1 and 2 rows past the base and a
            non-binary mask; ROI marches against the crop of the full march
            (bit for bit) and against the plain ROI march, at strides 1, 2
            and 4; the tiled warm/aux march (fp32 and bf16) bit for bit,
            cold and with a real warm step's inputs, and the exact
            non-marching outputs of an all-skip frame and an all-miss pose;
            the relaxed march with and without culling; the bf16 marches
            (culling, relaxed), bf16 without culling equal to the fp32
            march, and the bf16 sample's error bound; the tiled march: the
            flat launch bit for bit equal to the 16x16 tiles, zeros on an
            all-miss pose; every kernel family at B = 8 hypotheses (one
            posed behind the camera): one batched launch equal to 8
            unbatched launches and to the batched plain version bit for
            bit (sample-grad against its twin within its tolerance, the
            scatter against its plain version on CPU copies), every march
            instance on the frame, an ROI crop and a strided raster, the
            warm march cold, mid-refinement and all-skip; the scatter at
            full frame bit for bit its plain version on CPU copies and
            REPEATS repeated launches identical (batched too); the
            estimate's latent gradient (decoder backward in
            fp32_convolutions(deterministic=True)) within 1e-5 of the CPU
            port's, beside the same gradient outside that context
  pipeline  SDFPipeline.__call__ of the mug_procedural preset with the
            committed weights on a self-rendered observation, 50 full-frame
            iterations; counts kernel launches per call and times 3 calls
  fast      the same under mug_procedural_fast (fast.yaml: ROI crop +
            [4, 2] multires): plan, launches and march rasters per call,
            rays marched, 3 timed calls; then mug_procedural_fast_adaptive
            (+ early stop): active iterations per phase and per call
  temporal  the same under mug_procedural_temporal (temporal coherence:
            the warm march every iteration): launches, skipped /
            warm-started / cold rays per call, 3 timed calls; warm against
            cold _refine from a perturbed ground-truth state
  relaxed   mug_procedural with relaxation 1.5, culling on and off:
            launches and one timed call each
  bf16      mug_procedural_bf16 (bf16_march): 50 bf16 marches and 0 fp32
            ones per call, 3 timed calls with their final losses beside the
            full frame's; one fast.yaml + bf16 call (bf16 ROI marches)
  multiview 3 views (640x480, camera poses around the mug) with init_view
            best: 150 launches of each fused kernel per call, 3 timed
            calls; the init's orientation error without and with a prior
            near the truth; one call each with a point constraint, under
            fast.yaml and under temporal coherence
  batch     SDFPipeline.refine_batch of 8 hypotheses (the init network's
            start, positions perturbed by 0.01) under the full-frame, fast,
            fast-adaptive and temporal presets: launches per iteration,
            equal to one single-hypothesis _refine's on the same plan;
            ms per call and hypothesis-iterations/s against the same 8
            starts through 8 sequential single-hypothesis _refine runs, in
            turns; two batched turns identical bit for bit, and two
            sequential turns; each hypothesis against its own run (the loss
            of iteration 0 within 1e-6, the state after the first update
            and its render's loss within EARLY_TOL, the final loss within
            FINAL_SHARE of its run's fall; whether it is bit-equal
            printed); every hypothesis's loss finite and falling
  graph     the captured CUDA graphs of __call__ and refine_batch (every
            other phase runs them too: they are the default path on the
            card) against the eager loop (graphs.eager()), on pipelines of
            their own, for full frame, fast, fast adaptive, temporal, 3
            views and refine_batch of 8 hypotheses: the first graph call of
            each key (warm-up, capture and instantiation seconds, the pools'
            MB); without shape optimization the graph call equal to the
            eager call bit for bit (estimate and every log entry) with equal
            launch counts; turns eager, graph, graph, eager on distinct
            inputs with shape optimization: ms per call (median and range),
            graph launches, kernel launches and host syncs per call (sync
            debug mode), each graph call equal to the eager call on its
            input bit for bit, and a repeated graph and eager call equal to
            the first; torch.profiler over one graph call per path (busy
            share; the scatter's five stage kernels once per call); then
            reuse_plan at 0 host syncs per call
  mesh      with the decoded mug at the first ground-truth pose:
            generate_depth (one march launch) bit for bit against its
            plain version; generate_mesh (complete_mesh off and on)
            against the CPU port's: the same face count, vertices through
            the faces within 1e-4, with the count of grid values within
            1e-5 of the level; a full-frame call with log_path, its pickle
            loaded with play_log.load_log (numpy only, 50 losses equal to
            last_log's); play_log._render_frames at stride 25 (one march
            launch per frame) and export_meshes at stride 25 (two .obj);
            the host C++ library (sdfest_torch/native): its build seconds,
            its marching tetrahedra on the decoded mug against the numpy
            path's (times, face counts, vertex chamfer < 1e-3 of the unit
            cube), and mesh_to_sdf of the generated mesh at 64^3: its sign
            equal to the decoded grid's on every cell more than 2 voxels
            from the surface
  evaluate  the port's make_procedural_dataset (seed 777, 64^3, meshes) for
            the first EVAL_MESHES held-out mugs, then the port's Evaluator
            on the card with rendering_evaluation.yaml's keys, one view,
            pose metrics, the standard and production (roi auto, [4, 2]
            multires) ablations: per file and ablation the metrics, the
            host seconds of rasterizing, the call, generate_mesh and the
            metrics, each kernel's launches per call (50 of each fused
            kernel; production marches 20 / 20 / 10 at strides 4 / 2 / 1),
            the loss falling; the means beside the JAX package's 20-mesh
            means (context, not a bound)
  category  scripts/category_evaluation's CategoryEvaluator under preset
            real275_evaluation_procedural (NOCS REAL camera: pixel_center
            0, off-centre principal point; 30 iterations at 640x480) on 4
            in-memory samples in NOCSDataset's format (CATEGORY_SHAPES: 2
            held-out procedural mugs and 2 bowls, seed 777, rasterized at
            CATEGORY_POSE): 30 launches of each fused kernel per call, no
            failure, counts 2 / 2 / 4; the init estimate (latent,
            position, scale, orientation logits) within 1e-4 (of
            max(1, max|CPU|)) of the CPU port's on the same depth, mask
            and subsampling uniforms; the witness (a stub pipeline that
            reports each sample's ground truth in the pipeline's camera
            convention): every correctness entry 1.0, position error 0;
            the march on the NOCS camera bit for bit its plain version;
            per category the means, the correctness table and the host
            seconds per sample (call, generate_mesh, metrics)
  runtime   scripts/real_data.runtime_analysis under preset
            runtime_analysis_demo (Redwood camera, 50 iterations, 11 runs
            with the first skipped, with and without shape optimization)
            on the first held-out mug (seed 777), then a torch.profiler
            trace of one warm refinement: every phase's mean finite and
            > 0, 50 launches of each fused kernel per full refinement with
            shape optimization (every refinement of a block equal), the
            trace naming march_kernel; both result blocks printed beside
            the pipeline phase's ms/call
  parallel  torch.distributed on the card (one GPU: world size 1 under
            NCCL): initialize_distributed(device="cuda") on a free
            localhost port; one VAETrainer.step(group=) through
            shard_map_data_parallel_step at the train phase's size (the
            committed mug VAE, 8 procedural mugs, pc loss at 640x480)
            against the plain step from the same state, eps and
            quaternions: loss terms within PARALLEL_TERMS_REL, parameters
            equal bit for bit, launches march 1, sample-grad 1, scatter 1,
            ms per DP step;
            sharded_refine_batch of 8 hypotheses (batch_inputs, full frame,
            50 iterations) against refine_batch on the same inputs by the
            batch phase's checks (iteration 0 within 1e-6, after the first
            update within EARLY_TOL, final loss within FINAL_SHARE),
            launches 50 per kernel each serving 8 hypotheses, ms per call
            in turns; then run_distributed in two processes that share the
            card in one gloo group, on the evaluate phase's 2 held-out
            meshes, one view: each evaluates 1 of 2, the merged statistics
            finite, one merged YAML, no partial pickle
  scripts   offset_experiment on the sphere at 640x480, 200 iterations:
            the CPU test's bars, launches march 202 (target, 200
            iterations, final render), sample-grad 200, scatter 0 (the
            SDF is fixed); the CUDA march on an analytic sphere and box at
            test_renderer.py's pose, 640x480, against the numpy golden
            renderer (render/reference.py): plain march by the golden bars,
            default march by the march tolerance; LatentExplorer.animate on
            the committed mug (11 frames, 320x240): one march launch per
            frame; benchmark_vae (64^3 decoder, forward and
            forward+backward ms) and benchmark_ops; process_shapenet of one
            generated mesh at 64^3
  train     16 procedural mugs (seed 0, 64^3); the VAE trainer of preset
            vae_mug_procedural (batch 8, pc loss at 640x480): at step 0 from
            the committed mug VAE, the pc march bit for bit its plain
            version, the pc values (1e-4) against the plain version on the
            same rows, the pc loss's grid gradient (B = 8) bit for bit the
            plain version on CPU copies, the loss terms against the CPU
            port on the same inputs, eps, quaternions and depth (rtol 1e-5,
            loss_pc 1e-4).  Then each
            trainer path as captured graphs against graphs.eager() (two
            trainers of one seed, one generator seed each; a first dispatch
            that captures, then turns eager, graph, graph, eager, ...): 20
            train_steps from a seeded fresh initialisation (every step's
            loss terms, then the parameters and Adam's state, bit for bit
            eager; the loss falling) and one past the KLD warm-up; chained
            dispatches of 10 steps on the mugs held on the card, with the
            pc loss and (one turn) with pc_weight 0, as the VAE's default
            training config sets it (each bit for bit eager);
            init_mug_procedural_v3 on views of the committed mug VAE: the
            full 131,072-sample bf16 ring on the card (one per path), the
            first generation batch's march (B = 16, 320x240) bit for bit its
            plain version and its labels against the CPU port's, chained
            replay dispatches of steps_per_dispatch = 10 units (10 steps at
            batch 64) and fresh-stream chains of 10 steps, each bit for bit
            eager (loss terms, parameters, BatchNorm statistics, Adam's
            state, the ring), the orientation CE falling; 2 eager units
            from the committed init_v3 weights.  Per path: ms per step or
            unit (median and range of the turns), torch.profiler's busy
            share of one graph dispatch, graph launches and host syncs per
            dispatch (sync debug mode), capture and warm-up s, pool MB,
            kernel launches per step against eager's and the trace's.  Then
            the fresh VAE saved as flax msgpack + YAML, loaded by
            SDFPipeline: its decoder equal to the trained one on 4 latents
            within 1e-6, generate_depth finite
  time      each kernel and its plain twin over 30 distinct inputs (CUDA
            events), with the least time the card could take (bound); the
            march also at the three ROI shapes of the fast plan, plain,
            relaxed, the warm march cold and mid-refinement, the fp32
            culling march without adaptive, and the bf16 marches; active
            16x16 tiles per render, the flat launch, all-miss poses of the
            default and bf16 marches; the scatter with zero cotangents and
            its device time per stage (profiler: main path, zero
            cotangents, B = 8) beside its buckets and contributions per
            cell, as the mug comes closer (DENSE_DISTANCES: time, plain
            and library time at B = 1 and B = 8, bound, buckets,
            contributions per cell, the cells of each gather path, stages;
            bit for bit the plain version on CPU copies), on one base cell
            of 614,400 rows (time, within 50 ms, bit for bit), at a VAE
            step's shape
            (B = 8 x 307,200 pc rows, beside its library call), and one
            full-frame graph call with the mug at 0.12 m (ms per call,
            device ms, the scatter's share); the
            sampler on hot inputs, an empty kernel at its launch geometry
            and F.grid_sample (library yardstick); sample-grad's and the
            scatter's library yardsticks (aten.grid_sampler_3d_backward:
            the point gradient, the grid gradient); the
            warm march's active tiles and an all-skip frame.  Runs without
            the check phase too (as on a parent tree, to time it in turns);
            each kernel family at B = 8 hypotheses on distinct inputs
            beside 8 times its B = 1 time and bound; sample, sample-grad,
            the scatter, the march and the empty kernel also inside one
            captured graph of their 30 launches (the host's share of a
            launch)
  profile   torch.profiler over one full-frame, fast and temporal call and
            one batched full-frame refine_batch of 8 hypotheses (the graph
            path): device busy share and the ops that take the time; runs
            the graph phase profiled in this run are not profiled again

Prints one JSON line {"kernels": [...]}, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.  Any failed check
raises, and the script then exits non-zero without that line.  It exits
non-zero at once when CUDA is not available.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

PHASES = ("build", "check", "pipeline", "fast", "temporal", "relaxed",
          "bf16", "multiview", "batch", "graph", "mesh", "evaluate",
          "category", "runtime", "parallel", "scripts", "train", "time",
          "profile")
HYPOTHESES = 8  # refine_batch's batch (bench.py's --hypotheses default)
REPEATS = 20  # repeated scatter launches held identical by the check phase
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
# locate (27) + weights (3) + 8 corners x 3 multiplies + 8 adds
OPS_SCATTER = 62
# march: per fine step = position (6) + sample (51) + test/update (~9);
# per bound step = position (6) + coarse index (15) + test/step (4);
# per ray = rotation (15) + slab test (~30)
OPS_MARCH_FINE, OPS_MARCH_BOUND, OPS_MARCH_RAY = 66, 25, 45
# warm march: + the corridor update per step (dip, min, 2 selects: ~6),
# + the warm start per ray (compare, max: 2) and 3 output selects
OPS_WARM_FINE, OPS_WARM_BOUND, OPS_WARM_RAY = 72, 31, 50
# bf16 march: a fast step = position (6) + coarse lookup (15) + locate (27)
# + 8 widenings and the lerp (21) + scale and error (3) + test/step (4); a
# verified step adds the fp32 lerp (21), its scale (1) and the fp32 test
# and update (9); the warm march adds the corridor update (6) to each
OPS_BF16_FAST, OPS_BF16_VERIFIED = 76, 107
RELAXATION = 1.5  # the relaxed paths' over-relaxation factor
# a refine_batch hypothesis against its own single-hypothesis run.  No sum
# of the refinement depends on the order blocks run in (the scatter adds
# each cell's rows in row order; the decoder's backward runs under
# fp32_convolutions(deterministic=True)), so two runs of the same call
# agree bit for bit, and the batch and graph phases hold them to that.  A
# batched hypothesis and its own single run may still part in the last
# bits: cuDNN and cuBLAS may pick other algorithms for a batch of 8 than
# for 1, and 50 Adam steps amplify that (a sphere trace that starts a last
# bit apart can stop a step earlier or later).  So against its single run:
# iteration 0 (before any update) within 1e-6; the state after the first
# update and the loss of the render it gives within EARLY_TOL; the final
# loss within FINAL_SHARE of the fall of its own run's loss; whether it is
# bit-equal is printed.  The first EARLY_SHOWN updates are printed.
EARLY_TOL = 1e-5
EARLY_SHOWN = 3
FINAL_SHARE = 0.25
# an Adam-sized step between two refinement iterations, from which the
# warm march's mid-refinement inputs are made: positions ~1e-3, the
# quaternion ~1e-2, the scale ~1e-3 relative
STEP_POSITION, STEP_QUAT, STEP_SCALE = 1e-3, 1e-2, 1e-3
# the evaluate phase: the first EVAL_MESHES meshes of the held-out set of
# rendering_evaluation_mug_procedural.yaml (make_procedural_dataset --seed
# 777 --export_meshes), one view each, under rendering_evaluation.yaml's
# keys and two of its ablations
EVAL_MESHES = 2
EVAL_CONFIG = {
    "camera_distance": 0.3, "mesh_scale": 0.1, "rel_scale": False,
    "samples": 20000, "seed": 0, "shape_optimization": True,
    "num_views": [1], "pose_metrics": True, "out_folder": None,
    "metrics": {
        "chamfer": {"f": "sdfest_tpu.pipeline.metrics.symmetric_chamfer",
                    "kwargs": {}},
        "mean_accuracy": {"f": "sdfest_tpu.pipeline.metrics.mean_accuracy",
                          "kwargs": {}},
        "mean_completeness": {
            "f": "sdfest_tpu.pipeline.metrics.mean_completeness",
            "kwargs": {}},
        "completeness_0.01": {
            "f": "sdfest_tpu.pipeline.metrics.completeness_thresh",
            "kwargs": {"threshold": 0.01}},
        "accuracy_0.01": {"f": "sdfest_tpu.pipeline.metrics.accuracy_thresh",
                          "kwargs": {"threshold": 0.01}},
    },
    "ablation_configs": {
        "standard": {},
        "production": {"roi_size": "auto", "multires_factor": [4, 2],
                       "multires_iterations": "auto"},
    },
}
# the JAX package's means over the 20 held-out meshes, one view (its TPU run
# with the init_mug_procedural network, not this script's init_v3)
JAX_EVAL_SOURCE = ("results/rend_eval_rendering_evaluation_mug_procedural_"
                   "2026-08-21_04-41-58.yaml")
JAX_EVAL_MEANS = {
    "standard": {"chamfer": 0.015005340714031415,
                 "mean_accuracy": 0.010287968052409054,
                 "mean_completeness": 0.019722713375653775,
                 "completeness_0.01": 0.46139, "accuracy_0.01": 0.64439},
    "production": {"chamfer": 0.014430986890705277,
                   "mean_accuracy": 0.010286557362328252,
                   "mean_completeness": 0.0185754164190823,
                   "completeness_0.01": 0.47758, "accuracy_0.01": 0.63532},
}
GT_POSES = [  # (position, half-width, quaternion xyzw), tilted views
    ((0.02, -0.01, -0.5), 0.1, (0.25, 0.35, 0.1, 0.895)),
    ((-0.03, 0.02, -0.55), 0.11, (-0.2, 0.4, 0.15, 0.88)),
    ((0.01, 0.03, -0.45), 0.09, (0.3, -0.25, 0.2, 0.9)),
    ((0.0, -0.02, -0.6), 0.1, (0.1, 0.6, -0.1, 0.78)),
]


# the parallel phase: the DP step's loss terms against the plain step's
# (relative), the timed DP steps; the sweep's worker (one of two processes
# sharing the card in one gloo group: argv root, coordinator, rank, config,
# the device that evaluates)
PARALLEL_TERMS_REL = 1e-5
DP_STEPS = 6
SWEEP_WORKER = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from sdfest_torch.parallel import distributed as dist
from sdfest_torch.scripts.distributed_evaluation import run_distributed
rank = int(sys.argv[3])
dist.initialize_distributed(sys.argv[2], 2, rank, device="cpu")
with open(sys.argv[4]) as f:
    config = json.load(f)
results = run_distributed(config, device=sys.argv[5])
if rank == 0:
    print("SWEEP_RESULTS " + json.dumps(results))
torch.distributed.destroy_process_group()
"""
# the scripts phase: offset_experiment's iterations (the script's default),
# the animation's frames per segment, the micro-benchmarks' timed calls
EXPERIMENT_ITERATIONS = 200
# the start of the JAX script's experiment: its position draw,
# jax.random.normal(PRNGKey(0), (3,)) in float32 (the CPU test's start too)
EXPERIMENT_NOISE = (1.622642159461975, 2.0252647399902344,
                    -0.4335944354534149)
SCRIPT_CAMERA = dict(width=640, height=480, fx=320, fy=320, cx=320, cy=240,
                     pixel_center=0.5)
ANIMATE_FRAMES = 10
BENCHMARK_ITERATIONS = 100


# the category phase: CATEGORY_PER_CLASS held-out procedural shapes of each
# class (make_procedural_dataset --seed 777) at their half max extent,
# z-buffer rendered at one tilted pose 0.6 m ahead of the NOCS REAL camera
# (OpenCV camera frame: 45 degrees about x, rim visible)
CATEGORY_PER_CLASS = 2
CATEGORY_SHAPES = (("mug", 0.11), ("bowl", 0.16))
CATEGORY_POSE = ((0.0, 0.0, 0.6), (0.3826834, 0.0, 0.0, 0.9238795))
NOCS_IDS = {"bowl": 2, "mug": 6}


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


def scatter_stage_ms(data, res) -> dict:
    """Device ms per launch of each scatter stage (SCATTER_STAGES, and the
    counts' memset; each runs once per call) over the calls
    ``k.scatter(*x, res)`` for ``x`` in ``data`` (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdfest_torch.render import kernels as k

    for x in data[:2]:
        k.scatter(*x, res)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in data:
            k.scatter(*x, res)
        torch.cuda.synchronize()
    stages = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((st for st in SCATTER_STAGES if re.search(
            rf"\b{st}_kernel[(<]", e.key)), None)
        if name is None and e.key.startswith("Memset"):
            name = "memset"
        if name is not None:
            stages[name] = e.self_device_time_total / e.count / 1e3
    return stages


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


def library_operands(rows, cot, res):
    """aten.grid_sampler_3d_backward's grid and gradient operands for rows
    ``(N, 3)`` or ``(B, N, 3)`` and their cotangents: the coordinates in
    grid_sample's (z, y, x) order as ``(B, 1, 1, N, 3)`` (sdf[x][y][z] is
    its (D, H, W)) and the cotangents of the in-volume rows ``(B, 1, 1, 1,
    N)`` (zero padding and the kernels' extrapolation differ only
    outside)."""
    from sdfest_torch.ops.interpolation import _base_and_frac

    b = rows.shape[0] if rows.ndim == 3 else 1
    inside = _base_and_frac(rows.reshape(-1, 3), res)[2].reshape(cot.shape)
    coords = rows.reshape(b, -1, 3)[..., [2, 1, 0]].reshape(b, 1, 1, -1, 3)
    return coords.contiguous(), (cot * inside).reshape(b, 1, 1, 1, -1) \
        .contiguous()


def scatter_library(inputs, res, long_sums=False, check=None):
    """The scatter's library yardstick over the scatter's ``inputs`` (rows,
    cotangents), unbatched or ``(B, ...)``, as ``(call, operands)``:
    aten.grid_sampler_3d_backward's grid half (output_mask [True, False])
    on library_operands, one call for all B grids.  The first ``check``
    inputs' grids (all by default) are held to the plain version first,
    within 1e-5 * max(1, max|want|) (the main path's rows) or, with
    ``long_sums`` (dense and batched rows, chains of up to ~1,800
    contributions that the library's float atomics add in another order),
    within the bound of a float sum in any order: 2 * (longest chain) *
    2^-24 times the largest sum of |contribution|."""
    import torch

    from sdfest_torch.ops.interpolation import trilinear_weights
    from sdfest_torch.render import kernels as k

    backward = torch.ops.aten.grid_sampler_3d_backward
    b = inputs[0][0].shape[0] if inputs[0][0].ndim == 3 else 1
    grid = torch.zeros((b, 1, res, res, res), device=inputs[0][0].device)
    ops = [library_operands(p, c, res) for p, c in inputs]
    call = lambda x: backward(x[1], grid, x[0], 0, 0, True,
                              [True, False])[0]
    for (p, _), x in zip(inputs[:check], ops[:check]):
        cot = x[1].reshape(p.shape[:-1])
        want = k.scatter_plain(p, cot, res)
        err = float((call(x).reshape(want.shape) - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        if long_sums:
            rows = p.reshape(-1, 3)[cot.reshape(-1) != 0]
            chain = int(torch.bincount(trilinear_weights(rows, res)[0]
                                       .reshape(-1)).max()) if len(rows) else 1
            sums = k.scatter_plain(p, cot.abs(), res)
            tol = max(tol, 2 * chain * 2.0 ** -24 * float(sums.max()))
        assert err <= tol, f"grid_sampler_3d_backward grid grad: {err} > {tol}"
    return call, ops


def scatter_library_ms(inputs, res, long_sums=False, check=None) -> float:
    """Mean device ms of scatter_library's call over its operands (CUDA
    events)."""
    return cuda_ms(*scatter_library(inputs, res, long_sums, check))


def gather_paths(chain) -> dict:
    """Cells per path of the scatter's gather, from the contributions per
    cell: a warp (up to GATHER_WARP), a block (up to GATHER_BLOCK), windows
    (more)."""
    return {"warp": int(((chain > 0) & (chain <= GATHER_WARP)).sum()),
            "block": int(((chain > GATHER_WARP)
                          & (chain <= GATHER_BLOCK)).sum()),
            "windows": int((chain > GATHER_BLOCK).sum())}


def free_port() -> int:
    """A free TCP port on localhost (for a process group's store)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def analytic_sphere(res: int, radius: float = 0.5):
    """Sphere SDF on the [-1, 1]^3 grid (tests/conftest.py's)."""
    import numpy as np

    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (np.sqrt(x * x + y * y + z * z) - radius).astype(np.float32)


def analytic_box(res: int, half_extents=(0.4, 0.3, 0.5)):
    """Axis-aligned box SDF on the [-1, 1]^3 grid (tests/conftest.py's)."""
    import numpy as np

    c = np.linspace(-1.0, 1.0, res)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    q = np.stack([np.abs(x) - half_extents[0], np.abs(y) - half_extents[1],
                  np.abs(z) - half_extents[2]], axis=-1)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return (outside + inside).astype(np.float32)


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
        self.adaptive_pipe = SDFPipeline(
            preset("mug_procedural_fast_adaptive"), device=self.dev)
        self.temporal_pipe = SDFPipeline(preset("mug_procedural_temporal"),
                                         device=self.dev)
        self.relaxed_pipes = {}
        for culling in (True, False):
            config = preset("mug_procedural")
            config.update(relaxation=RELAXATION, coarse_culling=culling)
            self.relaxed_pipes[culling] = SDFPipeline(config, device=self.dev)
        self.bf16_pipe = SDFPipeline(preset("mug_procedural_bf16"),
                                     device=self.dev)
        self.bf16_fast_pipe = SDFPipeline(
            dict(preset("mug_procedural_fast"), bf16_march=True),
            device=self.dev)
        # multi-view: init_view best on the full-frame, fast and temporal
        # presets
        self.mv_pipe, self.mv_fast_pipe, self.mv_temporal_pipe = (
            SDFPipeline(dict(preset(name), init_view="best"), device=self.dev)
            for name in ("mug_procedural", "mug_procedural_fast",
                         "mug_procedural_temporal"))
        self.camera = self.pipe.camera
        gen = torch.Generator(device="cpu").manual_seed(0)
        self.latent = (0.5 * torch.randn(1, 8, generator=gen)).to(self.dev)
        with torch.no_grad():
            self.sdf = self.pipe._decode(self.latent)[0, 0].contiguous()
        # each kernel's entry (the check phase fills them first; the time
        # phase runs without it too, as on a parent tree)
        self.report = {
            "sample": {}, "sample_grad": {}, "scatter": {},
            "march": {"roi": {}}, "march_warm": {}, "march_relaxed": {},
            "march_bf16": {"culling": {}, "relaxed": {}, "warm": {}}}

    # -- helpers -----------------------------------------------------------

    def pose(self, pos, q, half):
        """The march's pose operand of a pose (position, quaternion,
        half-width)."""
        import torch

        from sdfest_torch.render import kernels

        return kernels.pose_params(
            torch.as_tensor(pos, dtype=torch.float32, device=self.dev),
            unit_quat(q, self.dev),
            torch.tensor(1.0 / float(half), device=self.dev))

    def warm_step(self, gt, seed):
        """The warm march's inputs in mid-refinement near pose ``gt``: the
        warm state of a cold warm march at ``gt``, then an Adam-sized move
        (STEP_*) and the ``(pose, t_init, skip)`` that warm_render_step
        derives for the new pose (motion from ``motion_bound``)."""
        import torch

        from sdfest_torch.render import api, kernels as k, plain, warm

        pos, half, q = gt
        thr = self.pipe.config["threshold"]
        rays = api.ray_set(self.camera, self.dev).march
        shape = rays.shape[:2]
        pose0 = self.pose(pos, q, half)
        outs = k.march_warm(self.sdf, rays, pose0,
                            torch.full(shape, -1.0, device=self.dev),
                            torch.zeros(shape, device=self.dev), thr, 500)
        _, t_min, _ = plain.ray_interval(rays.reshape(-1, 3), pose0)
        state = dict(zip(plain.WARM_OUTPUTS[1:], outs[1:]),
                     hit=(outs[0] > 0).float(), t0=t_min.reshape(shape),
                     macc=torch.zeros(shape, device=self.dev))
        g = torch.Generator(device="cpu").manual_seed(seed)
        d = lambda n, s: (s * torch.randn(n, generator=g)).tolist()
        pos1 = [a + b for a, b in zip(pos, d(3, STEP_POSITION))]
        q1 = unit_quat([a + b for a, b in zip(unit_quat(q, "cpu").tolist(),
                                             d(4, STEP_QUAT))], self.dev)
        half1 = half * (1.0 + d(1, STEP_SCALE)[0])
        t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                      device=self.dev)
        motion = warm.motion_bound(t(pos1), q1, t(half1), self.sdf, {
            "position": t(pos), "orientation": unit_quat(q, self.dev),
            "scale": t(half), "sdf": self.sdf})
        pose1 = self.pose(pos1, q1, half1)
        t_init, skip, _ = warm.warm_inputs(state, rays, pose1, motion, False,
                                           thr)
        return pose1, t_init.contiguous(), skip.contiguous()

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

    def backward_rows(self, gt, seed, gen):
        """The fused backward's rows of ``queries(gt, 0.01, seed)`` (the
        surrogate queries, then the pc queries) and their cotangents, drawn
        from ``gen`` on the active rows (0 elsewhere)."""
        import torch

        s, sm, o, m = self.queries(gt, 0.01, seed)
        m = torch.cat([sm, m])
        cot = torch.randn(m.shape[0], generator=gen).to(self.dev)
        return torch.cat([s, o]).contiguous(), (cot * m).contiguous()

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
        # sample: the pc values of the fused forward (N = H*W), then rows
        # that are not a multiple of 4, views one and two rows past the
        # tensors' base, and a non-binary mask
        n = obj.shape[0]
        scale = torch.rand(n, generator=torch.Generator().manual_seed(5))
        cases = {"main path": (obj, pc_m),
                 "n % 4 == 3": (obj[:n - 1], pc_m[:n - 1]),
                 "offset by one row": (obj[1:], pc_m[1:]),
                 "offset by two rows, n % 4 == 2": (obj[2:], pc_m[2:]),
                 "non-binary mask": (obj, (pc_m * scale.to(self.dev))
                                     .contiguous())}
        err = 0.0
        for label, (pts, mask) in cases.items():
            got = k.sample(self.sdf, pts, mask)
            want = k.sample_plain(self.sdf, pts, mask)
            err = max(err, float((got - want).abs().max()))
            print(f"check sample {label}: N={pts.shape[0]} base "
                  f"{pts.data_ptr() % 16}/{mask.data_ptr() % 16} bytes past "
                  f"16 (points/mask), active {int((mask != 0).sum())}, bit "
                  f"for bit {torch.equal(got, want)}")
            assert torch.equal(got, want), f"sample differs: {label}"
        self.report["sample"] = dict(max_err=err, tol="bit for bit", n=n,
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
        cot = (torch.randn(pts.shape[0], generator=gen).to(self.dev)
               * m).contiguous()
        got = k.scatter(pts, cot, res)
        # the plain version on CPU copies adds each cell's rows in row
        # order, as the kernel does (on the card index_add_ takes atomics)
        want = k.scatter_plain(pts.cpu(), cot.cpu(), res)
        es = float((got.cpu() - want).abs().max())
        repeats = all(torch.equal(k.scatter(pts, cot, res), got)
                      for _ in range(REPEATS))
        print(f"check scatter     N={pts.shape[0]} active "
              f"{int((cot != 0).sum())}: bit for bit the plain version on "
              f"CPU copies {torch.equal(got.cpu(), want)} (max|d| "
              f"{es:.3e}); {REPEATS} repeated launches identical {repeats}")
        assert torch.equal(got.cpu(), want), "scatter differs from its plain"
        assert repeats, "scatter differs between launches"
        self.report["scatter"] = dict(
            max_err=es, tol="bit for bit (plain on CPU copies)",
            n=pts.shape[0], active=int((cot != 0).sum()),
            repeats_identical=REPEATS)
        self.check_latent_gradient()
        # march, at every ground-truth pose, with and without culling +
        # adaptive relaxation
        dirs = plain.pixel_directions(self.camera, self.dev)
        self.report["march"] = dict(
            max_err=0.0, agreement=1.0,
            tol="hit agreement > 0.995, |ddepth| < 5e-3")
        for culling in (True, False):
            for pos, half, q in GT_POSES:
                pose = self.pose(pos, q, half)
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
        self.check_warm()
        self.check_relaxed()
        self.check_bf16()
        self.check_tiles()
        self.check_batch()

    def check_latent_gradient(self):
        """The latent gradient of one decoder forward and backward (batch
        1, latent 8, a seeded cotangent on the 64^3 output) as the estimate
        takes it with shape optimization, inside fp32_convolutions(
        deterministic=True), with cuDNN's TF32 switch at PyTorch's default:
        within 1e-5 of the largest value of the CPU port's and equal on a
        second run.  Beside it the same gradient outside the context
        (cuDNN's default flags), printed."""
        import torch

        from sdfest_torch.models.vae import fp32_convolutions
        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.utils.presets import preset

        def grad(pipe, latent, cot):
            z = latent.clone().requires_grad_(True)
            return torch.autograd.grad((pipe._decode(z) * cot).sum(), z)[0]

        g = torch.Generator().manual_seed(3)
        latent = 0.5 * torch.randn(1, 8, generator=g)
        cot = torch.randn(1, 1, 64, 64, 64, generator=g)
        with fp32_convolutions(deterministic=True):
            want = grad(SDFPipeline(preset("mug_procedural"), device="cpu"),
                        latent, cot)
        args = (self.pipe, latent.to(self.dev), cot.to(self.dev))
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with fp32_convolutions(deterministic=True):
                got = [grad(*args).cpu() for _ in range(2)]
            bare = grad(*args).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = before
        scale = float(want.abs().max())
        err = float((got[0] - want).abs().max())
        bare_err = float((bare - want).abs().max())
        print(f"check latent gradient (decoder, batch 1, latent 8, 64^3 "
              f"cotangent) against the CPU port's: in fp32_convolutions("
              f"deterministic=True) max|d| {err:.3e} = {err / scale:.3e} of "
              f"max|g| {scale:.4e} (tol 1e-5 of it), second run equal "
              f"{torch.equal(got[0], got[1])}; outside the context max|d| "
              f"{bare_err:.3e} = {bare_err / scale:.3e} of max|g|")
        assert torch.equal(got[0], got[1]), "latent gradient run to run"
        assert err <= 1e-5 * scale, f"latent gradient off the CPU's {err}"
        self.report["_latent_gradient"] = dict(
            max_err=err, rel=err / scale, bare_max_err=bare_err,
            bare_rel=bare_err / scale)

    def check_tiles(self):
        """The tiled march at every pose: the flat (N, 3) launch of 1-D
        blocks gives the 16x16-tile launch's depth bit for bit, for the
        culling + adaptive, no-adaptive, relaxed culling and bf16 marches;
        with the object behind the camera the tiles give zeros."""
        import torch

        from sdfest_torch.render import api, kernels as k

        thr = self.pipe.config["threshold"]
        rays = api.ray_set(self.camera, self.dev).march
        flat = rays.reshape(-1, 3)
        marches = {"culling_adaptive": (True, 1.0, False),
                   "no_adaptive": (False, 1.0, False),
                   "relaxed_culling": (True, RELAXATION, False),
                   "bf16": (True, 1.0, True)}
        for i, (pos, half, q) in enumerate(GT_POSES):
            pose = self.pose(pos, q, half)
            behind = self.pose((pos[0], pos[1], -pos[2]), q, half)
            for name, (adaptive, relaxation, bf16) in marches.items():
                kw = dict(relaxation=relaxation, bf16=bf16)
                want = k.march(self.sdf, rays, pose, thr, 500, True, adaptive,
                               **kw)
                same = torch.equal(want.reshape(-1), k.march(
                    self.sdf, flat, pose, thr, 500, True, adaptive, **kw))
                zeros = not bool(k.march(
                    self.sdf, rays, behind, thr, 500, True, adaptive,
                    **kw).any())
                assert int((want > 0).sum()) > 3000, "too few hits"
                assert same, f"{name}: tiles and flat launch differ"
                assert zeros, f"{name}: all-miss pose not all zeros"
            print(f"check march tiles pose {i}: the flat launch equals the "
                  f"16x16 tiles bit for bit ({', '.join(marches)}); all-miss "
                  f"zeros")

    def hypothesis_inputs(self):
        """HYPOTHESES hypotheses on the mug: grids ``(B, R, R, R)`` (the
        decoded mug, scaled by 1, 1.01 or 1.02), the ground-truth poses of
        each (GT_POSES in turn, the second round's positions jittered by
        0.01) and poses ``(B, 14)``; the last hypothesis has the mug behind
        the camera, so it misses the frame."""
        import torch

        g = torch.Generator(device="cpu").manual_seed(21)
        gts = []
        for b in range(HYPOTHESES):
            pos, half, q = GT_POSES[b % len(GT_POSES)]
            if b >= len(GT_POSES):
                pos = [a + 0.01 * float(x)
                       for a, x in zip(pos, torch.randn(3, generator=g))]
            gts.append((list(pos), half, q))
        pos, half, q = gts[-1]
        gts[-1] = ([pos[0], pos[1], -pos[2]], half, q)
        grids = torch.stack([self.sdf * (1.0 + 0.01 * (b % 3))
                             for b in range(HYPOTHESES)]).contiguous()
        poses = torch.stack([self.pose(p, q, h) for p, h, q in gts])
        return grids, gts, poses.contiguous()

    def check_batch(self):
        """Every kernel family at B = HYPOTHESES (hypothesis_inputs: one
        misses the frame): one batched launch of each equals B unbatched
        launches of the same kernel bit for bit, and its batched plain
        version (a loop of unbatched twins) likewise; sample-grad against
        the twin at the check's tolerance, the scatter against its plain
        version on CPU copies and over REPEATS repeated launches.  Every march
        instance on the frame, the fast plan's full-resolution ROI crop and
        its stride-4 raster; both warm instances cold, mid-refinement (each
        hypothesis's own warm step) and all-skip."""
        import torch

        from sdfest_torch.render import api, kernels as k, plain

        thr = self.pipe.config["threshold"]
        n_hyp = HYPOTHESES
        grids, gts, poses = self.hypothesis_inputs()
        frame = api.ray_set(self.camera, self.dev).march
        (f_c, roi_c), (_, roi_f) = ROI_SHAPES[0], ROI_SHAPES[-1]
        strided = self.roi_inputs(GT_POSES[0], f_c, roi_c)[0]
        crop = self.roi_inputs(GT_POSES[0], 1, roi_f)[2]
        ray_sets = {"frame": frame, f"roi_{roi_f[0]}x{roi_f[1]}": crop,
                    f"stride_{f_c}": strided}
        instances = {  # (culling, adaptive, relaxation, bf16)
            "culling_adaptive": (True, True, 1.0, False),
            "culling_no_adaptive": (True, False, 1.0, False),
            "plain": (False, False, 1.0, False),
            "relaxed_culling": (True, True, RELAXATION, False),
            "relaxed_no_culling": (False, True, RELAXATION, False),
            "bf16_culling": (True, True, 1.0, True),
            "bf16_relaxed": (True, True, RELAXATION, True)}

        def one_launch(fn, *args, **kw):
            torch.cuda.synchronize()
            k.reset_launches()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wrapper = k.KERNELS[fn.__name__]
            assert (wrapper.launches, wrapper.hypotheses) == (1, n_hyp), (
                f"{fn.__name__}: {wrapper.launches} launches for "
                f"{wrapper.hypotheses} hypotheses")
            return out

        for name, (culling, adaptive, relaxation, bf16) in instances.items():
            kw = dict(relaxation=relaxation, bf16=bf16)
            for label, rays in ray_sets.items():
                got = one_launch(k.march, grids, rays, poses, thr, 500,
                                 culling, adaptive, **kw)
                each = all(torch.equal(got[b], k.march(
                    grids[b], rays, poses[b], thr, 500, culling, adaptive,
                    **kw)) for b in range(n_hyp))
                twin = torch.equal(got.reshape(n_hyp, -1), plain.march_plain(
                    grids, rays.reshape(-1, 3), poses, thr, 500, culling,
                    adaptive, **kw))
                hits = [int((d > 0).sum()) for d in got]
                print(f"check batch march {name} {label}: B={n_hyp} in one "
                      f"launch; equals {n_hyp} launches {each}, the batched "
                      f"twin {twin}; hits per hypothesis {hits}")
                assert each and twin, f"batched march {name} {label} differs"
                assert hits[-1] == 0 and hits[0] > 0, hits
        # the warm march: cold, each hypothesis's own warm step, all skipped
        shape = (n_hyp, *frame.shape[:2])
        cold = (torch.full(shape, -1.0, device=self.dev),
                torch.zeros(shape, device=self.dev))
        steps = [self.warm_step(gt, 40 + b) for b, gt in enumerate(gts[:-1])]
        mid = (torch.stack([s[0] for s in steps] + [poses[-1]]),
               torch.stack([s[1] for s in steps] + [cold[0][-1]]),
               torch.stack([s[2] for s in steps] + [cold[1][-1]]))
        cases = {"cold": (poses, *cold), "mid-refinement": mid,
                 "all skipped": (poses, cold[0], torch.ones(shape,
                                                           device=self.dev))}
        for label, (pose, t_init, skip) in cases.items():
            t_init, skip = t_init.contiguous(), skip.contiguous()
            for bf16 in (False, True):
                got = one_launch(k.march_warm, grids, frame, pose, t_init,
                                 skip, thr, 500, bf16=bf16)
                each = all(all(torch.equal(g[b], w) for g, w in zip(
                    got, k.march_warm(grids[b], frame, pose[b], t_init[b],
                                      skip[b], thr, 500, bf16=bf16)))
                    for b in range(n_hyp))
                twin = all(torch.equal(g.reshape(n_hyp, -1), w) for g, w in
                           zip(got, plain.march_warm_plain(
                               grids, frame.reshape(-1, 3), pose,
                               t_init.reshape(n_hyp, -1),
                               skip.reshape(n_hyp, -1), thr, 500, bf16=bf16)))
                print(f"check batch march_warm{' bf16' if bf16 else ''} "
                      f"{label}: B={n_hyp} in one launch; all six outputs "
                      f"equal {n_hyp} launches {each}, the batched twin "
                      f"{twin}; skipped {int(skip.sum())} warm-started "
                      f"{int((t_init >= 0).sum())}")
                assert each and twin, f"batched warm march {label} differs"
        # the samplers and the scatter on each hypothesis's main-path
        # queries (the last one's observation is empty: every row masked)
        q = [self.queries(gt, 0.01, 60 + b) for b, gt in enumerate(gts)]
        obj = torch.stack([x[2] for x in q])
        pc_m = torch.stack([x[3] for x in q])
        got = one_launch(k.sample, grids, obj, pc_m)
        each = all(torch.equal(got[b], k.sample(grids[b], obj[b], pc_m[b]))
                   for b in range(n_hyp))
        twin = torch.equal(got, k.sample_plain(grids, obj, pc_m))
        print(f"check batch sample: B={n_hyp} x N={obj.shape[1]} in one "
              f"launch; equals {n_hyp} launches {each}, the batched twin "
              f"{twin}; active rows {[int(m.sum()) for m in pc_m]}")
        assert each and twin, "batched sample differs"
        pts = torch.stack([torch.cat([x[0], x[2]]) for x in q]).contiguous()
        m = torch.stack([torch.cat([x[1], x[3]]) for x in q]).contiguous()
        v, gr = one_launch(k.sample_grad, grids, pts, m)
        each = all(all(torch.equal(a, b) for a, b in zip(
            (v[b], gr[b]), k.sample_grad(grids[b], pts[b], m[b])))
            for b in range(n_hyp))
        wv, wg = k.sample_grad_plain(grids, pts, m)
        ev, eg = float((v - wv).abs().max()), float((gr - wg).abs().max())
        print(f"check batch sample_grad: B={n_hyp} x N={pts.shape[1]} in one "
              f"launch; equals {n_hyp} launches {each}; vs the batched twin "
              f"value {ev:.3e} (tol 1e-4) grad {eg:.3e} (tol 1e-3)")
        assert each and ev <= 1e-4 and eg <= 1e-3, "batched sample_grad"
        gen = torch.Generator(device="cpu").manual_seed(22)
        cot = (torch.randn(m.shape, generator=gen).to(self.dev)
               * m).contiguous()
        res = self.sdf.shape[0]
        got = one_launch(k.scatter, pts, cot, res)
        each = all(torch.equal(got[b], k.scatter(pts[b], cot[b], res))
                   for b in range(n_hyp))
        twin = torch.equal(got.cpu(), k.scatter_plain(pts.cpu(), cot.cpu(),
                                                      res))
        repeats = all(torch.equal(one_launch(k.scatter, pts, cot, res), got)
                      for _ in range(REPEATS))
        print(f"check batch scatter: B={n_hyp} x N={pts.shape[1]} in one "
              f"launch; equals {n_hyp} launches {each}, the batched plain "
              f"version on CPU copies {twin}; {REPEATS} repeated batched "
              f"launches identical {repeats}")
        assert each and twin and repeats, "batched scatter differs"
        for name in ("march", "march_warm", "march_relaxed", "march_bf16",
                     "sample", "sample_grad", "scatter"):
            self.report[name].setdefault("batch", {}).update(
                hypotheses=n_hyp, check="one launch == %d launches and the "
                "batched twin (bit for bit; sample-grad vs twin 1e-4/1e-3; "
                "the scatter's twin on CPU copies)" % n_hyp)

    def check_bf16(self):
        """The bf16-verified marches against their twins at every pose: the
        culling march (relaxation 1) and the relaxed culling march (1.5)
        (the bf16 warm march: check_warm); with culling off, bf16 is the
        fp32 march bit for bit.  Then the bf16 sample's error bound over 1 M
        points of the decoded mug."""
        import torch

        from sdfest_torch.ops.interpolation import sample_sdf
        from sdfest_torch.render import api, kernels as k, plain

        thr = self.pipe.config["threshold"]
        rays = api.ray_set(self.camera, self.dev).march
        flat = rays.reshape(-1, 3)
        shape = rays.shape[:2]
        r = self.report["march_bf16"] = dict(
            max_err=0.0, agreement=1.0,
            tol="hit agreement > 0.995, |ddepth| < 5e-3; warm: all six "
                "outputs bit for bit; culling off: equal to the fp32 march; "
                "sample error <= BF16_ERR * amax",
            culling={}, relaxed={}, warm={})

        def bar(entry, got, want, label):
            hit_g, hit_w = got > 0, want > 0
            agree = float((hit_g == hit_w).float().mean())
            both = hit_g & hit_w
            dd = float((got - want)[both].abs().max())
            print(f"check march_bf16 {label}: hits {int(hit_w.sum())} "
                  f"agreement {agree:.6f} max|ddepth| {dd:.3e}")
            assert int(hit_w.sum()) > 3000, "too few hits"
            assert agree > 0.995 and dd < 5e-3, "bf16 march disagrees"
            for e in (entry, r):
                e["max_err"] = max(e.get("max_err", 0.0), dd)
                e["agreement"] = min(e.get("agreement", 1.0), agree)

        for key, relaxation in (("culling", 1.0), ("relaxed", RELAXATION)):
            equal = True
            for i, (pos, half, q) in enumerate(GT_POSES):
                pose = self.pose(pos, q, half)
                got = k.march(self.sdf, rays, pose, thr, 500, True, True,
                              relaxation=relaxation, bf16=True)
                steps = {}
                want = plain.march_plain(
                    self.sdf, flat, pose, thr, 500, True, True, steps=steps,
                    relaxation=relaxation, bf16=True).reshape(shape)
                bar(r[key], got, want, f"{key} pose {i} steps {steps}")
                no_cull = [k.march(self.sdf, rays, pose, thr, 500, False,
                                   False, relaxation=relaxation, bf16=b)
                           for b in (True, False)]
                equal = equal and torch.equal(*no_cull)
            print(f"check march_bf16 {key} without culling equals the fp32 "
                  f"march: {equal}")
            assert equal, "bf16 without culling differs from the fp32 march"
            r[key]["no_culling_equals_fp32"] = equal
        # the error bound of a bf16 sample, 1 M points in the box
        gen = torch.Generator(device="cpu").manual_seed(6)
        pts = (torch.rand(1_000_000, 3, generator=gen) * 2.0 - 1.0).to(
            self.dev)
        err = (sample_sdf(plain.bf16_corners(self.sdf), pts)
               - sample_sdf(self.sdf, pts)).abs()
        amax = plain.coarse_lookup(plain.coarse_max_table(self.sdf), pts)
        ratio = float((err / amax).max())
        print(f"check bf16 sample error over 1M points: max |bf16 - fp32| / "
              f"amax {ratio:.4e} (constant {plain.BF16_ERR}, derived 2^-8 = "
              f"{2.0 ** -8:.4e})")
        assert ratio <= plain.BF16_ERR, "bf16 sample error above its bound"
        r["sample_error_over_amax"] = ratio

    def check_warm(self):
        """The tiled warm/aux march, both instances (fp32 and bf16),
        against its twin at every pose, cold and with a real warm step's
        inputs: all six outputs bit for bit.  Then, at every pose, a frame
        where every ray is skipped and a pose with the object behind the
        camera: depth, v0, min_dip and v_last 0, t == t_last == t0 exactly
        (no tile marches, so none copies the table)."""
        import torch

        from sdfest_torch.render import api, kernels as k, plain

        thr = self.pipe.config["threshold"]
        rays = api.ray_set(self.camera, self.dev).march
        shape = rays.shape[:2]
        flat = rays.reshape(-1, 3)
        r = self.report["march_warm"] = dict(
            max_err=0.0, tol="all six outputs equal to the twin's (bit for "
            "bit); all skipped and all miss: zeros, t == t_last == t0")
        cold = (torch.full(shape, -1.0, device=self.dev),
                torch.zeros(shape, device=self.dev))
        for i, gt in enumerate(GT_POSES):
            pos, half, q = gt
            for label, (pose, t_init, skip) in (
                    ("cold", (self.pose(pos, q, half), *cold)),
                    ("mid-refinement", self.warm_step(gt, 10 + i))):
                for bf16 in (False, True):
                    got = k.march_warm(self.sdf, rays, pose, t_init, skip,
                                       thr, 500, bf16=bf16)
                    want = [x.reshape(shape) for x in plain.march_warm_plain(
                        self.sdf, flat, pose, t_init.reshape(-1),
                        skip.reshape(-1), thr, 500, bf16=bf16)]
                    errs = [float((g - w).abs().max())
                            for g, w in zip(got, want)]
                    equal = all(torch.equal(g, w) for g, w in zip(got, want))
                    print(f"check march_warm{' bf16' if bf16 else ''} pose "
                          f"{i} {label}: hits {int((want[0] > 0).sum())} "
                          f"skipped {int(skip.sum())} warm-started "
                          f"{int((t_init >= 0).sum())}; max|d| per output "
                          f"{dict(zip(plain.WARM_OUTPUTS, errs))}; bit for "
                          f"bit {equal}")
                    assert int((want[0] > 0).sum()) > 3000, "too few hits"
                    assert equal, "the warm march differs from its twin"
        for i, (pos, half, q) in enumerate(GT_POSES):
            pose = self.pose(pos, q, half)
            behind = self.pose((pos[0], pos[1], -pos[2]), q, half)
            for label, pose, skip in (
                    ("all skipped", pose, torch.ones(shape, device=self.dev)),
                    ("all miss", behind, cold[1])):
                hit, t_min, t_max = (x.reshape(shape) for x in
                                     plain.ray_interval(flat, pose))
                if label == "all miss":
                    assert not bool((hit & (t_min < t_max)).any())
                for bf16 in (False, True):
                    depth, t, v0, min_dip, v_last, t_last = k.march_warm(
                        self.sdf, rays, pose, cold[0], skip, thr, 500,
                        bf16=bf16)
                    zeros = all(float(x.abs().sum()) == 0.0
                                for x in (depth, v0, min_dip, v_last))
                    at_t0 = torch.equal(t, t_min) and torch.equal(t_last,
                                                                  t_min)
                    print(f"check march_warm{' bf16' if bf16 else ''} pose "
                          f"{i} {label}: zeros {zeros}, t == t_last == t0 "
                          f"{at_t0}")
                    assert zeros and at_t0, f"{label}: not at the start"
        r["all_skipped_exact"] = r["all_miss_exact"] = True

    def check_relaxed(self):
        """The relaxed march (relaxation 1.5) against its twin at every
        pose, with and without culling."""
        from sdfest_torch.render import api, kernels as k, plain

        thr = self.pipe.config["threshold"]
        rays = api.ray_set(self.camera, self.dev).march
        r = self.report["march_relaxed"] = dict(
            max_err=0.0, agreement=1.0,
            tol="hit agreement > 0.995, |ddepth| < 5e-3")
        for culling in (True, False):
            for i, (pos, half, q) in enumerate(GT_POSES):
                pose = self.pose(pos, q, half)
                got = k.march(self.sdf, rays, pose, thr, 500, culling, True,
                              relaxation=RELAXATION)
                want = plain.march_plain(
                    self.sdf, rays.reshape(-1, 3), pose, thr, 500, culling,
                    True, relaxation=RELAXATION).reshape(got.shape)
                hit_g, hit_w = got > 0, want > 0
                agree = float((hit_g == hit_w).float().mean())
                both = hit_g & hit_w
                dd = float((got - want)[both].abs().max())
                print(f"check march relaxed {RELAXATION} culling={culling} "
                      f"pose {i}: hits {int(hit_w.sum())} agreement "
                      f"{agree:.6f} max|ddepth| {dd:.3e}")
                assert int(hit_w.sum()) > 3000, "too few hits"
                assert agree > 0.995 and dd < 5e-3, "relaxed march disagrees"
                r["max_err"] = max(r["max_err"], dd)
                r["agreement"] = min(r["agreement"], agree)

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
                pose = self.pose(pos, q, half)
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
        expect_launches(counts, n_iter)
        for name in FUSED_KERNELS:
            self.report[name]["launches"] = counts[name]
        loss = self.pipe.last_log["loss"]
        l0, l_last = float(loss[0]), float(loss[-1])
        print(f"pipeline loss it0 {l0:.6f} it{n_iter - 1} {l_last:.6f}")
        assert math.isfinite(l0) and math.isfinite(l_last) and l_last < l0
        for t in (pos, orient, scale, latent):
            assert bool(torch.isfinite(t).all()), "non-finite estimate"
        walls, witnesses, finals = [], [], []
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
            finals.append(float(loss[-1]))
            witnesses.append(self.witness(gt, (pos, orient, scale, latent)))
        mean = sum(walls) / len(walls)
        print(f"pipeline mean {mean * 1e3:.3f} ms/call, "
              f"{n_iter / mean:.1f} iterations/s")
        self.report["_pipeline"] = dict(ms_per_call=mean * 1e3,
                                        it_per_s=n_iter / mean,
                                        final_loss=finals,
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
            expect_launches(counts, n_iter)
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
        for name in FUSED_KERNELS:
            self.report[name]["launches_fast"] = calls[0]["launches"][name]
        self.report["march"]["roi"]["rasters_per_call"] = calls[0]["rasters"]
        self.report["_fast"] = dict(ms_per_call=mean * 1e3,
                                    it_per_s=n_iter / mean, calls=calls)
        self.fast_adaptive()

    def fast_adaptive(self):
        """SDFPipeline.__call__ under mug_procedural_fast_adaptive (fast.yaml
        + early stop): a warm-up and 3 timed calls, each read for its active
        iterations per phase and its launches (one of each fused-op kernel
        per active iteration)."""
        import torch

        from sdfest_torch.render import kernels

        pipe = self.adaptive_pipe
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
            levels, fine_roi, fine_iters = pipe.last_plan
            active = pipe.last_log["active"].tolist()
            per_phase, at = [], 0
            for n in [n for _, n, _ in levels] + [fine_iters]:
                per_phase.append(int(sum(active[at:at + n])))
                at += n
            n_active = int(sum(active))
            print(f"fast_adaptive call {i}: {wall * 1e3:.3f} ms ("
                  f"{'warm-up' if i == 0 else 'timed'}) active iterations "
                  f"{n_active} of {n_iter}, per phase {per_phase} of "
                  f"{[n for _, n, _ in levels] + [fine_iters]}; launches "
                  f"{counts}")
            assert len(active) == n_iter and at == n_iter
            expect_launches(counts, n_active)
            for t in (pos, orient, scale, latent):
                assert bool(torch.isfinite(t).all()), "non-finite estimate"
            calls.append(dict(active=n_active, active_per_phase=per_phase,
                              ms=wall * 1e3, launches=counts))
            if i:
                walls.append(wall)
        mean = sum(walls) / len(walls)
        print(f"fast_adaptive mean {mean * 1e3:.3f} ms/call (fast this run: "
              f"{self.report['_fast']['ms_per_call']:.3f} ms/call)")
        self.report["_fast_adaptive"] = dict(ms_per_call=mean * 1e3,
                                             calls=calls)

    def temporal(self):
        """SDFPipeline.__call__ under mug_procedural_temporal: every
        iteration renders through the warm march.  Call 0 counts launches
        and the skipped / warm-started / cold rays (summed on the device,
        read after the call); calls 1-3 are timed.  Then warm against cold
        _refine, 12 iterations from a perturbed ground-truth state."""
        import torch

        from sdfest_torch.ops import pointset, quaternion
        from sdfest_torch.render import kernels, warm

        pipe = self.temporal_pipe
        n_iter = pipe.config["max_iterations"]
        rays = self.camera.height * self.camera.width
        inputs = warm.warm_inputs
        tally = []

        def counted(*args, **kwargs):
            t_init, skip, macc = inputs(*args, **kwargs)
            tally.append(torch.stack([skip.sum(),
                                      ((t_init >= 0) & (skip <= 0)).sum()]))
            return t_init, skip, macc

        walls = []
        for i, gt in enumerate(GT_POSES):
            depth = self.observe(gt)
            torch.cuda.synchronize()
            kernels.reset_launches()
            warm.warm_inputs = counted if i == 0 else inputs
            try:
                t0 = time.perf_counter()
                pos, orient, scale, latent = pipe(depth, depth > 0)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                warm.warm_inputs = inputs
            counts = kernels.launches()
            loss = pipe.last_log["loss"]
            l0, l_last = float(loss[0]), float(loss[-1])
            print(f"temporal call {i}: {wall * 1e3:.3f} ms ("
                  f"{'counted' if i == 0 else 'timed'}) launches {counts} "
                  f"plan {pipe.last_plan} loss it0 {l0:.6f} "
                  f"it{n_iter - 1} {l_last:.6f}")
            assert pipe.last_plan == ((), None, None), "not one full frame"
            assert math.isfinite(l0) and math.isfinite(l_last) and l_last < l0
            for t in (pos, orient, scale, latent):
                assert bool(torch.isfinite(t).all()), "non-finite estimate"
            if i == 0:
                want = {"march": 0, "march_warm": n_iter, "sample": 0,
                        "sample_grad": 2 * n_iter, "scatter": 2 * n_iter}
                assert counts == want, f"launches {counts}, expected {want}"
                # call 0 captures the call's graph: the warm-up before the
                # capture tallies eagerly, then the capture tallies into
                # tensors of the graph, which its replay fills; the last
                # n_iter rows are this call's
                assert len(tally) == 2 * n_iter, len(tally)
                skipped, warm_started = (int(x) for x in torch.stack(
                    tally[-n_iter:]).sum(0).tolist())
                rays_call = dict(skipped=skipped, warm_started=warm_started,
                                 cold=n_iter * rays - skipped - warm_started)
                print(f"temporal rays per call (of {n_iter} x {rays}): "
                      f"{rays_call}")
                self.report["march_warm"]["launches"] = counts["march_warm"]
                temporal_counts = counts
            else:
                walls.append(wall)
        mean = sum(walls) / len(walls)
        full = self.report.get("_pipeline", {}).get("ms_per_call")
        print(f"temporal mean {mean * 1e3:.3f} ms/call, {n_iter / mean:.1f} "
              f"iterations/s (full-frame pipeline this run: "
              f"{'not run' if full is None else f'{full:.3f} ms/call'})")
        # warm against cold _refine from a perturbed ground-truth state
        gpos, ghalf, gq = GT_POSES[0]
        depth = self.observe(GT_POSES[0])
        points, point_mask = pointset.depth_to_pointcloud_dense(
            depth, self.camera, order="tile")
        turn = unit_quat([0.035, -0.026, 0.044, 0.998], self.dev)
        start = {"position": torch.tensor(
                     [[gpos[0] + 0.01, gpos[1] - 0.008, gpos[2] + 0.015]],
                     device=self.dev),
                 "orientation": quaternion.multiply(
                     turn, unit_quat(gq, self.dev))[None],
                 "scale": torch.tensor([ghalf * 1.1], device=self.dev),
                 "latent": self.latent}
        ends = {}
        for label, p in (("warm", pipe), ("cold", self.pipe)):
            state, _, log = p._refine(start, depth, points, point_mask,
                                      num_iterations=12)
            ends[label] = state
        d_pos = float((ends["warm"]["position"]
                       - ends["cold"]["position"]).abs().max())
        d_scale = float((ends["warm"]["scale"]
                         - ends["cold"]["scale"]).abs().max())
        print(f"temporal warm vs cold _refine, 12 iterations: max|dposition| "
              f"{d_pos:.3e} max|dscale| {d_scale:.3e} (tol 2e-3)")
        assert d_pos < 2e-3 and d_scale < 2e-3, "warm and cold refine differ"
        self.report["_temporal"] = dict(
            ms_per_call=mean * 1e3, it_per_s=n_iter / mean,
            launches=temporal_counts, rays=rays_call,
            warm_vs_cold=dict(position=d_pos, scale=d_scale, tol=2e-3))

    def relaxed(self):
        """mug_procedural with relaxation 1.5, culling on and off: the
        launches of one call (every march relaxed) and one timed call."""
        import torch

        from sdfest_torch.render import kernels

        r = self.report.setdefault("march_relaxed", {})
        for culling, pipe in self.relaxed_pipes.items():
            n_iter = pipe.config["max_iterations"]
            walls = []
            for i, gt in enumerate(GT_POSES[:2]):
                depth = self.observe(gt)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                out = pipe(depth, depth > 0)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts = kernels.launches()
                loss = pipe.last_log["loss"]
                print(f"relaxed culling={culling} call {i}: "
                      f"{walls[-1] * 1e3:.3f} ms launches {counts} loss "
                      f"{float(loss[0]):.6f} -> {float(loss[-1]):.6f}")
                expect_launches(counts, n_iter)
                assert float(loss[-1]) < float(loss[0])
                for t in out:
                    assert bool(torch.isfinite(t).all()), "non-finite"
            key = "culling" if culling else "no_culling"
            r.setdefault(key, {}).update(launches=counts["march"],
                                         ms_per_call=walls[-1] * 1e3)
        r["launches"] = r["culling"]["launches"]

    def _call(self, pipe, depth, mask, **kwargs):
        """One ``pipe(depth, mask, **kwargs)`` with the launch counts set to
        0 just before it: ``(estimate, wall s, launches, bf16 march
        launches, march rasters)``."""
        import torch

        from sdfest_torch.render import kernels

        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = pipe(depth, mask, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for t in out:
            assert bool(torch.isfinite(t).all()), "non-finite estimate"
        loss = pipe.last_log["loss"]
        assert math.isfinite(float(loss[-1])) and float(loss[-1]) < float(
            loss[0]), "the loss did not fall"
        return (out, wall, kernels.launches(), kernels.march.bf16_launches,
                dict(kernels.march.rasters))

    def orientation_error(self, q_est, q_true) -> float:
        from sdfest_torch.ops import quaternion

        return math.degrees(float(quaternion.geodesic_distance(
            q_est, unit_quat(q_true, self.dev))))

    def bf16(self):
        """SDFPipeline.__call__ under mug_procedural_bf16 (bf16_march):
        every march of a call goes through the bf16 instance (50 bf16, 0
        fp32 marches, 50 of each sampler); 3 timed calls whose final losses
        print beside the full-frame call's on the same poses; then one call
        under fast.yaml + bf16, whose ROI marches are bf16 too."""
        pipe = self.bf16_pipe
        n_iter = pipe.config["max_iterations"]
        want = {"march": n_iter, "march_warm": 0, "sample": n_iter,
                "sample_grad": n_iter, "scatter": n_iter}
        walls, finals = [], []
        for i, gt in enumerate(GT_POSES):
            depth = self.observe(gt)
            out, wall, counts, n_bf16, _ = self._call(pipe, depth, depth > 0)
            loss = pipe.last_log["loss"]
            print(f"bf16 call {i}: {wall * 1e3:.3f} ms ("
                  f"{'counted' if i == 0 else 'timed'}) launches {counts} of "
                  f"which bf16 marches {n_bf16}; loss {float(loss[0]):.6f} -> "
                  f"{float(loss[-1]):.6f}; orientation error "
                  f"{self.orientation_error(out[1][0], gt[2]):.2f} deg")
            assert counts == want and n_bf16 == n_iter, (
                f"launches {counts} (bf16 {n_bf16}), expected {want}, all bf16")
            if i == 0:
                self.report.setdefault("march_bf16", {})["launches"] = n_bf16
            else:
                walls.append(wall)
                finals.append(float(loss[-1]))
        mean = sum(walls) / len(walls)
        full = self.report.get("_pipeline", {})
        print(f"bf16 mean {mean * 1e3:.3f} ms/call; final losses {finals} "
              f"(full frame on the same poses: "
              f"{full.get('final_loss', 'not run')}, "
              f"{full.get('ms_per_call', float('nan')):.3f} ms/call)")
        # fast.yaml + bf16: the ROI marches of every level are bf16
        depth = self.observe(GT_POSES[0])
        _, wall, counts, n_bf16, rasters = self._call(self.bf16_fast_pipe,
                                                      depth, depth > 0)
        print(f"bf16 fast call: {wall * 1e3:.3f} ms plan "
              f"{self.bf16_fast_pipe.last_plan} launches {counts} bf16 "
              f"marches {n_bf16} rasters {rasters}")
        assert counts == want and n_bf16 == n_iter
        assert len(rasters) == 3, "the fast plan's three ROI shapes"
        self.report["_bf16"] = dict(
            ms_per_call=mean * 1e3, it_per_s=n_iter / mean, final_loss=finals,
            launches=dict(want, march_bf16=n_iter),
            fast=dict(ms=wall * 1e3, launches=counts, march_bf16=n_bf16,
                      rasters={f"{h}x{w}": c for (h, w), c in
                               rasters.items()}))

    def multiview_inputs(self, gt=GT_POSES[0]):
        """V = 3 views (640x480 each) of the mug at pose ``gt`` (GT pose 0
        unless given), whose frame is the world: camera 0 at the origin,
        cameras 1 and 2 turned by -35 and +35 deg about the vertical axis
        through the mug's center.  Returns the depths (3, H, W), the
        cameras' world poses (3, 3)/(3, 4) and the mug's orientation in
        each camera's frame (3, 4)."""
        import torch

        from sdfest_torch.ops import quaternion

        pos, half, q = gt
        p_obj = torch.tensor(pos, device=self.dev)
        q_obj = unit_quat(q, self.dev)
        depths, cam_pos, cam_q, q_in_cam = [], [], [], []
        for deg in (0.0, -35.0, 35.0):
            a = math.radians(deg) / 2
            q_cam = torch.tensor([0.0, math.sin(a), 0.0, math.cos(a)],
                                 device=self.dev)
            c = quaternion.apply(q_cam, -p_obj) + p_obj
            inv = quaternion.invert(q_cam)
            pos_c = quaternion.apply(inv, p_obj - c)
            quat_c = quaternion.multiply(inv, q_obj)
            depths.append(self.render(self.sdf, pos_c.tolist(),
                                      quat_c.tolist(), half))
            cam_pos.append(c)
            cam_q.append(q_cam)
            q_in_cam.append(quat_c)
        for d in depths:
            assert int((d > 0).sum()) > 3000, "a view shows too few pixels"
        return (torch.stack(depths), torch.stack(cam_pos),
                torch.stack(cam_q), torch.stack(q_in_cam))

    def multiview(self):
        """SDFPipeline.__call__ with V = 3 views and init_view: best: 150 of
        each fused kernel per call (one render per view per iteration), 3
        timed calls; the init's orientation error without and with a prior
        concentrated near the true orientation (a witness, not a gate); one
        call with a point constraint, one fast multi-view call (an ROI per
        view) and one temporal multi-view call (150 warm marches)."""
        import torch

        from sdfest_torch.ops import quaternion

        depth, cam_pos, cam_q, q_in_cam = self.multiview_inputs()
        mask = depth > 0
        cams = dict(camera_positions=cam_pos, camera_orientations=cam_q)
        q_true = GT_POSES[0][2]
        pipe = self.mv_pipe
        n_iter = pipe.config["max_iterations"]
        n_views = depth.shape[0]
        fused = n_views * n_iter
        want = {"march": fused, "march_warm": 0, "sample": fused,
                "sample_grad": fused, "scatter": fused}
        walls = []
        for i in range(4):
            out, wall, counts, _, _ = self._call(pipe, depth, mask, **cams)
            loss = pipe.last_log["loss"]
            print(f"multiview call {i}: {wall * 1e3:.3f} ms ("
                  f"{'counted' if i == 0 else 'timed'}) launches {counts}; "
                  f"loss {float(loss[0]):.6f} -> {float(loss[-1]):.6f}; "
                  f"orientation error "
                  f"{self.orientation_error(out[1][0], q_true):.2f} deg")
            assert counts == want, f"launches {counts}, expected {want}"
            if i:
                walls.append(wall)
        mean = sum(walls) / len(walls)
        full = self.report.get("_pipeline", {}).get("ms_per_call")
        print(f"multiview mean {mean * 1e3:.3f} ms/call for {n_views} views "
              f"(single-view full frame this run: "
              f"{'not run' if full is None else f'{full:.3f} ms/call'})")
        # the init's start, without and with a prior near the truth
        pre = pipe._preprocess_depth(depth, mask)
        sigma = math.radians(30.0)
        grid = pipe._grid_quats
        prior = torch.stack([
            torch.exp(-0.5 * (quaternion.geodesic_distance(grid, qc[None])
                              / sigma) ** 2) + 1e-6 for qc in q_in_cam])
        init = {}
        for label, pr in (("no_prior", None), ("prior", prior)):
            start = pipe._nn_init(pre, cam_pos, cam_q, torch.Generator(
                device=self.dev).manual_seed(0), pr)
            init[label] = self.orientation_error(start[3][0], q_true)
        print(f"multiview init orientation error (deg): {init}")
        out, wall, _, _, _ = self._call(
            pipe, depth, mask, prior_orientation_distribution=prior, **cams)
        prior_err = self.orientation_error(out[1][0], q_true)
        # a point constraint toward the true orientation
        source = torch.tensor([0.0, 0.0, 0.1], device=self.dev)
        target = quaternion.apply(unit_quat(q_true, self.dev), source)
        out, wall_pc, counts, _, _ = self._call(
            pipe, depth, mask, point_constraint=(source, target, 1.0), **cams)
        pc_err = self.orientation_error(out[1][0], q_true)
        print(f"multiview call with the prior: orientation error "
              f"{prior_err:.2f} deg; with a point constraint: {wall_pc * 1e3:.3f}"
              f" ms, orientation error {pc_err:.2f} deg, launches {counts}")
        assert counts == want
        # fast.yaml over views: an ROI per view at every level
        _, wall_fast, counts, _, rasters = self._call(self.mv_fast_pipe, depth,
                                                      mask, **cams)
        print(f"multiview fast call: {wall_fast * 1e3:.3f} ms plan "
              f"{self.mv_fast_pipe.last_plan} launches {counts} rasters "
              f"{rasters}")
        assert counts == want and sum(rasters.values()) == fused
        # temporal coherence over views: a warm state per view
        _, wall_warm, counts, _, _ = self._call(self.mv_temporal_pipe, depth,
                                                mask, **cams)
        want_warm = {"march": 0, "march_warm": fused, "sample": 0,
                     "sample_grad": 2 * fused, "scatter": 2 * fused}
        print(f"multiview temporal call: {wall_warm * 1e3:.3f} ms launches "
              f"{counts}")
        assert counts == want_warm, f"launches {counts}, expected {want_warm}"
        self.report["_multiview"] = dict(
            views=n_views, ms_per_call=mean * 1e3, launches=want,
            init_orientation_error_deg=init,
            prior_call_orientation_error_deg=prior_err,
            point_constraint=dict(ms=wall_pc * 1e3,
                                  orientation_error_deg=pc_err),
            fast=dict(ms=wall_fast * 1e3, rasters={
                f"{h}x{w}": c for (h, w), c in rasters.items()}),
            temporal=dict(ms=wall_warm * 1e3, launches=counts))

    def batch_inputs(self, gt=GT_POSES[0]):
        """refine_batch's inputs on the self-rendered mug at pose ``gt``
        (GT_POSES[0] unless given): the shared view ``(depth (1, H, W),
        points, point masks, camera position, camera orientation)`` and
        HYPOTHESES starts ``(N, 1, ...)``: the init network's state of the
        observation, positions perturbed by 0.01 per hypothesis (seeded),
        as bench.py perturbs its batch."""
        import torch

        obs = self.observe(gt)
        depth = self.pipe._preprocess_depth(obs, obs > 0)[None].contiguous()
        points, point_masks = self.pipe._lift(depth, 1)
        cam_p = torch.zeros(1, 3, device=self.dev)
        cam_q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.dev)
        with torch.no_grad():
            latent, position, scale, orientation = self.pipe._nn_init(
                depth, cam_p, cam_q,
                torch.Generator(device=self.dev).manual_seed(0))
        g = torch.Generator(device="cpu").manual_seed(31)
        n = HYPOTHESES
        states = {
            "position": (position + 0.01 * torch.randn(
                n, 3, generator=g).to(self.dev))[:, None].contiguous(),
            "orientation": orientation.expand(n, 4)[:, None].contiguous(),
            "scale": scale.expand(n)[:, None].contiguous(),
            "latent": latent.expand(n, -1)[:, None].contiguous()}
        return (depth, points, point_masks, cam_p, cam_q), states

    def single_refine(self, pipe, state, views, multires, roi, fine_iters):
        """One hypothesis (``state`` with ``(1, ...)`` leaves) through
        refine_batch's plan with the single-hypothesis ``_refine``: each
        coarse level of ``multires`` (``_coarse_phase``), then
        ``fine_iters`` full-resolution iterations at ``roi``.  Returns the
        final state and the log's loss and states per iteration, ``(T,
        ...)`` over all phases."""
        import torch

        from sdfest_torch.pipeline.pipeline import _normalize_multires

        depth, points, point_masks, cam_p, cam_q = views
        logs = []
        for factor, n_iters in _normalize_multires(multires):
            depth_c, points_c, masks_c, roi_c = pipe._coarse_phase(depth,
                                                                   factor)
            state, _, log = pipe._refine(
                state, depth_c, points_c, masks_c, cam_p, cam_q, True,
                n_iters, roi_c, factor, allow_early_stop=False)
            logs.append(log)
        state, _, log = pipe._refine(
            state, depth, points, point_masks, cam_p, cam_q, True,
            fine_iters, roi, 1, allow_early_stop=False)
        logs.append(log)
        return state, {k: torch.cat([lg[k] for lg in logs])
                       for k in ("loss", *state)}

    def batch(self):
        """SDFPipeline.refine_batch of HYPOTHESES hypotheses (batch_inputs)
        at 640x480, 50 iterations, under the full-frame, fast (ROI + [4, 2]
        multires), fast-adaptive (chunks) and temporal presets
        (batch_preset)."""
        views, states = self.batch_inputs()
        self.report["_batch"] = {}
        for label, pipe, adaptive in (
                ("full_frame", self.pipe, False),
                ("fast", self.fast_pipe, False),
                ("fast_adaptive", self.adaptive_pipe, True),
                ("temporal", self.temporal_pipe, False)):
            self.batch_preset(label, pipe, adaptive, views, states)

    def batch_preset(self, label, pipe, adaptive, views, states):
        """One preset of the batch phase.  Launches: one batched call and
        one single-hypothesis run of the same plan (single_refine), each
        with the counts set to 0 just before it; launches per iteration
        must be equal, each batched launch serving every hypothesis.  Then
        the batched call and the same starts through HYPOTHESES sequential
        single runs, in turns (batch, sequential, sequential, batch), on
        the host's clock around a synchronize: ms per call and
        hypothesis-iterations/s (N x iterations / s, bench.py's
        definition).  The two batched turns must equal each other bit for
        bit, and so must the two sequential ones.  Each hypothesis is held
        against its own single run (see EARLY_TOL), and every hypothesis's
        loss must be finite and fall."""
        import torch

        from sdfest_torch.pipeline.pipeline import _normalize_multires
        from sdfest_torch.render import kernels
        from sdfest_torch.utils import graphs

        n = HYPOTHESES
        multires = pipe._multires_for()
        roi = pipe._roi_for(views[0])
        coarse_iters = sum(it for _, it in _normalize_multires(multires))

        def batched():
            return pipe.refine_batch(states, *views, roi=roi,
                                     multires=multires, adaptive=adaptive)

        def sequential(fine_iters):
            return [self.single_refine(
                pipe, {k: v[b] for k, v in states.items()}, views, multires,
                roi, fine_iters) for b in range(n)]

        def counted(fn, *args):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            return (out, time.perf_counter() - t0, kernels.launches(),
                    kernels.hypotheses())

        batched()  # warm-up
        (final, _, log), _, counts, hyps = counted(batched)
        n_iter = log["loss"].shape[1]
        fine_iters = n_iter - coarse_iters
        start = {k: v[0] for k, v in states.items()}
        (_, single_log), _, single_counts, _ = counted(
            self.single_refine, pipe, start, views, multires, roi, fine_iters)
        assert single_log["loss"].shape == (n_iter,)
        per_it = {k: c / n_iter for k, c in counts.items()}
        single_per_it = {k: c / n_iter for k, c in single_counts.items()}
        per_launch = {k: hyps[k] / c for k, c in counts.items() if c}
        print(f"batch {label}: plan multires {multires} roi {roi}; "
              f"{n_iter} iterations executed; launches per iteration, "
              f"{n} hypotheses {per_it}, one hypothesis {single_per_it}; "
              f"hypotheses per launch {per_launch}")
        assert counts == single_counts, (
            f"{label}: {counts} launches for {n} hypotheses, "
            f"{single_counts} for one")
        assert all(v == n for v in per_launch.values()), per_launch
        walls = {"batched": [], "sequential": []}
        runs = {"batched": [], "sequential": []}
        for turn in ("batched", "sequential", "sequential", "batched"):
            out, wall, _, _ = counted(
                batched if turn == "batched" else sequential,
                *(() if turn == "batched" else (fine_iters,)))
            walls[turn].append(wall)
            runs[turn].append(out)
        ms = {k: 1e3 * sum(v) / len(v) for k, v in walls.items()}
        rate = {k: n * n_iter / (v / 1e3) for k, v in ms.items()}
        print(f"batch {label}: batched {ms['batched']:.3f} ms/call "
              f"{rate['batched']:.1f} hypothesis-iterations/s; {n} "
              f"sequential single-hypothesis runs {ms['sequential']:.3f} ms "
              f"{rate['sequential']:.1f} hypothesis-iterations/s; turns "
              f"{ {k: [round(w * 1e3, 3) for w in v] for k, v in walls.items()} }"
              f"; speed-up {ms['sequential'] / ms['batched']:.3f}x")
        loss = log["loss"]
        assert bool(torch.isfinite(loss).all()), "non-finite batch loss"
        falls = (loss[:, -1] < loss[:, 0]).tolist()
        print(f"batch {label}: loss per hypothesis it0 "
              f"{[round(x, 6) for x in loss[:, 0].tolist()]} last "
              f"{[round(x, 6) for x in loss[:, -1].tolist()]}")
        assert all(falls), f"{label}: a hypothesis's loss did not fall"
        singles = runs["sequential"][0]
        finals = [runs["batched"][0][0], runs["batched"][1][0]]

        def apart(state_of):
            return {k: max(float((state_of(0, b)[k] - state_of(1, b)[k])
                                 .abs().max()) for b in range(n))
                    for k in final}

        diff = apart(lambda i, b: ({k: v[b] for k, v in final.items()}
                                   if i == 0 else singles[b][0]))
        spread = {
            "sequential": apart(lambda i, b: runs["sequential"][i][b][0]),
            "batched": apart(lambda i, b: {k: v[b]
                                           for k, v in finals[i].items()})}
        loss0 = max(abs(float(loss[b, 0]) - float(singles[b][1]["loss"][0]))
                    for b in range(n))
        # log row t: the loss of iteration t's render, the state after
        # update t + 1

        def after_update(t, log_of, other_of):
            d = {k: max(float((log_of(b)[k][t] - other_of(b)[k][t])
                              .abs().max()) for b in range(n))
                 for k in final}
            d["loss"] = max(float((log_of(b)["loss"][t + 1]
                                   - other_of(b)["loss"][t + 1]).abs())
                            for b in range(n))
            return d

        batch_log = lambda b: {k: v[b] for k, v in log.items()}
        shown = [(after_update(t, batch_log, lambda b: singles[b][1]),
                  after_update(t, lambda b: singles[b][1],
                               lambda b: runs["sequential"][1][b][1]))
                 for t in range(EARLY_SHOWN)]
        early = shown[0][0]
        dloss = max(float((loss[b] - singles[b][1]["loss"]).abs().max())
                    for b in range(n))
        # each final loss against its own run's: the share of that run's fall
        share = max(abs(float(loss[b, -1]) - float(singles[b][1]["loss"][-1]))
                    / max(float(singles[b][1]["loss"][0])
                          - float(singles[b][1]["loss"][-1]), 1e-12)
                    for b in range(n))
        print(f"batch {label}: each hypothesis against its own single run: "
              f"iteration 0 loss max|d| {loss0:.3e} (tol 1e-6); after the "
              f"first update max|d| {early} (tol {EARLY_TOL}); final loss "
              f"max|d| {share:.4f} of its run's fall (tol {FINAL_SHARE}); "
              f"final state max|d| {diff}, loss over all iterations max|d| "
              f"{dloss:.3e}; run to run, two sequential turns "
              f"{spread['sequential']}, two batched turns "
              f"{spread['batched']}")
        for t, (d, seq) in enumerate(shown):
            print(f"batch {label}: after update {t + 1}, max|d| against its "
                  f"own single run {max(d.values()):.3e} {d}; two "
                  f"sequential single runs {max(seq.values()):.3e}")
        # run to run: every tensor of two batched turns, and of two
        # sequential turns, bit for bit
        leaves = lambda run: graphs.flatten(run)[0]
        same = {turn: all(torch.equal(a, b) for a, b in zip(
            leaves(runs[turn][0]), leaves(runs[turn][1])))
            for turn in runs}
        single_equal = dloss == 0.0 and not any(diff.values())
        print(f"batch {label}: two batched turns identical "
              f"{same['batched']}, two sequential turns identical "
              f"{same['sequential']}; each hypothesis bit-equal to its own "
              f"single run {single_equal}")
        assert all(same.values()), f"{label}: runs differ {same}"
        assert not any(v for s in spread.values() for v in s.values()), (
            label, spread)
        assert loss0 <= 1e-6, f"{label}: iteration 0 loss differs {loss0}"
        assert max(early.values()) <= EARLY_TOL, f"{label}: {early}"
        assert share <= FINAL_SHARE, f"{label}: final loss {share}"
        self.report["_batch"][label] = dict(
            hypotheses=n, iterations=n_iter, plan=[multires, roi],
            launches_per_iteration=per_it,
            launches_per_iteration_single=single_per_it,
            hypotheses_per_launch=per_launch,
            ms_per_call=ms["batched"], hyp_it_per_s=rate["batched"],
            sequential_ms=ms["sequential"],
            sequential_hyp_it_per_s=rate["sequential"],
            walls_ms={k: [w * 1e3 for w in v] for k, v in walls.items()},
            max_diff_vs_single=diff, max_loss_diff_vs_single=dloss,
            iteration0_loss_diff=loss0, early_diff=early,
            early_shown=[dict(batched_vs_single=d, sequential=q)
                         for d, q in shown],
            final_loss_share=share, run_to_run=spread,
            run_to_run_identical=same, bit_equal_to_single=single_equal,
            loss_first=loss[:, 0].tolist(), loss_last=loss[:, -1].tolist())
        if label == "full_frame":
            for name in FUSED_KERNELS:
                self.report[name].setdefault("batch", {})[
                    "launches_per_iteration"] = per_it[name]

    def graph_paths(self):
        """The graph phase's paths: ``{label: (pipe, n_iter, run)}`` where
        ``run(i, shape_optimization)`` drives the path once on its input set
        ``i`` (0-2: GT_POSES[i]) and returns ``(tensors, log)``: the
        estimate's tensors and the per-iteration log."""
        from sdfest_torch.pipeline.pipeline import SDFPipeline

        batch = [self.batch_inputs(gt) for gt in GT_POSES]
        views = [self.multiview_inputs(gt)[:3] for gt in GT_POSES]
        depths = [self.observe(gt) for gt in GT_POSES]
        # pipelines of their own: their graph caches start empty, so each
        # path's captures are its own (whatever phases ran before)
        fresh = lambda pipe: SDFPipeline(pipe.config, device=self.dev)
        full, mv = fresh(self.pipe), fresh(self.mv_pipe)

        def call(pipe):
            def run(i, shape_optimization):
                d = depths[i]
                out = pipe(d, d > 0, shape_optimization=shape_optimization)
                return list(out), pipe.last_log
            return run

        def multiview(i, shape_optimization):
            d, cam_p, cam_q = views[i]
            out = mv(d, d > 0, camera_positions=cam_p,
                     camera_orientations=cam_q,
                     shape_optimization=shape_optimization)
            return list(out), mv.last_log

        def refine_batch(i, shape_optimization):
            final, best, log = batch_pipe.refine_batch(
                batch[i][1], *batch[i][0],
                shape_optimization=shape_optimization)
            return [*final.values(), *best.values()], log

        n = lambda pipe: pipe.config["max_iterations"]
        per_phase = lambda pipe: SDFPipeline(
            dict(pipe.config, fused_call=False), device=self.dev)
        paths = {}
        for label, pipe in (("full-frame", full), ("fast", self.fast_pipe),
                            ("fast-adaptive", self.adaptive_pipe),
                            ("temporal", self.temporal_pipe)):
            pipe = pipe if pipe is full else fresh(pipe)
            paths[label] = (pipe, n(pipe), call(pipe))
        # fused_call: false, one graph per phase
        for label, pipe in (("full-frame-per-phase", self.pipe),
                            ("fast-per-phase", self.fast_pipe)):
            pipe = per_phase(pipe)
            paths[label] = (pipe, n(pipe), call(pipe))
        paths["multiview-3"] = (mv, n(mv), multiview)
        batch_pipe = fresh(self.pipe)
        paths[f"batch-{HYPOTHESES}-full-frame"] = (batch_pipe, n(batch_pipe),
                                                   refine_batch)
        return paths

    def graph(self):
        """The port's captured graphs against its eager loop
        (``graphs.eager()``, the loop the earlier slices ran), per path:
        full frame, fast, fast adaptive, temporal, full frame and fast
        with ``fused_call: false``, 3 views and refine_batch of HYPOTHESES
        hypotheses (graph_paths).  Per path:
        the first graph call of each key (capture and instantiation, the
        warm-up before it, the pools' MB); without shape optimization the
        graph call against the eager call on one input, every output and
        log entry bit for bit, the launch counts equal; then turns eager,
        graph, graph, eager on inputs 1, 1, 2, 2 with shape optimization
        (the default): ms per call, graph launches, kernel launches and
        host syncs per call (torch.cuda sync debug mode), each graph call
        against the eager call on its input bit for bit (estimate, every
        log entry, launch counts), and a second graph and eager call on
        input 1 equal to the first; graph launches per call: 1
        (``fused_call: true``),
        one per phase (``false``), one per host read with early stop (the
        probe and each check); torch.profiler over one graph call (busy
        share; its kernels in the trace equal the counted launches).
        Then reuse_plan at 0 host syncs per call."""
        import torch

        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.utils.presets import preset

        card = card_line()
        self.report["_graph"] = out = {"card": card}
        for label, (pipe, n_iter, run) in self.graph_paths().items():
            out[label] = self.graph_path(label, pipe, n_iter, run)
        # reuse_plan: the first call probes, the next ones make no host sync
        pipe = SDFPipeline(dict(preset("mug_procedural"), reuse_plan=True),
                           device=self.dev)
        depths = [self.observe(gt) for gt in GT_POSES]
        pipe(depths[0], depths[0] > 0)
        syncs = []
        for d in depths[1:]:
            _, s = count_syncs(lambda: pipe(d, d > 0))
            syncs.append(s)
        torch.cuda.synchronize()
        print(f"graph reuse_plan: host syncs per call after the first "
              f"{syncs} (card {card})")
        assert not any(syncs), f"reuse_plan calls synced: {syncs}"
        out["reuse_plan_syncs"] = syncs

    def graph_path(self, label, pipe, n_iter, run):
        """One path of the graph phase (see graph)."""
        import statistics

        import torch

        from sdfest_torch.utils import graphs
        from sdfest_torch.render import kernels

        cache = pipe.graphs

        def timed(eager, i, shape_optimization=True):
            torch.cuda.synchronize()
            kernels.reset_launches()
            replays = cache.replays
            t0 = time.perf_counter()
            if eager:
                with graphs.eager():
                    tensors, log = run(i, shape_optimization)
            else:
                tensors, log = run(i, shape_optimization)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return dict(tensors=[t.clone() for t in tensors],
                        log={k: v.clone() for k, v in log.items()},
                        ms=wall * 1e3, counts=kernels.counts(),
                        graph_launches=cache.replays - replays)

        # the first graph call of each key: warm-up, capture, instantiation
        before = (cache.captures, cache.warm_up_seconds,
                  cache.capture_seconds, cache.pool_bytes)
        first = {so: timed(False, 0, so)["ms"] for so in (True, False)}
        captured = dict(
            graphs=cache.captures - before[0],
            warm_up_s=cache.warm_up_seconds - before[1],
            capture_s=cache.capture_seconds - before[2],
            pool_mb=(cache.pool_bytes - before[3]) / 1e6,
            first_call_ms=first)
        # without shape optimization: bit for bit
        want = timed(True, 0, False)
        got = timed(False, 0, False)
        equal = all(torch.equal(a, b) for a, b in zip(got["tensors"],
                                                       want["tensors"]))
        equal_log = {k: torch.equal(got["log"][k], want["log"][k])
                     for k in want["log"]}
        print(f"graph {label}: captured {captured}; without shape "
              f"optimization graph == eager bit for bit: estimate {equal}, "
              f"log {equal_log}; launches {got['counts']['launches']} "
              f"(eager {want['counts']['launches']})")
        assert equal and all(equal_log.values()), f"{label}: graph != eager"
        assert got["counts"] == want["counts"], (label, got["counts"],
                                                 want["counts"])
        # with shape optimization, in turns on distinct inputs
        turns = {"eager": [], "graph": []}
        pairs = []
        for eager, i in ((True, 1), (False, 1), (False, 2), (True, 2)):
            turns["eager" if eager else "graph"].append(timed(eager, i))
        for g, e in zip(turns["graph"], turns["eager"]):
            pairs.append(graph_against_eager(label, g, e))
        # the same frame again: a call equals the one before it
        for eager, first in ((False, turns["graph"][0]),
                             (True, turns["eager"][0])):
            graph_against_eager(f"{label} repeated "
                                f"{'eager' if eager else 'graph'} call",
                                timed(eager, 1), first)
        replays = cache.replays
        _, syncs = count_syncs(lambda: run(2, True))
        sync_call_graphs = cache.replays - replays
        ms = {k: [r["ms"] for r in v] for k, v in turns.items()}
        graph_launches = [r["graph_launches"] for r in turns["graph"]]
        if float(pipe.config.get("early_stop_delta", 0.0) or 0.0) > 0.0:
            # one graph per host read: the probe, then each check
            assert sync_call_graphs == syncs, (label, sync_call_graphs,
                                               syncs)
        else:
            if label.startswith("batch"):
                want_graphs = 1
            else:
                assert syncs == 1, f"{label}: {syncs} host syncs"
                want_graphs = (1 if pipe.config.get("fused_call", True)
                               else len(pipe.last_plan[0]) + 1)
            assert set(graph_launches + [sync_call_graphs]) == {
                want_graphs}, (label, graph_launches, sync_call_graphs,
                               want_graphs)
        launches = turns["graph"][0]["counts"]["launches"]
        per_it = {k: v / n_iter for k, v in launches.items()}
        prof = self._profile_run(label, lambda: run(0, True), n_iter)
        row = dict(
            ms_per_call={k: dict(median=statistics.median(v), min=min(v),
                                 max=max(v), calls=v)
                         for k, v in ms.items()},
            busy_share=prof["busy_share"], device_ms=prof["device_ms"],
            graph_launches_per_call=graph_launches,
            kernel_launches_per_call=launches,
            kernel_launches_per_iteration=per_it,
            host_syncs_per_call=syncs, against_eager=pairs, **captured)
        print(f"graph {label}: ms/call graph {ms['graph']} eager "
              f"{ms['eager']}; busy share {prof['busy_share']:.4f}; graph "
              f"launches per call {graph_launches}; kernel launches per "
              f"call {launches}; host syncs per call {syncs}; capture "
              f"{captured['capture_s']:.2f} s, warm-up "
              f"{captured['warm_up_s']:.2f} s, pools "
              f"{captured['pool_mb']:.1f} MB ({card_line()})")
        return row

    def mesh(self):
        """generate_depth, generate_mesh, the flight recorder and its
        playback on the card, with the decoded mug at GT_POSES[0]."""
        import os
        import tempfile

        import numpy as np
        import torch

        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.render import api, kernels, plain
        from sdfest_torch.scripts import play_log
        from sdfest_torch.utils.presets import preset

        pipe, cfg = self.pipe, self.pipe.config
        pos, half, q = GT_POSES[0]
        pos_t = torch.tensor(pos, device=self.dev)
        q_t = unit_quat(q, self.dev)
        # generate_depth: one march launch, bit for bit its plain version
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        depth = pipe.generate_depth(pos_t, q_t, half, self.latent)
        torch.cuda.synchronize()
        depth_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launches()
        want = dict.fromkeys(counts, 0)
        want["march"] = 1
        assert counts == want, f"generate_depth launches {counts}"
        with torch.no_grad():
            sdf = pipe._decode(self.latent)[0, 0]
        rays = api.ray_set(self.camera, self.dev).march
        inv_s = 1.0 / torch.tensor(half, device=self.dev)
        twin = plain.march_plain(
            sdf, rays.reshape(-1, 3), kernels.pose_params(pos_t, q_t, inv_s),
            cfg["threshold"], 500, cfg.get("coarse_culling", True),
            cfg.get("adaptive_relaxation", True)).reshape(depth.shape)
        equal = torch.equal(depth, twin)
        print(f"mesh generate_depth: {tuple(depth.shape)}, hits "
              f"{int((depth > 0).sum())}, launches {counts}, bit for bit "
              f"its plain version {equal}, {depth_ms:.3f} ms (first call)")
        assert equal, "generate_depth differs from its plain version"
        # generate_mesh on the card against the CPU port's
        cpu_pipe = SDFPipeline(preset("mug_procedural"), device="cpu")
        level = cfg["iso_threshold"]
        near = int((sdf - level).abs().lt(1e-5).sum())
        meshes = {}
        for complete in (False, True):
            t0 = time.perf_counter()
            got = pipe.generate_mesh(self.latent, half, complete)
            mesh_s = time.perf_counter() - t0
            ref = cpu_pipe.generate_mesh(self.latent.cpu(), half, complete)
            same_faces = len(got.faces) == len(ref.faces)
            dv = float(np.abs(got.vertices[got.faces]
                              - ref.vertices[ref.faces]).max()) if (
                same_faces) else float("inf")
            print(f"mesh generate_mesh complete_mesh={complete}: card "
                  f"{len(got.vertices)} vertices {len(got.faces)} faces, "
                  f"CPU {len(ref.vertices)} / {len(ref.faces)}; max|dvertex| "
                  f"through the faces {dv:.3e} (< 1e-4); grid values within "
                  f"1e-5 of the level {level}: {near}; {mesh_s:.3f} s")
            assert same_faces and dv < 1e-4, "generate_mesh differs on the card"
            meshes[str(complete)] = dict(vertices=len(got.vertices),
                                         faces=len(got.faces), max_err=dv,
                                         seconds=mesh_s)
        native = self.mesh_native(got, half, level)
        # the flight recorder of a full-frame call, then its playback
        obs = self.observe(GT_POSES[0])
        n_iter = cfg["max_iterations"]
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "call.pkl")
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            pipe(obs, obs > 0, log_path=path)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            expect_launches(kernels.launches(), n_iter)
            data = play_log.load_log(path)
            log = data["log"]
            leaves = [v for v in log.values()] + list(data["config"].values())
            assert not any(isinstance(v, torch.Tensor) for v in leaves), (
                "the flight recorder pickled a tensor")
            assert len(log["loss"]) == n_iter
            assert np.array_equal(log["loss"],
                                  pipe.last_log["loss"].cpu().numpy())
            shapes = {k: list(np.shape(v)) for k, v in log.items()}
            print(f"mesh flight recorder: {os.path.getsize(path)} bytes, "
                  f"call with log_path {call_ms:.3f} ms, log shapes {shapes}")
            kernels.reset_launches()
            t0 = time.perf_counter()
            _, frames, indices = play_log._render_frames(data, 25,
                                                         pipeline=pipe)
            frames_s = time.perf_counter() - t0
            counts = kernels.launches()
            want = dict.fromkeys(counts, 0)
            want["march"] = len(indices)
            print(f"mesh _render_frames stride 25: frames {indices}, "
                  f"launches {counts}, {frames_s:.3f} s")
            assert indices == [0, 25] and counts == want
            assert all(isinstance(f, np.ndarray) and (f > 0).any()
                       for f in frames)
            t0 = time.perf_counter()
            play_log.export_meshes(data, os.path.join(tmp, "meshes"), 25,
                                   pipeline=pipe)
            export_s = time.perf_counter() - t0
            written = sorted(os.listdir(os.path.join(tmp, "meshes")))
            print(f"mesh export_meshes stride 25: {written}, "
                  f"{export_s:.3f} s")
            assert written == ["00000.obj", "00025.obj"]
        self.report["march"]["mesh"] = dict(
            launches_generate_depth=1,
            launches_render_frames_stride25=want["march"])
        self.report["_mesh"] = dict(
            generate_depth_bit_for_bit=equal, generate_depth_ms=depth_ms,
            generate_mesh=meshes, near_level_values=near,
            call_with_log_ms=call_ms, render_frames_s=frames_s,
            export_meshes_s=export_s, native=native)

    def mesh_native(self, mesh, half, level):
        """The host C++ library on the decoded mug: its build, its marching
        tetrahedra against the numpy path's (times, face counts, the two
        surfaces' vertex chamfer in unit-cube units), and mesh_to_sdf of
        the card's generated mesh against the decoded grid's sign."""
        import numpy as np
        import torch

        from sdfest_torch import native
        from sdfest_torch.native import api as native_api
        from sdfest_torch.ops import marching_cubes as mc
        from sdfest_torch.ops import sdf_utils
        from sdfest_torch.pipeline import metrics

        t0 = time.perf_counter()
        assert native_api.available(), "no C++ compiler for the host library"
        load_s = time.perf_counter() - t0
        print(f"mesh native library: g++ build {native.build_seconds} s "
              f"(None: it was built before this run), load {load_s:.3f} s, "
              f"{native.library_path()}")
        grid = self.sdf.cpu().numpy()
        res = grid.shape[0]
        t0 = time.perf_counter()
        nv, nf = native_api.marching_tetrahedra(grid, level)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pv, pf = mc.marching_tetrahedra_np(grid, level)
        numpy_s = time.perf_counter() - t0
        chamfer = metrics.symmetric_chamfer(pv / (res - 1), nv / (res - 1))
        print(f"mesh marching tetrahedra native {native_s:.3f} s "
              f"{len(nf)} faces {len(nv)} vertices, numpy {numpy_s:.3f} s "
              f"{len(pf)} faces {len(pv)} vertices; vertex chamfer "
              f"{chamfer:.3e} of the unit cube (< 1e-3)")
        assert chamfer < 1e-3, "the native and numpy surfaces differ"
        # mesh_to_sdf of the generated mesh (metric, half max extent
        # ``half``): each of its cells mapped back through the stretch to
        # the unit cube into the decoded grid and sampled there
        from scipy.ndimage import map_coordinates

        t0 = time.perf_counter()
        back = sdf_utils.mesh_to_sdf(mesh, res)
        voxelize_s = time.perf_counter() - t0
        v = mesh.vertices
        lo, hi = v.min(axis=0), v.max(axis=0)
        lin = np.linspace(-1.0, 1.0, res)
        cube = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
        metric = cube * np.max(hi - lo) / 2.0 + (lo + hi) / 2.0
        idx = (metric / half + 1.0) * (res - 1) / 2.0
        inside = np.all((idx >= 0) & (idx <= res - 1), axis=-1)
        vals = map_coordinates(grid, idx.reshape(-1, 3).T, order=1).reshape(
            back.shape) - level
        far = inside & (np.abs(vals) > 2 * 2.0 / (res - 1))
        disagree = int((np.sign(vals[far]) != np.sign(back[far])).sum())
        print(f"mesh mesh_to_sdf {res}^3 of the generated mesh: "
              f"{voxelize_s:.3f} s; sign against the decoded grid on "
              f"{int(far.sum())} cells > 2 voxels from the surface: "
              f"{disagree} disagree (0)")
        assert int(far.sum()) > 10000 and disagree == 0, (
            "mesh_to_sdf's sign disagrees with the decoded grid")
        assert bool(torch.isfinite(torch.from_numpy(back)).all())
        return dict(build_s=native.build_seconds, native_s=native_s,
                    numpy_s=numpy_s, native_faces=len(nf),
                    numpy_faces=len(pf), vertex_chamfer=chamfer,
                    mesh_to_sdf_s=voxelize_s, sign_cells=int(far.sum()),
                    sign_disagree=disagree)

    def evaluate(self):
        """The synthetic rendering evaluation on the card: the first
        EVAL_MESHES held-out procedural mugs (seed 777, 64^3), one view
        each, the standard and production ablations."""
        import tempfile

        import torch

        from sdfest_torch.render import kernels
        from sdfest_torch.scripts import make_procedural_dataset
        from sdfest_torch.scripts.rendering_evaluation import Evaluator
        from sdfest_torch.utils.presets import preset

        calls, file_metrics = [], []

        class CountingEvaluator(Evaluator):
            """Reads each call's launches (counts set to 0 just before) and
            each file's metrics."""

            def _evaluate_file(self, path, num_views, config):
                metrics = super()._evaluate_file(path, num_views, config)
                file_metrics.append(metrics)
                return metrics

            def _estimate(self, inputs, log_path, config):
                torch.cuda.synchronize()
                kernels.reset_launches()
                out = super()._estimate(inputs, log_path, config)
                torch.cuda.synchronize()
                loss = self.pipeline.last_log["loss"]
                calls.append(dict(
                    launches=kernels.launches(),
                    rasters=dict(kernels.march.rasters),
                    plan=self.pipeline.last_plan,
                    loss=[float(loss[0]), float(loss[-1])]))
                return out

        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            make_procedural_dataset.generate(tmp, n=EVAL_MESHES, res=64,
                                             seed=777, export_meshes=True)
            gen_s = time.perf_counter() - t0
            config = preset("mug_procedural")
            config.update(EVAL_CONFIG, data_path=tmp)
            evaluator = CountingEvaluator(config, device=self.dev)
            results = evaluator.run()
        n_iter = config["max_iterations"]
        h, w = self.camera.height, self.camera.width
        names = list(config["ablation_configs"])
        per_file = []
        for i, (call, secs, metrics) in enumerate(zip(
                calls, evaluator.timings, file_metrics)):
            ablation = names[i // EVAL_MESHES]
            levels, fine_roi, fine_iters = call["plan"]
            # each level's march raster: its ROI, else the strided frame
            want = {}
            for shape, n in [(roi or (h // f, w // f), n)
                             for f, n, roi in levels] + [
                    (fine_roi or (h, w), fine_iters or n_iter)]:
                want[tuple(shape)] = want.get(tuple(shape), 0) + n
            iters = [n for _, n, _ in levels] + [fine_iters or n_iter]
            print(f"evaluate {ablation} file {i % EVAL_MESHES}: launches "
                  f"{call['launches']}, iterations per level {iters}, march "
                  f"rasters {call['rasters']}; loss {call['loss'][0]:.6f} -> "
                  f"{call['loss'][1]:.6f}; host s {secs}; metrics "
                  f"{json.dumps(metrics)}")
            expect_launches(call["launches"], n_iter)
            assert call["rasters"] == want, (call["rasters"], want)
            assert iters == ([n_iter] if ablation == "standard"
                             else [20, 20, 10]), iters
            assert math.isfinite(call["loss"][1]) and (
                call["loss"][1] < call["loss"][0]), "the loss did not fall"
            assert all(math.isfinite(v) for v in metrics.values()), metrics
            per_file.append(dict(ablation=ablation, seconds=secs,
                                 iterations=iters, loss=call["loss"],
                                 launches=call["launches"], metrics=metrics))
        for ablation, by_views in results.items():
            for views, stats in by_views.items():
                means = {k: v["mean"] for k, v in stats.items()}
                assert all(math.isfinite(v) for v in means.values()), means
                print(f"evaluate {ablation} views={views}: means over "
                      f"{EVAL_MESHES} meshes {json.dumps(means)}; the JAX "
                      f"package's 20-mesh means (context, not a bound; "
                      f"{JAX_EVAL_SOURCE}): "
                      f"{json.dumps(JAX_EVAL_MEANS[ablation])}")
        print(f"evaluate: data set {gen_s:.3f} s")
        self.report["_evaluate"] = dict(
            meshes=EVAL_MESHES, dataset_s=gen_s, files=per_file,
            results={a: {v: {k: s["mean"] for k, s in st.items()}
                         for v, st in r.items()} for a, r in results.items()})

    def category(self):
        """CategoryEvaluator under real275_evaluation_procedural on the card
        (NOCS REAL camera, 30 iterations at 640x480): 4 in-memory samples
        in NOCSDataset's format (CATEGORY_SHAPES), launches per call, the
        init estimate against the CPU port's, the ground-truth witness and
        the march on the NOCS camera against its plain version."""
        import os
        import tempfile

        import torch

        from sdfest_torch.ops.camera import Camera
        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.render import kernels
        from sdfest_torch.scripts import category_evaluation as ce
        from sdfest_torch.scripts import make_procedural_dataset
        from sdfest_torch.utils.config import load_config
        from sdfest_torch.utils.presets import preset

        config = preset("real275_evaluation_procedural")
        config["out_folder"] = None
        n_iter = config["max_iterations"]
        camera = Camera(**config["camera"])
        calls = []

        class Counting:
            """A pipeline whose calls' launches are read (counts set to 0
            just before each call, read just after) and kept."""

            def __init__(self, pipe):
                self.pipe = pipe

            def __call__(self, depth, mask, **kwargs):
                torch.cuda.synchronize()
                kernels.reset_launches()
                out = self.pipe(depth, mask, **kwargs)
                torch.cuda.synchronize()
                loss = self.pipe.last_log["loss"]
                calls.append(dict(launches=kernels.launches(),
                                  loss=[float(loss[0]), float(loss[-1])],
                                  latent=out[3]))
                return out

            def generate_mesh(self, *args, **kwargs):
                return self.pipe.generate_mesh(*args, **kwargs)

        class CountingEvaluator(ce.CategoryEvaluator):
            def _pipeline_for(self, category):
                pipe = super()._pipeline_for(category)
                if pipe is not None and not isinstance(pipe, Counting):
                    pipe = self._pipelines[category] = Counting(pipe)
                return pipe

        with tempfile.TemporaryDirectory() as tmp:
            samples, raster_s = [], []
            t0 = time.perf_counter()
            for category, scale in CATEGORY_SHAPES:
                out = os.path.join(tmp, category)
                make_procedural_dataset.generate(
                    out, n=CATEGORY_PER_CLASS, res=64, seed=777,
                    export_meshes=True, category=category)
                for i in range(CATEGORY_PER_CLASS):
                    t1 = time.perf_counter()
                    samples.append(category_sample(
                        os.path.join(out, f"{i:05d}.obj"), category, scale,
                        camera))
                    raster_s.append(time.perf_counter() - t1)
            data_s = time.perf_counter() - t0
            print(f"category data: {len(samples)} samples in {data_s:.3f} s, "
                  f"rasterizing {[round(s, 3) for s in raster_s]} s")
            dataset = InMemoryDataset(samples)
            evaluator = CountingEvaluator(config, dataset, device=self.dev)
            t0 = time.perf_counter()
            results = evaluator.run()
            run_s = time.perf_counter() - t0
            # the witness: each sample's ground truth as a pipeline reports
            # it (OpenGL), with the sample's own mesh
            truth = {cat: TruthPipeline([s for s in samples
                                         if s["category_str"] == cat],
                                        dataset)
                     for cat, _ in CATEGORY_SHAPES}
            witness = ce.CategoryEvaluator(config, dataset, truth,
                                           device=self.dev).run()
            # the init estimate on the card against the CPU port's, the same
            # depth, mask and uniforms
            init_err = {}
            for i, sample in enumerate(samples):
                cat = sample["category_str"]
                card = evaluator._pipelines[cat].pipe
                cpu = SDFPipeline(load_config(
                    config["category_configs"][cat], dict(config)),
                    device="cpu")
                u = torch.rand(card._num_input_points,
                               generator=torch.Generator().manual_seed(i))
                got = init_outputs(card, sample, u)
                want = init_outputs(cpu, sample, u)
                errs = {k: float((got[k].cpu() - want[k]).abs().max())
                        / max(1.0, float(want[k].abs().max()))
                        for k in want}
                print(f"category init {i} ({cat}): max|d| / max(1, "
                      f"max|CPU|) {json.dumps(errs)} (< 1e-4); CPU logits "
                      f"argmax {int(want['logits'].argmax())}, card "
                      f"{int(got['logits'].argmax())}")
                assert all(e < 1e-4 for e in errs.values()), (
                    f"the init estimate differs from the CPU port's: {errs}")
                init_err[i] = errs
            # the march on the NOCS camera (pixel_center 0, off-centre
            # principal point) bit for bit its plain version, at the first
            # sample's pose with its estimate's decoded shape
            equal, hits = self.nocs_march(evaluator._pipelines["mug"].pipe,
                                          samples[0], calls[0]["latent"])
        for i, call in enumerate(calls):
            print(f"category call {i} ({samples[i]['category_str']}): "
                  f"launches {call['launches']}, loss {call['loss'][0]:.6f} "
                  f"-> {call['loss'][1]:.6f}; host s "
                  f"{json.dumps(evaluator.timings[i])}")
            expect_launches(call["launches"], n_iter)
            assert all(math.isfinite(v) for v in call["loss"])
        counts = {c: results[c]["count"] for c in results}
        failed = {c: results[c]["failed"] for c in results}
        print(f"category counts {counts}, failed {failed}; {run_s:.3f} s")
        assert counts == {"mug": CATEGORY_PER_CLASS,
                          "bowl": CATEGORY_PER_CLASS,
                          "all": 2 * CATEGORY_PER_CLASS}, counts
        assert not any(failed.values()), failed
        for cat, agg in results.items():
            means = agg["means"]
            assert all(math.isfinite(v) for v in means.values()), means
            print(f"category {cat} means {json.dumps(means)}")
            print(f"category {cat} correctness {json.dumps(agg['correctness'])}")
        for cat, agg in witness.items():
            print(f"category witness {cat}: correctness "
                  f"{json.dumps(agg['correctness'])}, position error "
                  f"{agg['means']['position_error']}, degree error "
                  f"{agg['means']['degree_error']}, IoU "
                  f"{agg['means']['iou_3d']}")
            assert all(v == 1.0 for v in agg["correctness"].values()), (
                "the ground-truth witness is not correct: the samples' or "
                "the evaluator's conventions are wrong")
            assert agg["means"]["position_error"] == 0.0
        per_sample = {k: sum(t[k] for t in evaluator.timings) / len(samples)
                      for k in evaluator.timings[0]}
        print(f"category seconds per sample {json.dumps(per_sample)}, "
              f"rasterizing {sum(raster_s) / len(raster_s):.3f}")
        for name in FUSED_KERNELS:
            self.report[name]["category"] = dict(
                launches_per_call=calls[0]["launches"][name],
                calls=len(calls))
        self.report["march"]["category"]["nocs_camera_bit_for_bit"] = equal
        self.report["_category"] = dict(
            results=results, witness={c: a["correctness"]
                                      for c, a in witness.items()},
            seconds_per_sample=per_sample, rasterize_s=raster_s,
            init_rel_err=init_err, nocs_march_bit_for_bit=equal,
            nocs_march_hits=hits, run_s=run_s)

    def nocs_march(self, pipe, sample, latent):
        """The category pipeline's march (its camera, options and kernel) of
        a sample's ground-truth pose, bit for bit its plain version."""
        import numpy as np
        import torch

        from sdfest_torch.render import api, kernels, plain

        cfg = pipe.config
        pos = torch.tensor(np.asarray(sample["position"]) * [1.0, -1.0, -1.0],
                           dtype=torch.float32, device=self.dev)
        q = unit_quat(gl_quaternion(sample["quaternion"]), self.dev)
        inv_s = 1.0 / torch.tensor(float(np.max(sample["scale"])) / 2.0,
                                   device=self.dev)
        with torch.no_grad():
            sdf = pipe._decode(latent.reshape(1, -1))[0, 0]
            depth = pipe.render(sdf, pos, q, inv_s)
        rays = api.ray_set(pipe.camera, self.dev).march
        twin = plain.march_plain(
            sdf, rays.reshape(-1, 3), kernels.pose_params(pos, q, inv_s),
            cfg["threshold"], 500, cfg.get("coarse_culling", True),
            cfg.get("adaptive_relaxation", True)).reshape(depth.shape)
        equal, hits = torch.equal(depth, twin), int((depth > 0).sum())
        print(f"category march on the NOCS camera {pipe.camera}: hits "
              f"{hits}, bit for bit its plain version {equal}")
        assert hits > 1000 and equal, (
            "the march on the NOCS camera differs from its plain version")
        return equal, hits

    def runtime(self):
        """real_data.runtime_analysis under runtime_analysis_demo on the
        first held-out mug (the protocol as configured, then --trace)."""
        import os
        import tempfile

        import torch

        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.render import kernels
        from sdfest_torch.scripts import make_procedural_dataset, real_data
        from sdfest_torch.utils.presets import preset

        config = preset("runtime_analysis_demo")
        n_iter = config["max_iterations"]
        calls = []
        call = SDFPipeline.__call__

        def counted(pipe, *args, **kwargs):
            """Each call's launches: the host counters before and after
            (no synchronisation, so the timed loops are not disturbed)."""
            before = kernels.launches()
            out = call(pipe, *args, **kwargs)
            after = kernels.launches()
            calls.append(dict(
                launches={k: after[k] - before[k] for k in after},
                shape_optimization=kwargs.get("shape_optimization", True)))
            return out

        with tempfile.TemporaryDirectory() as tmp:
            make_procedural_dataset.generate(tmp, n=1, res=64, seed=777,
                                             export_meshes=True)
            config.update(input=os.path.join(tmp, "00000.obj"),
                          trace_dir=os.path.join(tmp, "trace"))
            torch.cuda.synchronize()
            kernels.reset_launches()
            SDFPipeline.__call__ = counted
            t0 = time.perf_counter()
            try:
                results = real_data.runtime_analysis(config, device=self.dev)
            finally:
                SDFPipeline.__call__ = call
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            totals = kernels.launches()
            trace = os.path.join(config["trace_dir"], real_data.TRACE_FILE)
            with open(trace) as f:
                names_march = "march_kernel" in f.read()
            trace_bytes = os.path.getsize(trace)
        print(f"runtime launches in the whole run {totals}; {len(calls)} "
              f"full refinements; {run_s:.1f} s; trace {trace_bytes} bytes, "
              f"names march_kernel {names_march}")
        assert names_march, "the trace does not name march_kernel"
        assert all(totals[k] > 0 for k in FUSED_KERNELS), totals
        per_call = {}
        for c in calls:
            key = "with_decode" if c["shape_optimization"] else (
                "without_decode")
            per_call.setdefault(key, []).append(c["launches"])
        for key, counts in per_call.items():
            print(f"runtime launches per full refinement {key}: "
                  f"{counts[0]} (all {len(counts)} calls equal: "
                  f"{all(c == counts[0] for c in counts)})")
            assert all(c == counts[0] for c in counts), counts
        expect_launches(per_call["with_decode"][0], n_iter)
        pipeline_ms = (self.report.get("_pipeline") or {}).get("ms_per_call")
        for block, phases in results.items():
            for name, stats in phases.items():
                assert math.isfinite(stats["mean"]) and stats["mean"] > 0, (
                    block, name, stats)
            print(f"runtime {block}: {json.dumps(phases)}")
        full = results["results_with_decode"]["full_refinement"]["mean"]
        print(f"runtime full refinement {full * 1e3:.3f} ms (Redwood camera "
              f"fx 525); the pipeline phase's {pipeline_ms} ms/call "
              f"(default camera fx 320: printed, not held)")
        for name in FUSED_KERNELS:
            self.report[name]["runtime"] = dict(
                launches_per_call=per_call["with_decode"][0][name],
                launches_per_call_without_decode=per_call.get(
                    "without_decode", [{}])[0].get(name),
                calls=len(calls))
        self.report["_runtime"] = dict(results=results, launches=per_call,
                                       run_s=run_s, trace_bytes=trace_bytes)

    def train(self):
        """The training path on the card: the VAE trainer (step-0 parity,
        20 steps as graphs against eager, the warm branch, a chained
        dispatch on the mugs held on the card), the init trainer (the bf16
        ring, the first generation batch's parity, the chained replay and
        fresh-stream dispatches as graphs against eager, 2 units from the
        committed weights) and the loop closing through SDFPipeline (see
        the module docstring)."""
        import os
        import tempfile

        import numpy as np
        import torch

        from sdfest_torch.datasets.generated import SDFVAEViewDataset
        from sdfest_torch.datasets.sdf_dataset import SDFDataset
        from sdfest_torch.pipeline.pipeline import SDFPipeline
        from sdfest_torch.scripts import make_procedural_dataset, train_init
        from sdfest_torch.scripts.train_vae import make_trainer
        from sdfest_torch.utils import checkpoint
        from sdfest_torch.utils.presets import preset

        out = self.report["_train"] = {}
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            make_procedural_dataset.generate(os.path.join(tmp, "mugs"),
                                             TRAIN_MUGS, res=64, seed=0)
            data = SDFDataset(os.path.join(tmp, "mugs"))
            print(f"train data: {len(data)} procedural mugs at 64^3, "
                  f"{time.perf_counter() - t0:.1f} s")
            batches = data.batches(8, shuffle=True, seed=0)
            cfg = preset("vae_mug_procedural")
            self.train_vae_step0(cfg, torch.from_numpy(next(batches)))
            out["vae"], vae = self.train_vae_steps(cfg, batches,
                                                   make_trainer)
            mugs = torch.from_numpy(np.stack([data[i] for i in range(
                len(data))])).to(self.dev)
            out["vae_chain"] = self.train_vae_chain(cfg, mugs, make_trainer)
            out["init"] = self.train_init(train_init, SDFVAEViewDataset)
            # the loop closes: the fresh VAE as flax msgpack + YAML, loaded
            # by the port's pipeline from that file
            model, config_path = checkpoint.save_model_and_config(
                os.path.join(tmp, "model"), "chip_vae", vae.vae, cfg)
            pipe_cfg = preset("mug_procedural")
            pipe_cfg["vae"]["model"] = model
            pipe = SDFPipeline(pipe_cfg, device=self.dev)
            # the pipeline's decoder is the trained one: both on the same
            # latents, within 1e-6
            latents = torch.randn(4, 8, generator=torch.Generator()
                                  .manual_seed(9)).to(self.dev)
            with torch.no_grad():
                decoded = pipe._decode(latents)
                trained = vae.vae.decode(latents)
            decoder_err = float((decoded - trained).abs().max())
            pos, half, q = GT_POSES[0]
            depth = pipe.generate_depth(
                torch.tensor(pos, device=self.dev), unit_quat(q, self.dev),
                half, self.latent)
            finite = bool(torch.isfinite(depth).all())
            print(f"train loop closed: {os.path.basename(model)} "
                  f"({os.path.getsize(model)} bytes) and "
                  f"{os.path.basename(config_path)}, loaded by SDFPipeline; "
                  f"its decoder against the trainer's on 4 latents max|d| "
                  f"{decoder_err:.3e} (tol 1e-6, |sdf| up to "
                  f"{float(trained.abs().max()):.3f}); generate_depth "
                  f"{tuple(depth.shape)} finite {finite}, hits "
                  f"{int((depth > 0).sum())}")
            assert decoder_err <= 1e-6, "the loaded decoder is not the trained"
            assert finite, "generate_depth of the trained VAE is not finite"
            out["loop_closed"] = dict(model_bytes=os.path.getsize(model),
                                      decoder_err=decoder_err,
                                      depth_finite=finite)

    def train_vae_step0(self, cfg, batch):
        """Step 0 from the committed mug VAE: the card's march, pc values,
        pc grid gradient and loss terms against their plain versions on the
        same inputs, eps and quaternions."""
        import torch

        from sdfest_torch.models.vae import fp32_convolutions
        from sdfest_torch.ops import pointset, quaternion
        from sdfest_torch.ops.interpolation import _base_and_frac
        from sdfest_torch.render import api, kernels, plain
        from sdfest_torch.training.vae_trainer import (
            PC_DISTANCE,
            PC_THRESHOLD,
            VAETrainer,
        )
        from sdfest_torch.utils import msgpack_reader, weights

        tree = msgpack_reader.load(VAE_WEIGHTS)
        card = VAETrainer(cfg, device=self.dev)
        weights.load_flax_into(card.vae, tree)
        g = torch.Generator().manual_seed(5)
        eps = torch.randn(8, 8, generator=g)
        quats = quaternion.random_uniform((8,), g)
        x = batch.to(self.dev)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with fp32_convolutions():
            loss, terms = card.loss(x, 0, eps=eps.to(self.dev),
                                    quats=quats.to(self.dev))
            loss.backward()
        torch.cuda.synchronize()
        step0_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launches()
        want = dict.fromkeys(counts, 0)
        want.update(march=1, sample_grad=1, scatter=1)
        assert counts == want, f"VAE step launches {counts}"
        assert kernels.hypotheses()["scatter"] == 8
        # the plain versions on the same inputs (these launches are not the
        # main path's)
        q = quats.to(self.dev)
        depth = card.pc_depth(x, q)
        pose = kernels.pose_params(
            x.new_tensor([0.0, 0.0, -PC_DISTANCE]).expand(8, 3), q,
            x.new_ones(8))
        rays = api.ray_set(card.camera, self.dev).march
        twin = plain.march_plain(x[:, 0].contiguous(), rays.reshape(-1, 3),
                                 pose, PC_THRESHOLD, 500, True, True)
        march_equal = torch.equal(depth.reshape(8, -1), twin)
        with torch.no_grad():
            recon = card.vae(x, eps=eps.to(self.dev))[0][:, 0].contiguous()
        points, valid = pointset.depth_to_pointcloud_dense(depth, card.camera)
        qi = quaternion.invert(quaternion.normalize(q))[:, None, :]
        obj = quaternion.apply(qi, points - points.new_tensor(
            [0.0, 0.0, -PC_DISTANCE])).contiguous()
        _, _, inside = _base_and_frac(obj, 64)
        mask = (inside & valid).float().contiguous()
        value, _ = kernels.sample_grad(recon, obj, mask)
        value_plain, _ = kernels.sample_grad_plain(recon, obj, mask)
        err_value = float((value - value_plain).abs().max())
        cot = (2 * value_plain * mask).contiguous()
        # the plain version on CPU copies (on the card index_add_ takes
        # atomics): the kernel adds in its order, bit for bit
        grid = kernels.scatter(obj, cot, 64).cpu()
        grid_plain = kernels.scatter_plain(obj.cpu(), cot.cpu(), 64)
        grid_equal = torch.equal(grid, grid_plain)
        err_grid = float((grid - grid_plain).abs().max())
        rows = int(mask.sum())
        # the loss terms against the CPU port on the same inputs, eps,
        # quaternions and depth
        cpu = VAETrainer(cfg, device="cpu")
        weights.load_flax_into(cpu.vae, tree)
        with torch.no_grad():
            _, cpu_terms = cpu.loss(batch, 0, eps=eps, quats=quats,
                                    pc_depth=depth.cpu())
        rel = {k: abs(float(terms[k].detach()) - float(v))
               / max(abs(float(v)), 1e-30) for k, v in cpu_terms.items()}
        print(f"train vae step 0 (committed mug VAE, batch 8, pc "
              f"{card.camera.width}x{card.camera.height}): "
              f"{step0_ms:.1f} ms, launches {counts}; pc march bit for bit "
              f"its plain version {march_equal} ({int((depth > 0).sum())} "
              f"hits); pc values max|d| {err_value:.3e} (tol 1e-4) on "
              f"{rows} rows; pc grid gradient (B = 8) bit for bit the plain "
              f"version on CPU copies {grid_equal} (max|d| {err_grid:.3e}); "
              f"loss terms rel. to the CPU port "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        assert march_equal, "the pc march differs from its plain version"
        assert err_value <= 1e-4, "pc values differ from the plain version"
        assert grid_equal, "pc grid gradient differs from plain"
        for k, v in rel.items():
            assert v <= (1e-4 if k == "loss_pc" else 1e-5), (k, v)
        for name, err, tol in (("march", 0.0, "bit for bit"),
                               ("sample_grad", err_value, 1e-4),
                               ("scatter", err_grid,
                                "bit for bit (plain on CPU copies)")):
            self.report[name]["train"] = dict(
                launches_per_vae_step=counts[name], max_abs_err=err, tol=tol,
                rows=rows if name != "march" else 8 * rays.shape[0]
                * rays.shape[1])
        self.report["_train"]["vae_step0"] = dict(
            ms=step0_ms, march_bit_for_bit=march_equal, pc_rows=rows,
            pc_value_err=err_value, pc_grid_err=err_grid,
            pc_grid_bit_for_bit=grid_equal, loss_terms_rel=rel)

    def train_turns(self, label, cache, graph_run, eager_run, units,
                    compare, turns=3):
        """One dispatch of a trainer path on the graph path (the first of
        its key: warm-up and capture) and one under ``graphs.eager()``
        (two trainers of one seed, each drawing from its own generator of
        one seed), then ``turns`` turns of each in the order eager, graph,
        graph, eager, ...: ms per step or unit (``units`` per dispatch),
        kernel launches per dispatch (the graph's equal to eager's), graph
        launches per dispatch; ``compare(graph_out, eager_out, i)`` holds
        the i-th dispatches' outputs to each other.  Then one more dispatch
        of each under torch.cuda's sync debug mode (host syncs).  Returns
        the report row and the outputs."""
        import statistics

        import torch

        from sdfest_torch.render import kernels
        from sdfest_torch.utils import graphs

        def timed(eager):
            torch.cuda.synchronize()
            kernels.reset_launches()
            replays = cache.replays
            t0 = time.perf_counter()
            if eager:
                with graphs.eager():
                    out = eager_run()
            else:
                out = graph_run()
            torch.cuda.synchronize()
            return dict(out=out, ms=(time.perf_counter() - t0) * 1e3 / units,
                        counts=kernels.launches(),
                        graph_launches=cache.replays - replays)

        before = (cache.captures, cache.warm_up_seconds,
                  cache.capture_seconds, cache.pool_bytes)
        runs = {"graph": [timed(False)], "eager": [timed(True)]}
        captured = dict(graphs=cache.captures - before[0],
                        warm_up_s=cache.warm_up_seconds - before[1],
                        capture_s=cache.capture_seconds - before[2],
                        pool_mb=(cache.pool_bytes - before[3]) / 1e6,
                        first_dispatch_ms=runs["graph"][0]["ms"] * units)
        for i in range(turns):
            for eager in ((True, False) if i % 2 == 0 else (False, True)):
                runs["eager" if eager else "graph"].append(timed(eager))
        for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
            assert g["counts"] == e["counts"], (label, i, g["counts"],
                                                e["counts"])
            compare(g["out"], e["out"], i)
        _, syncs = count_syncs(graph_run)
        with graphs.eager():
            _, eager_syncs = count_syncs(eager_run)
        ms = {k: [r["ms"] for r in v[1:]] for k, v in runs.items()}
        counts = runs["graph"][1]["counts"]
        row = dict(
            ms_per_unit={k: dict(median=statistics.median(v), min=min(v),
                                 max=max(v), runs=v) for k, v in ms.items()},
            graph_launches_per_dispatch=[r["graph_launches"]
                                         for r in runs["graph"][1:]],
            host_syncs_per_dispatch=syncs, eager_host_syncs=eager_syncs,
            kernel_launches_per_dispatch={k: v for k, v in counts.items()
                                          if v},
            kernel_launches_per_unit={k: v / units for k, v in
                                      counts.items() if v},
            **captured)
        assert set(row["graph_launches_per_dispatch"]) == {1}, (label, row)
        assert syncs == 0, f"{label}: {syncs} host syncs in a dispatch"
        return row, runs

    def train_line(self, label, row, prof, unit, extra=""):
        """The line of one trainer path (see train_turns)."""
        g, e = row["ms_per_unit"]["graph"], row["ms_per_unit"]["eager"]
        print(f"train graph {label}: ms/{unit} graph median {g['median']:.3f}"
              f" (range {g['min']:.3f}-{g['max']:.3f}, {len(g['runs'])} "
              f"turns) against eager median {e['median']:.3f} (range "
              f"{e['min']:.3f}-{e['max']:.3f}); busy share of one profiled "
              f"dispatch {prof['busy_share']:.4f}; graph launches per "
              f"dispatch {row['graph_launches_per_dispatch']}; host syncs "
              f"per dispatch {row['host_syncs_per_dispatch']} (eager "
              f"{row['eager_host_syncs']}); capture {row['capture_s']:.2f} s,"
              f" warm-up {row['warm_up_s']:.2f} s, pools "
              f"{row['pool_mb']:.1f} MB; kernel launches per {unit} "
              f"{row['kernel_launches_per_unit']} (eager's equal, the "
              f"trace's {prof['traced_launches']}){extra} ({card_line()})")
        row.update(busy_share=prof["busy_share"],
                   device_ms=prof["device_ms"],
                   traced_launches=prof["traced_launches"])

    def train_vae_steps(self, cfg, batches, make_trainer):
        """TRAIN_VAE_STEPS train_steps (batch 8, 640x480) from a seeded
        fresh initialisation on the graph path and under graphs.eager():
        every step's loss terms equal bit for bit, and the parameters and
        Adam's state after the turns; the loss falling; one step past the
        KLD warm-up.  Returns the report and the graph path's trainer."""
        import torch

        from sdfest_torch.render import kernels

        graph, eager = (make_trainer(dict(cfg, seed=0), self.dev)
                        for _ in range(2))
        gens = [torch.Generator(device=self.dev).manual_seed(0)
                for _ in range(2)]
        data = [torch.from_numpy(next(batches)).to(self.dev)
                for _ in range(TRAIN_VAE_STEPS + 6)]
        it = {"graph": iter(data), "eager": iter(data)}
        want = dict.fromkeys(kernels.KERNELS, 0)
        want.update(march=1, sample_grad=1, scatter=1)

        def compare(g, e, i):
            diff = [k for k in e if not torch.equal(g[k], e[k])]
            assert not diff, f"vae step {i}: graph != eager in {diff}"

        row, runs = self.train_turns(
            "vae-step", graph.graphs,
            lambda: graph.train_step(next(it["graph"]), gens[0]),
            lambda: eager.train_step(next(it["eager"]), gens[1]), 1,
            compare, turns=TRAIN_VAE_STEPS - 1)
        assert row["kernel_launches_per_dispatch"] == {
            k: v for k, v in want.items() if v}, row
        self.same_state(graph, eager, "vae step (pc loss)")
        total = [float(r["out"]["loss"]) for r in runs["graph"]]
        first, last = sum(total[:5]) / 5, sum(total[-5:]) / 5
        assert all(math.isfinite(v) for v in total), "a VAE loss diverged"
        assert last < first, "the VAE loss did not fall"
        graph.iteration = graph.WARM_UP_ITERATIONS + 1
        warm = {k: float(v) for k, v in graph.train_step(
            next(it["graph"]), gens[0]).items()}
        assert all(math.isfinite(v) for v in warm.values())
        prof = self._profile_run("train-vae-step", lambda: graph.train_step(
            next(it["graph"]), gens[0]), 1)
        self.train_line(
            "vae-step (batch 8, pc 640x480)", row, prof, "step",
            f"; graph == eager bit for bit at each of {len(runs['graph'])} "
            f"steps (loss terms) and after them (parameters, Adam's state); "
            f"loss {total[0]:.2f} -> {total[-1]:.2f}, mean first 5 "
            f"{first:.2f}, last 5 {last:.2f}; warm step (iteration "
            f"{graph.WARM_UP_ITERATIONS + 1}): loss_kld "
            f"{warm['loss_kld']:.3f}, loss {warm['loss']:.2f}")
        row.update(loss_first5=first, loss_last5=last, warm_step=warm,
                   bit_for_bit=True)
        return row, graph

    def train_vae_chain(self, cfg, data, make_trainer):
        """Chained VAE dispatches of TRAIN_CHAIN_K steps on the procedural
        mugs held on the card (batch 8): with pc_weight 0 (the VAE's default
        training config: no render, march or scatter) one turn, with the pc
        loss timed in turns and profiled; each graph and eager equal bit for
        bit (every step's loss terms, then parameters and Adam's state)."""
        import torch

        k = TRAIN_CHAIN_K

        def equal(g, e, i):
            diff = [name for name in e if not torch.equal(g[name], e[name])]
            assert not diff, f"vae chain dispatch {i}: {diff}"

        pair = [make_trainer(dict(cfg, seed=0, pc_weight=0.0), self.dev)
                for _ in range(2)]
        chains = [t.make_chained_step(data, 8, k) for t in pair]
        gens = [torch.Generator(device=self.dev).manual_seed(1)
                for _ in range(2)]
        exact, _ = self.train_turns(
            "vae-chain-pc0", pair[0].graphs,
            lambda: chains[0](data, gens[0]),
            lambda: chains[1](data, gens[1]), k, equal, turns=1)
        self.same_state(pair[0], pair[1], "vae chain (pc_weight 0)")
        assert not exact["kernel_launches_per_dispatch"], exact
        graph, eager = (make_trainer(dict(cfg, seed=0), self.dev)
                        for _ in range(2))
        chains = [t.make_chained_step(data, 8, k) for t in (graph, eager)]
        gens = [torch.Generator(device=self.dev).manual_seed(1)
                for _ in range(2)]
        row, runs = self.train_turns(
            "vae-chain", graph.graphs, lambda: chains[0](data, gens[0]),
            lambda: chains[1](data, gens[1]), k, equal)
        self.same_state(graph, eager, "vae chain (pc loss)")
        assert row["kernel_launches_per_dispatch"] == {
            "march": k, "sample_grad": k, "scatter": k}, row
        prof = self._profile_run("train-vae-chain",
                                 lambda: chains[0](data, gens[0]), k)
        self.train_line(
            f"vae-chain (K {k}, batch 8, {data.shape[0]} mugs on the card)",
            row, prof, "step",
            f"; graph == eager bit for bit over {len(runs['graph'])} "
            f"dispatches (loss terms of every step) and after them "
            f"(parameters, Adam's state), with the pc loss and over "
            f"{len(exact['graph_launches_per_dispatch']) + 1} dispatches "
            f"with pc_weight 0 (ms/step graph "
            f"{exact['ms_per_unit']['graph']['median']:.3f}, eager "
            f"{exact['ms_per_unit']['eager']['median']:.3f})")
        row.update(bit_for_bit=True, pc0_bit_for_bit=True, pc0=exact)
        return row

    def same_state(self, a, b, label):
        """Two trainers' parameters, buffers and Adam states bit for bit."""
        import torch

        sa, sb = a.state_dict()["model"], b.state_dict()["model"]
        diff = [k for k in sa if not torch.equal(sa[k], sb[k])]
        for p, q in zip(a.optimizer.params(), b.optimizer.params()):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(a.optimizer.state[p][key],
                                   b.optimizer.state[q][key]):
                    diff.append(key)
        assert not diff, f"{label}: graph != eager in {diff[:5]}"

    def train_init(self, train_init, view_dataset):
        """The init trainer of init_mug_procedural_v3 on the card: the
        bf16 ring and the first generation batch's parity, the chained
        replay dispatch (steps_per_dispatch units) and the chained
        fresh-stream dispatch (TRAIN_CHAIN_K steps) on the graph path and
        under graphs.eager(), bit for bit, then two eager replay units from
        the committed weights."""
        import torch

        from sdfest_torch.render import api, kernels, plain
        from sdfest_torch.utils import msgpack_reader, weights
        from sdfest_torch.utils.presets import preset

        cfg = preset("init_mug_procedural_v3")
        runner = train_init.Trainer(cfg, device=self.dev)
        loader = runner._create_dataset(
            "generated_dataset", cfg["datasets"]["generated_dataset"])
        ds = runner._generated_datasets["generated_dataset"]
        graph = runner.trainer
        eager = train_init.Trainer(cfg, device=self.dev).trainer
        gen_batch = cfg["batch_size"]
        t_train, train_batch = (cfg["replay_train_steps"],
                                cfg["replay_train_batch"])
        k = cfg["steps_per_dispatch"]
        torch.cuda.synchronize()
        free0 = torch.cuda.mem_get_info()[0]
        rings = [t.init_replay_buffer(cfg["replay_buffer_size"],
                                      ds.config["num_points"], 8)
                 for t in (graph, eager)]
        torch.cuda.synchronize()
        ring_bytes = sum(v.numel() * v.element_size()
                         for v in rings[0].store.values())
        assert rings[0].store["pointset"].device.type == self.dev.type and \
            rings[0].store["pointset"].dtype == torch.bfloat16
        # the first generation batch: its march and labels
        draws = ds.draw(gen_batch, loader.generator)
        kernels.reset_launches()
        depth = ds.render(draws)
        torch.cuda.synchronize()
        counts = kernels.launches()
        assert counts["march"] == 1 and sum(counts.values()) == 1, counts
        with torch.no_grad():
            sdf = ds.decoder(draws["latent"])[:, 0].contiguous()
        pose = kernels.pose_params(ds.position(draws), draws["quaternion"],
                                   1.0 / draws["scale"])
        rays = api.ray_set(ds.camera, self.dev).march
        twin = plain.march_plain(sdf, rays.reshape(-1, 3), pose,
                                 ds.config["render_threshold"], 500, True,
                                 True)
        march_equal = torch.equal(depth.reshape(gen_batch, -1), twin)
        batch = ds.views_from_depth(depth, draws)
        cpu_ds = view_dataset(ds.config, ds.decoder, device="cpu")
        cpu = cpu_ds.views_from_depth(depth.cpu(), {k_: v.cpu() for k_, v in
                                                    draws.items()})
        same_index = torch.equal(batch["orientation"].cpu(),
                                 cpu["orientation"])
        d_position = float((batch["position"].cpu() - cpu["position"])
                           .abs().max())
        d_scale = float((batch["scale"].cpu() - cpu["scale"]).abs().max())
        print(f"train init ring: {cfg['replay_buffer_size']} samples x "
              f"{ds.config['num_points']} bf16 points, {ring_bytes / 1e9:.3f}"
              f" GB on the card, one for each path (free before "
              f"{free0 / 1e9:.1f} GB); first generation batch (B = "
              f"{gen_batch}, {ds.camera.width}x{ds.camera.height}): 1 march "
              f"launch, bit for bit its plain version {march_equal}, hits "
              f"{int((depth > 0).sum())}; labels against the CPU port: "
              f"orientation indices equal {same_index}, max|dposition| "
              f"{d_position:.2e} (tol 1e-4 m), max|dscale| {d_scale:.2e} "
              f"(tol 1e-6)")
        assert march_equal, "the generation march differs from plain"
        assert same_index and d_position <= 1e-4 and d_scale <= 1e-6

        def equal(g, e, i):
            diff = [name for name in e if not torch.equal(g[name], e[name])]
            assert not diff, f"init dispatch {i}: graph != eager in {diff}"

        def both_equal(label):
            self.same_state(graph, eager, label)
            diff = [i for i, (a, b) in enumerate(zip(rings[0].tensors(),
                                                     rings[1].tensors()))
                    if not torch.equal(a, b)]
            assert not diff, f"{label}: the rings differ in {diff}"

        # the chained replay dispatch: K units from a fresh initialisation
        gens = [torch.Generator(device=self.dev).manual_seed(1)
                for _ in range(2)]
        replay = [t.make_replay_chained_step(ds, gen_batch, train_batch,
                                             t_train, k)
                  for t in (graph, eager)]
        row, runs = self.train_turns(
            "init-replay", graph.graphs,
            lambda: replay[0](rings[0], gens[0]),
            lambda: replay[1](rings[1], gens[1]), k, equal)
        both_equal("init replay chain")
        assert row["kernel_launches_per_dispatch"] == {"march": k}, row
        ce = [float(r["out"]["loss_orientation"].mean())
              for r in runs["graph"]]
        total = torch.cat([r["out"]["loss"] for r in runs["graph"]])
        assert bool(torch.isfinite(total).all()), "an init loss diverged"
        assert ce[-1] < ce[0], f"the orientation CE did not fall: {ce}"
        prof = self._profile_run("train-init-replay",
                                 lambda: replay[0](rings[0], gens[0]),
                                 k * t_train)
        filled = int(rings[0].filled)
        self.train_line(
            f"init-replay (K {k} units of {t_train} steps at batch "
            f"{train_batch}, generation batch {gen_batch})", row, prof,
            "unit",
            f"; graph == eager bit for bit (loss terms, parameters, "
            f"BatchNorm statistics, Adam's state, ring rows, cursor "
            f"{int(rings[0].cursor)}, filled {filled}) over "
            f"{len(runs['graph']) + 1} dispatches; orientation CE per "
            f"dispatch {[round(c, 3) for c in ce]}; loss "
            f"{float(total[0]):.2f} -> {float(total[-1]):.2f}")
        out = dict(ring_samples=cfg["replay_buffer_size"],
                   ring_bytes=ring_bytes, march_bit_for_bit=march_equal,
                   labels_equal=same_index, position_err=d_position,
                   scale_err=d_scale, replay=row, ce_per_dispatch=ce,
                   ring_filled=filled)
        row.update(views_per_s=gen_batch * 1e3 / row["ms_per_unit"][
            "graph"]["median"], steps_per_s=t_train * 1e3 / row[
            "ms_per_unit"]["graph"]["median"])
        # the chained fresh-stream dispatch: K steps of generation and
        # training, from a fresh initialisation (the profile above took the
        # graph path's trainer ahead)
        graph, eager = (train_init.Trainer(cfg, device=self.dev).trainer
                        for _ in range(2))
        gens = [torch.Generator(device=self.dev).manual_seed(2)
                for _ in range(2)]
        chain = [t.make_chained_step(ds, gen_batch, TRAIN_CHAIN_K)
                 for t in (graph, eager)]
        row, _ = self.train_turns(
            "init-chain", graph.graphs, lambda: chain[0](gens[0]),
            lambda: chain[1](gens[1]), TRAIN_CHAIN_K, equal)
        self.same_state(graph, eager, "init fresh chain")
        assert row["kernel_launches_per_dispatch"] == {
            "march": TRAIN_CHAIN_K}, row
        prof = self._profile_run("train-init-chain",
                                 lambda: chain[0](gens[0]), TRAIN_CHAIN_K)
        self.train_line(
            f"init-chain (K {TRAIN_CHAIN_K} steps, batch {gen_batch} at "
            f"{ds.camera.width}x{ds.camera.height})", row, prof, "step",
            "; graph == eager bit for bit (loss terms, parameters, "
            "BatchNorm statistics, Adam's state)")
        out["chain"] = row
        # two eager units from the committed init_v3 weights and
        # batch_stats
        committed = train_init.Trainer(preset("init_mug_procedural_v3"),
                                       device=self.dev).trainer
        weights.load_flax_into(committed.net,
                               msgpack_reader.load(INIT_V3_WEIGHTS))
        units = [committed.replay_unit(rings[1], ds, gen_batch, train_batch,
                                       t_train, gens[1]) for _ in range(2)]
        committed_ce = [sum(float(m["loss_orientation"]) for m in u) / len(u)
                        for u in units]
        assert all(math.isfinite(c) for c in committed_ce)
        print(f"train init from the committed init_v3: orientation CE per "
              f"unit {committed_ce}")
        out["committed_ce"] = committed_ce
        return out

    # -- slice 11: parallel and scripts ------------------------------------

    def parallel(self):
        """torch.distributed on the card: a world-1 NCCL group, one VAE DP
        step against the plain step, sharded_refine_batch against
        refine_batch, then the rendering sweep in two card-sharing gloo
        processes (see the module docstring)."""
        import torch

        from sdfest_torch.parallel import distributed as dist
        from sdfest_torch.parallel import mesh as pmesh

        out = self.report["_parallel"] = {}
        coordinator = f"localhost:{free_port()}"
        dist.initialize_distributed(coordinator, 1, 0, device=self.dev.type)
        try:
            mesh = pmesh.make_mesh()
            backend = torch.distributed.get_backend()
            print(f"parallel: group {backend} world {mesh.world} rank "
                  f"{mesh.rank} device {mesh.device} at {coordinator}")
            assert backend == dist.BACKENDS[self.dev.type], backend
            assert mesh.world == 1 and mesh.device.type == self.dev.type
            out["vae_step"] = self.parallel_vae_step(mesh)
            out["sharded_refine"] = self.parallel_refine(mesh)
        finally:
            torch.distributed.destroy_process_group()
        out["sweep"] = self.parallel_sweep()

    def parallel_vae_step(self, mesh):
        """One VAETrainer.step(group=) through shard_map_data_parallel_step
        at the train phase's size (committed mug VAE, batch 8, pc loss at
        640x480) against the plain step from the same state and draws:
        loss terms within PARALLEL_TERMS_REL, the parameters after it
        equal bit for bit, one march, sample-grad and scatter launch; then
        ms per DP step over DP_STEPS steps."""
        import os
        import statistics
        import tempfile

        import numpy as np
        import torch

        from sdfest_torch.datasets.sdf_dataset import SDFDataset
        from sdfest_torch.ops import quaternion
        from sdfest_torch.parallel import mesh as pmesh
        from sdfest_torch.render import kernels
        from sdfest_torch.scripts import make_procedural_dataset
        from sdfest_torch.training.vae_trainer import VAETrainer
        from sdfest_torch.utils import msgpack_reader, weights
        from sdfest_torch.utils.presets import preset

        with tempfile.TemporaryDirectory() as tmp:
            make_procedural_dataset.generate(os.path.join(tmp, "mugs"), 8,
                                             res=64, seed=0)
            data = SDFDataset(os.path.join(tmp, "mugs"))
            batch = torch.from_numpy(np.stack([data[i] for i in range(8)]))
        cfg = preset("vae_mug_procedural")
        tree = msgpack_reader.load(VAE_WEIGHTS)
        trainers = []
        for _ in range(2):
            t = VAETrainer(cfg, device=self.dev)
            weights.load_flax_into(t.vae, tree)
            trainers.append(t)
        plain_t, dp_t = trainers
        g = torch.Generator().manual_seed(5)
        eps = torch.randn(8, 8, generator=g)
        quats = quaternion.random_uniform((8,), g)
        want = plain_t.step(batch, eps=eps, quats=quats)
        step = pmesh.shard_map_data_parallel_step(dp_t.step, mesh)
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = step(batch, eps=eps, quats=quats)
        torch.cuda.synchronize()
        counts = kernels.launches()
        rel = {k: abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-30)
               for k, v in want.items()}
        params = max(float((a - b).detach().abs().max()) for a, b in zip(
            plain_t.vae.parameters(), dp_t.vae.parameters()))
        gen = torch.Generator(device=self.dev).manual_seed(0)
        times = []
        for _ in range(DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch, generator=gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times[1:])
        print(f"parallel vae DP step (world {mesh.world}, batch 8, pc "
              f"{dp_t.camera.width}x{dp_t.camera.height}): launches "
              f"{ {k: v for k, v in counts.items() if v} }; loss terms rel. "
              f"to the plain step "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
              + f" (tol {PARALLEL_TERMS_REL}); parameters after the step "
              f"max|d| {params:.3e} (tol 0: bit for bit); ms/step "
              f"{ms:.3f} (median of steps 2-{DP_STEPS}; "
              f"{[round(t, 3) for t in times]})")
        want_counts = dict.fromkeys(counts, 0)
        want_counts.update(march=1, sample_grad=1, scatter=1)
        assert counts == want_counts, f"DP step launches {counts}"
        assert all(v <= PARALLEL_TERMS_REL for v in rel.values()), rel
        assert params == 0.0, f"DP step parameters off the plain's {params}"
        for name in ("march", "sample_grad", "scatter"):
            self.report[name].setdefault("parallel", {})[
                "launches_per_dp_step"] = counts[name]
        return dict(ms_per_step=ms, step_ms=times, launches=counts,
                    loss_terms_rel=rel, param_diff=params)

    def parallel_refine(self, mesh):
        """sharded_refine_batch of HYPOTHESES hypotheses (batch_inputs,
        full frame, mug_procedural, 50 iterations) against refine_batch on
        the same inputs, by the batch phase's checks; launches as one
        hypothesis's run (each serving every hypothesis); ms per call of
        both in turns."""
        import torch

        from sdfest_torch.parallel.estimation import sharded_refine_batch
        from sdfest_torch.render import kernels

        views, states = self.batch_inputs()
        n = HYPOTHESES
        pipe = self.pipe

        def timed(fn):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = fn(pipe, states, *views)
            torch.cuda.synchronize()
            return (out, (time.perf_counter() - t0) * 1e3,
                    kernels.launches(), kernels.hypotheses())

        def sharded(*args):
            return sharded_refine_batch(*args, mesh=mesh)

        def unsharded(p, *args):
            return p.refine_batch(*args)

        (_, _, ref_log), _, _, _ = timed(unsharded)
        (final, _, log), _, counts, hyps = timed(sharded)
        n_iter = log["loss"].shape[1]
        walls = {"sharded": [], "refine_batch": []}
        for turn in ("sharded", "refine_batch", "refine_batch", "sharded"):
            walls[turn].append(timed(sharded if turn == "sharded"
                                     else unsharded)[1])
        ms = {k: sum(v) / len(v) for k, v in walls.items()}
        loss, ref = log["loss"], ref_log["loss"]
        loss0 = float((loss[:, 0] - ref[:, 0]).abs().max())
        early = {k: float((log[k][:, 0] - ref_log[k][:, 0]).abs().max())
                 for k in final}
        early["loss"] = float((loss[:, 1] - ref[:, 1]).abs().max())
        share = max(abs(float(loss[b, -1]) - float(ref[b, -1]))
                    / max(float(ref[b, 0]) - float(ref[b, -1]), 1e-12)
                    for b in range(n))
        per_launch = {k: hyps[k] / c for k, c in counts.items() if c}
        print(f"parallel sharded_refine_batch ({n} hypotheses over "
              f"{mesh.world} rank, {n_iter} iterations, full frame): "
              f"launches {counts}, hypotheses per launch {per_launch}; "
              f"against refine_batch: iteration 0 loss max|d| {loss0:.3e} "
              f"(tol 1e-6), after the first update max|d| {early} (tol "
              f"{EARLY_TOL}), final loss max|d| {share:.4f} of its fall "
              f"(tol {FINAL_SHARE}); ms/call sharded {ms['sharded']:.3f}, "
              f"refine_batch {ms['refine_batch']:.3f} (turns "
              f"{ {k: [round(w, 3) for w in v] for k, v in walls.items()} })")
        expect_launches(counts, n_iter)
        assert n_iter == pipe.config["max_iterations"], n_iter
        assert all(v == n for v in per_launch.values()), per_launch
        assert bool(torch.isfinite(loss).all()), "non-finite sharded loss"
        assert loss0 <= 1e-6, f"sharded: iteration 0 loss differs {loss0}"
        assert max(early.values()) <= EARLY_TOL, f"sharded: {early}"
        assert share <= FINAL_SHARE, f"sharded: final loss {share}"
        for name in FUSED_KERNELS:
            self.report[name].setdefault("parallel", {})[
                "launches_per_sharded_call"] = counts[name]
        return dict(hypotheses=n, iterations=n_iter, launches=counts,
                    hypotheses_per_launch=per_launch, ms_per_call=ms,
                    walls_ms=walls, iteration0_loss_diff=loss0,
                    early_diff=early, final_loss_share=share)

    def parallel_sweep(self):
        """run_distributed in two processes sharing the card, one gloo
        group: the first EVAL_MESHES held-out mugs (the evaluate phase's),
        one view, each process one mesh on the card; process 0 merges."""
        import os
        import tempfile

        from sdfest_torch.scripts import make_procedural_dataset
        from sdfest_torch.utils.presets import preset

        root = os.path.dirname(os.path.abspath(__file__))
        with tempfile.TemporaryDirectory() as tmp:
            make_procedural_dataset.generate(os.path.join(tmp, "meshes"),
                                             n=EVAL_MESHES, res=64, seed=777,
                                             export_meshes=True)
            config = preset("mug_procedural")
            config.update({k: v for k, v in EVAL_CONFIG.items()
                           if k != "ablation_configs"})
            config.update(data_path=os.path.join(tmp, "meshes"),
                          out_folder=os.path.join(tmp, "out"),
                          run_name="sweep")
            path = os.path.join(tmp, "config.json")
            with open(path, "w") as f:
                json.dump(config, f)
            coordinator = f"localhost:{free_port()}"
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", SWEEP_WORKER, root, coordinator,
                 str(rank), path, self.dev.type], cwd=root,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for rank in range(2)]
            outs = []
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=600)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(os.path.join(tmp, "out")))
        for rank, (p, o) in enumerate(zip(procs, outs)):
            print("\n".join(f"parallel sweep rank {rank}: {line}"
                            for line in o.strip().splitlines()
                            if not line.startswith("SWEEP_RESULTS")))
            assert p.returncode == 0, f"sweep rank {rank} failed"
            assert "evaluating 1 of 2 meshes" in o, o
        line = [x for x in outs[0].splitlines()
                if x.startswith("SWEEP_RESULTS ")][0]
        results = json.loads(line[len("SWEEP_RESULTS "):])
        means = {k: v["mean"] for k, v in results["1"].items()}
        finite = all(math.isfinite(v) for s in results["1"].values()
                     for v in s.values())
        print(f"parallel sweep: 2 processes (gloo) sharing the card, "
              f"{EVAL_MESHES} meshes, {wall:.1f} s wall; files {files}; "
              f"merged means {json.dumps(means)}; all statistics finite "
              f"{finite}")
        assert finite, results
        assert sum(f.endswith("_merged.yaml") for f in files) == 1, files
        assert not any(f.endswith(".pkl") for f in files), files
        return dict(wall_s=wall, files=files, results=results)

    def scripts(self):
        """The remaining scripts on the card: offset_experiment, the march
        against the golden renderer, LatentExplorer.animate, the
        micro-benchmarks and process_shapenet (see the module
        docstring)."""
        out = self.report["_scripts"] = {}
        out["experiment"] = self.scripts_experiment()
        out["golden"] = self.scripts_golden()
        out["animate"] = self.scripts_animate()
        out["benchmarks"] = self.scripts_benchmarks()
        out["process_shapenet"] = self.scripts_shapenet()

    def scripts_experiment(self):
        """offset_experiment on the sphere at 640x480 (the script's camera)
        from the JAX script's start (EXPERIMENT_NOISE),
        EXPERIMENT_ITERATIONS iterations, the default march: the CPU test's
        bars; one march per iteration plus the target and the final render,
        one sample-grad per iteration (the surrogate backward), no scatter
        (the SDF is fixed)."""
        import torch

        from sdfest_torch.ops.camera import Camera
        from sdfest_torch.render import kernels
        from sdfest_torch.scripts import experiments

        camera = Camera(**SCRIPT_CAMERA)
        n = EXPERIMENT_ITERATIONS
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        result = experiments.offset_experiment(
            experiments.sphere_sdf(), camera, n, device=self.dev,
            position_noise=EXPERIMENT_NOISE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        losses = result["losses"]
        pos0, pos1 = result["position_error"]
        scale1 = result["scale_error"][1]
        print(f"scripts offset_experiment ({camera.width}x{camera.height}, "
              f"{n} iterations): "
              f"{wall:.3f} s ({wall / n * 1e3:.3f} ms/iteration), launches "
              f"{ {k: v for k, v in counts.items() if v} }; loss "
              f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f}, position "
              f"error {pos0:.4f} -> {pos1:.5f}, scale error "
              f"{result['scale_error'][0]:.4f} -> {scale1:.5f}")
        want = dict.fromkeys(counts, 0)
        want.update(march=n + 2, sample_grad=n)
        assert counts == want, f"experiment launches {counts}, want {want}"
        assert float(losses[-1]) < 0.1 * float(losses[0]), "loss"
        assert pos0 > 0.05 and pos1 < 0.01, (pos0, pos1)
        assert scale1 < 0.005, scale1
        for name in ("march", "sample_grad"):
            self.report[name].setdefault("scripts", {})[
                "launches_per_experiment"] = counts[name]
        return dict(iterations=n, wall_s=wall, launches=counts,
                    loss=[float(losses[0]), float(losses[-1])],
                    position_error=[pos0, pos1],
                    scale_error=list(result["scale_error"]))

    def scripts_golden(self):
        """The CUDA march on an analytic sphere and box (64^3) at
        test_renderer.py's pose, 640x480, against the float64 numpy golden
        renderer (render/reference.py, the second oracle): without culling
        and adaptive relaxation by test_forward_matches_numpy_golden's bars
        (hits agree > 0.995, median |d| < 2e-4, max < 0.01), with both (the
        default march) by the march tolerance (max < 5e-3)."""
        import numpy as np
        import torch
        from scipy.spatial.transform import Rotation

        from sdfest_torch.ops.camera import Camera
        from sdfest_torch.render import kernels, reference, render_depth

        camera = Camera(**SCRIPT_CAMERA)
        position = np.asarray([0.05, -0.02, -0.6], np.float32)
        quat = Rotation.from_euler("XYZ", [10, 40, -20], degrees=True
                                   ).as_quat().astype(np.float32)
        inv_scale = np.float32(1.0 / 0.15)
        report = {}
        for shape, sdf in (("sphere", analytic_sphere(64)),
                           ("box", analytic_box(64))):
            t0 = time.perf_counter()
            golden = reference.render_depth_np(sdf, position, quat,
                                               float(inv_scale), camera,
                                               threshold=0.005)
            golden_s = time.perf_counter() - t0
            for march, (culling, adaptive, med_tol, max_tol) in (
                    ("plain", (False, False, 2e-4, 0.01)),
                    ("default", (True, True, 5e-3, 5e-3))):
                kernels.reset_launches()
                with torch.no_grad():
                    depth = render_depth(
                        torch.from_numpy(sdf).to(self.dev),
                        torch.from_numpy(position).to(self.dev),
                        torch.from_numpy(quat).to(self.dev),
                        float(inv_scale), camera=camera, threshold=0.005,
                        culling=culling, adaptive=adaptive,
                        device=self.dev).cpu().numpy()
                launched = kernels.launches()["march"]
                agree = float(((depth > 0) == (golden > 0)).mean())
                both = (depth > 0) & (golden > 0)
                diffs = np.abs(depth[both] - golden[both])
                r = dict(hits=int((golden > 0).sum()), agreement=agree,
                         median=float(np.median(diffs)),
                         max=float(diffs.max()), golden_s=golden_s,
                         launches=launched)
                report[f"{shape}_{march}"] = r
                print(f"scripts golden {shape} {march} march "
                      f"({camera.width}x{camera.height}): "
                      f"{r['hits']} golden hits, hit agreement {agree:.5f} "
                      f"(> 0.995), |d| median {r['median']:.3e} (< "
                      f"{med_tol}) max {r['max']:.3e} (< {max_tol}); "
                      f"golden renderer {golden_s:.2f} s on the host")
                assert launched == 1, launched
                assert r["hits"] > 0.01 * depth.size and agree > 0.995, r
                assert r["median"] < med_tol and r["max"] < max_tol, r
        self.report["march"].setdefault("scripts", {})["golden"] = {
            k: dict(agreement=v["agreement"], max=v["max"])
            for k, v in report.items()}
        return report

    def scripts_animate(self):
        """LatentExplorer.animate on the committed mug VAE: 2 keyframes,
        ANIMATE_FRAMES frames per segment (320x240): one march launch per
        frame and nothing else."""
        import torch

        from sdfest_torch.render import kernels
        from sdfest_torch.scripts.latent_explorer import LatentExplorer
        from sdfest_torch.utils.presets import preset

        explorer = LatentExplorer(dict(preset("vae_mug_procedural"),
                                       model=VAE_WEIGHTS), device=self.dev)
        g = torch.Generator().manual_seed(3)
        keyframes = list((0.7 * torch.randn(2, 8, generator=g)).numpy())
        explorer.animate(keyframes, 2, turn=0.5)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames = explorer.animate(keyframes, ANIMATE_FRAMES, turn=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launches()
        hits = [int((f > 0).sum()) for f in frames]
        print(f"scripts animate: {len(frames)} frames "
              f"{frames[0].shape[1]}x{frames[0].shape[0]} in {wall:.3f} s "
              f"({wall / len(frames) * 1e3:.2f} ms/frame: decode, march, "
              f"host shading), launches "
              f"{ {k: v for k, v in counts.items() if v} }; hits per frame "
              f"{hits}")
        want = dict.fromkeys(counts, 0)
        want.update(march=len(frames))
        assert len(frames) == ANIMATE_FRAMES + 1, len(frames)
        assert counts == want, f"animate launches {counts}"
        assert all(h > 1000 for h in hits), hits
        self.report["march"].setdefault("scripts", {})[
            "launches_per_animation"] = counts["march"]
        return dict(frames=len(frames), wall_s=wall, launches=counts,
                    hits=hits)

    def scripts_benchmarks(self):
        """benchmark_vae on the committed 64^3 mug decoder and
        benchmark_ops, as their command lines run them."""
        from sdfest_torch.scripts import benchmark_ops, benchmark_vae
        from sdfest_torch.utils.presets import preset

        vae = benchmark_vae.benchmark(
            dict(preset("vae_mug_procedural"), model=VAE_WEIGHTS),
            BENCHMARK_ITERATIONS, device=self.dev)
        ops = benchmark_ops.main(["--iters", str(BENCHMARK_ITERATIONS),
                                  "--device", self.dev.type])
        print(f"scripts benchmark_vae (64^3 mug decoder, "
              f"{BENCHMARK_ITERATIONS} chained calls): forward "
              f"{vae['decode_forward_s'] * 1e3:.4f} ms, forward+backward "
              f"{vae['decode_forward_backward_s'] * 1e3:.4f} ms; "
              f"benchmark_ops ms "
              f"{json.dumps({k: v * 1e3 for k, v in ops.items()})}")
        assert all(v > 0 for v in (vae["decode_forward_s"],
                                   vae["decode_forward_backward_s"],
                                   *ops.values()))
        return dict(decode_forward_ms=vae["decode_forward_s"] * 1e3,
                    decode_forward_backward_ms=(
                        vae["decode_forward_backward_s"] * 1e3),
                    ops_ms={k: v * 1e3 for k, v in ops.items()})

    def scripts_shapenet(self):
        """process_shapenet converts one generated mesh (held-out mug 0,
        seed 777) in a ShapeNet-like tree at 64^3: the paired .obj/.npy,
        the grid finite, negative inside, positive at the padded corner."""
        import os
        import shutil
        import tempfile

        import numpy as np

        from sdfest_torch.scripts import make_procedural_dataset
        from sdfest_torch.scripts import process_shapenet

        with tempfile.TemporaryDirectory() as tmp:
            make_procedural_dataset.generate(os.path.join(tmp, "src"), n=1,
                                             res=64, seed=777,
                                             export_meshes=True)
            model = os.path.join(tmp, "shapenet", "03797390", "mug0",
                                 "models")
            os.makedirs(model)
            shutil.copy(os.path.join(tmp, "src", "00000.obj"),
                        os.path.join(model, "model_normalized.obj"))
            t0 = time.perf_counter()
            n = process_shapenet.process(os.path.join(tmp, "shapenet"),
                                         os.path.join(tmp, "out"),
                                         resolution=64, padding=2, jobs=1)
            wall = time.perf_counter() - t0
            files = sorted(os.listdir(os.path.join(tmp, "out")))
            sdf = np.load(os.path.join(tmp, "out", "00000.npy"))
        inside = int((sdf < 0).sum())
        print(f"scripts process_shapenet: {n} mesh converted in {wall:.2f} s "
              f"-> {files}; grid {sdf.shape}, {inside} cells inside, corner "
              f"{float(sdf[0, 0, 0]):.4f}")
        assert n == 1 and files == ["00000.npy", "00000.obj"], (n, files)
        assert sdf.shape == (64, 64, 64) and np.isfinite(sdf).all()
        assert inside > 0 and sdf[0, 0, 0] > 0, (inside, sdf[0, 0, 0])
        return dict(converted=n, wall_s=wall, inside_cells=inside)

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
        self._graph_time("sample", lambda x: k.sample(self.sdf, *x), inp)
        self.time_sample_floor(inp)
        # sample-grad and scatter on the concatenated backward queries
        inp = [(torch.cat([s, o]).contiguous(), torch.cat([sm, m]).contiguous())
               for s, sm, o, m in sets]
        n = inp[0][0].shape[0]
        active = mean([float(m.sum()) for _, m in inp])
        ms = cuda_ms(lambda x: k.sample_grad(self.sdf, *x), inp)
        pms = cuda_ms(lambda x: k.sample_grad_plain(self.sdf, *x), inp)
        nbytes = n * 20 + mean([gather_bytes(p, m != 0, res) for p, m in inp])
        self._timed("sample_grad", ms, pms, nbytes, active * OPS_SAMPLE_GRAD)
        self._graph_time("sample_grad", lambda x: k.sample_grad(self.sdf, *x),
                         inp)
        sample_grad_inp = inp
        gen = torch.Generator(device="cpu").manual_seed(3)
        inp = [(p, (torch.randn(n, generator=gen).to(self.dev) * m)
                .contiguous()) for p, m in inp]
        ms = cuda_ms(lambda x: k.scatter(*x, res), inp)
        pms = cuda_ms(lambda x: k.scatter_plain(*x, res), inp)
        # cotangents in, the active rows' points in, the whole grid out
        nbytes = n * 4 + 12 * active + res ** 3 * 4
        self._timed("scatter", ms, pms, nbytes, active * OPS_SCATTER)
        self._graph_time("scatter", lambda x: k.scatter(*x, res), inp)
        self.time_grad_library(sample_grad_inp, inp)
        self.time_scatter_stages(inp)
        self.time_scatter_dense()
        self.time_scatter_single_cell()
        self.time_dense_call()
        # march at distinct poses (the coarse table is built once per grid,
        # outside the timed kernel)
        dirs = plain.pixel_directions(self.camera, self.dev)
        coarse = plain.coarse_min_table(self.sdf)
        g = torch.Generator(device="cpu").manual_seed(4)
        poses = []
        for i in range(reps):
            pos, half, q = GT_POSES[i % len(GT_POSES)]
            jitter = (0.01 * torch.randn(3, generator=g)).tolist()
            poses.append(self.pose(
                torch.tensor(pos, device=self.dev) + torch.tensor(
                    jitter, device=self.dev), q, half))
        thr = self.pipe.config["threshold"]
        # the kernel takes the frame's rays as the main path gives them,
        # (H, W, 3), launched as 16x16 tiles; the twin the flat rays
        rays = dirs.reshape(self.camera.height, self.camera.width, 3)
        ms = cuda_ms(lambda pose: k.march(self.sdf, rays, pose, thr, 500,
                                          True, True, coarse=coarse), poses)
        pms = cuda_ms(lambda pose: plain.march_plain(
            self.sdf, dirs, pose, thr, 500, True, True), poses, warmup=1)
        runs = []
        for pose in poses:
            runs.append({})
            plain.march_plain(self.sdf, dirs, pose, thr, 500, True, True,
                              steps=runs[-1])
        steps = mean_steps(runs)
        n = dirs.shape[0]
        ops = (steps["rays"] * OPS_MARCH_RAY + steps["fine"] * OPS_MARCH_FINE
               + steps["bound"] * OPS_MARCH_BOUND)
        # directions in and depth out per ray, the grid cells the fine
        # steps read, the coarse table and the pose
        self._timed("march", ms, pms,
                    n * 16 + steps["cells"] * 4 + 16 ** 3 * 4 + 14 * 4, ops)
        self._graph_time("march", lambda pose: k.march(
            self.sdf, rays, pose, thr, 500, True, True, coarse=coarse), poses)
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
            runs = []
            for pose, r in inp:
                runs.append({})
                plain.march_plain(self.sdf, r.reshape(-1, 3), pose, thr, 500,
                                  True, True, steps=runs[-1])
            steps = mean_steps(runs)
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
        self.time_march_variants(poses, dirs, coarse)
        self.time_tiles(poses, dirs, coarse)
        self.time_scatter_zeros(sets)
        self.time_batch(sets, poses, dirs, coarse)

    def time_batch(self, sets, poses, dirs, coarse):
        """Each kernel family at B = HYPOTHESES on 30 distinct inputs (input
        i stacks the B = 1 rows' sets or poses i, i + 1, ..., i + B - 1 of
        the 30), one launch each, beside B times its B = 1 row's time and
        its bound: B times that row's operations and bytes, the marches'
        shared ray directions counted once: the default march, the warm
        march cold, the sampler, sample-grad and the scatter."""
        import torch

        from sdfest_torch.render import kernels as k

        if not hasattr(k.march, "hypotheses"):  # a tree before the batch
            return
        n, reps, res = HYPOTHESES, len(sets), self.sdf.shape[0]
        thr = self.pipe.config["threshold"]
        grids = self.sdf.expand(n, -1, -1, -1).contiguous()
        tables = coarse.expand(n, -1, -1, -1).contiguous()
        stack = lambda xs, i: torch.stack(
            [xs[(i + j) % reps] for j in range(n)]).contiguous()
        rows = {}
        obj = [o for _, _, o, _ in sets]
        pc_m = [m for _, _, _, m in sets]
        inp = [(stack(obj, i), stack(pc_m, i)) for i in range(reps)]
        rows["sample"] = cuda_ms(lambda x: k.sample(grids, *x), inp)
        pts = [torch.cat([s, o]) for s, _, o, _ in sets]
        masks = [torch.cat([sm, m]) for _, sm, _, m in sets]
        inp = [(stack(pts, i), stack(masks, i)) for i in range(reps)]
        rows["sample_grad"] = cuda_ms(lambda x: k.sample_grad(grids, *x),
                                      inp)
        gen = torch.Generator(device="cpu").manual_seed(23)
        inp = [(p, (torch.randn(m.shape, generator=gen).to(self.dev)
                    * m).contiguous()) for p, m in inp]
        rows["scatter"] = cuda_ms(lambda x: k.scatter(*x, res), inp)
        library = {"scatter": scatter_library_ms(inp, res, long_sums=True,
                                                 check=2)}
        del inp
        self.time_scatter_vae_shaped(sets)
        rays = dirs.reshape(self.camera.height, self.camera.width, 3)
        pose_sets = [stack(poses, i) for i in range(reps)]
        rows["march"] = cuda_ms(lambda p: k.march(
            grids, rays, p, thr, 500, True, True, coarse=tables), pose_sets)
        shape = (n, *rays.shape[:2])
        t_init = torch.full(shape, -1.0, device=self.dev)
        skip = torch.zeros(shape, device=self.dev)
        rows["march_warm"] = cuda_ms(lambda p: k.march_warm(
            grids, rays, p, t_init, skip, thr, 500, coarse=tables), pose_sets)
        # the marches read the shared directions once for all hypotheses
        # (12 bytes a ray); the rest of their B = 1 bytes (outputs, cells,
        # table, pose; t_init and skip) and the other kernels' rows are per
        # hypothesis
        shared = {"march": rays.numel() * 4, "march_warm": rays.numel() * 4}
        for name, ms in rows.items():
            one = self.report[name]
            if name == "march_warm":
                one = one["cold"]
            once = shared.get(name, 0)
            nbytes = once + n * (one["bytes"] - once)
            b_ms, by = bound(nbytes, n * one["ops"])
            entry = dict(hypotheses=n, ms=ms, b1_ms_times_b=n * one["ms"],
                         bound_ms=b_ms, bound_by=by, bytes=nbytes,
                         shared_bytes=once, library_ms=library.get(name))
            self.report[name].setdefault("batch", {})["time"] = entry
            lib = (f"; library {library[name]:.4f} ms" if name in library
                   else "")
            print(f"time batch {name:<12} B={n} one launch {ms:.4f} ms; "
                  f"{n} x B=1 {n * one['ms']:.4f} ms; bound {b_ms:.5f} ms "
                  f"({by}: {once / 1e6:.3f} MB shared + {n} x "
                  f"{(one['bytes'] - once) / 1e6:.3f} MB = "
                  f"{nbytes / 1e6:.3f} MB){lib}")

    def time_scatter_vae_shaped(self, sets):
        """The scatter at a VAE step's shape: B = HYPOTHESES hypotheses of
        the 307,200 pc rows (10 windows of the time phase's sets, seeded
        cotangents on the valid rows), beside its library call; the first
        bit for bit its plain version on CPU copies."""
        import torch

        from sdfest_torch.render import kernels as k

        res, n = self.sdf.shape[0], HYPOTHESES
        gen = torch.Generator(device="cpu").manual_seed(5)
        pc = [(o.contiguous(), (torch.randn(o.shape[0], generator=gen)
                                .to(self.dev) * m).contiguous())
              for _, _, o, m in sets]
        inp = [tuple(torch.stack([pc[(i + j) % len(pc)][t]
                                  for j in range(n)]) for t in (0, 1))
               for i in range(10)]
        ms = cuda_ms(lambda x: k.scatter(*x, res), inp)
        lms = scatter_library_ms(inp, res, long_sums=True, check=2)
        exact = torch.equal(k.scatter(*inp[0], res).cpu(), k.scatter_plain(
            inp[0][0].cpu(), inp[0][1].cpu(), res))
        self.report["scatter"]["vae_shaped"] = dict(
            hypotheses=n, rows=inp[0][0].shape[1], ms=ms, library_ms=lms,
            bit_for_bit=exact)
        print(f"time scatter VAE-shaped (B={n} x {inp[0][0].shape[1]} pc "
              f"rows) kernel {ms:.4f} ms library {lms:.4f} ms; bit for bit "
              f"the plain version on CPU copies {exact} ({card_line()})")
        assert exact, "the VAE-shaped scatter is not its plain version's"

    def time_tiles(self, poses, dirs, coarse):
        """The march's per-tile culling at the 30 timed poses: active 16x16
        tiles per render (from the twin's slab test, no kernel change); the
        flat (N, 3) launch of 1-D blocks, and the default and the bf16
        march at 30 all-miss poses (the same poses with the object behind
        the camera)."""
        import torch

        from sdfest_torch.render import kernels as k
        from sdfest_torch.render import plain

        thr = self.pipe.config["threshold"]
        h, w = self.camera.height, self.camera.width
        rays = dirs.reshape(h, w, 3)
        tile = k.TILE
        tiles, active_rays = [], []
        for pose in poses:
            hit, t_min, t_max = plain.ray_interval(dirs, pose)
            marches = (hit & (t_min < t_max)).reshape(h, w)
            active_rays.append(int(marches.sum()))
            tiles.append(active_tiles(marches))
        n_tiles = -(-h // tile) * -(-w // tile)
        mean = lambda xs: sum(xs) / len(xs)
        t = self.report["march"]["active_tiles"] = dict(
            tiles=n_tiles, mean=mean(tiles), min=min(tiles), max=max(tiles),
            rays_in_box_mean=mean(active_rays), rays=h * w)
        print(f"time march active 16x16 tiles per render over "
              f"{len(poses)} poses: mean {t['mean']:.2f} min {t['min']} max "
              f"{t['max']} of {n_tiles} ({t['mean'] / n_tiles:.4f}); rays in "
              f"the box {t['rays_in_box_mean']:.1f} of {h * w}")
        # the same poses with the object behind the camera: origin_o is
        # R^T (-position), so flipping the position's z moves it behind
        behind = []
        for pose in poses:
            rot = pose[:9].reshape(3, 3)
            pos = -(rot @ pose[9:12])
            pos[2] = -pos[2]
            b = pose.clone()
            b[9:12] = rot.T @ (-pos)
            behind.append(b.contiguous())
        hit, t_min, t_max = plain.ray_interval(dirs, behind[0])
        assert not bool((hit & (t_min < t_max)).any()), "all-miss pose hits"
        pair = plain.coarse_pair_table(self.sdf)
        grid_b = self.sdf.to(torch.bfloat16)
        table = 16 ** 3 * 4 + 14 * 4
        # bound of an all-miss render: directions in, zeros out, the table
        b_miss = {False: bound(h * w * 16 + table, 0.0),
                  True: bound(h * w * 16 + 2 * 16 ** 3 * 4 + 14 * 4, 0.0)}
        miss = self.report["march"]["all_miss"] = {}
        for bf16 in (False, True):
            kw = dict(coarse=pair, bf16=True, sdf_bf16=grid_b) if bf16 \
                else dict(coarse=coarse)
            name = "bf16" if bf16 else "default"
            ms = cuda_ms(lambda pose: k.march(
                self.sdf, rays, pose, thr, 500, True, True, **kw), behind)
            b_ms, by = b_miss[bf16]
            miss[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
            print(f"time march all-miss {name} kernel {ms:.4f} ms bound "
                  f"{b_ms:.5f} ms ({by})")
        # the flat (N, 3) launch: 1-D blocks of 256 consecutive raster rays
        ms = cuda_ms(lambda pose: k.march(self.sdf, dirs, pose, thr, 500,
                                          True, True, coarse=coarse), poses)
        self.report["march"]["flat"] = dict(ms=ms)
        print(f"time march flat (N, 3) launch, 256-ray row blocks: {ms:.4f} "
              f"ms (16x16 tiles: {self.report['march']['ms']:.4f} ms)")

    def time_sample_floor(self, inp):
        """What sets the sampler's time on the 30 main-path input sets (4.9
        MB each, 147 MB together, more than the 50 MB L2: the timed launches
        find their inputs cold): the same launch on one set repeated 30
        times (inputs hot in L2), an empty kernel at the sampler's launch
        geometry (the launch floor), and the library yardstick
        F.grid_sample times the mask, which computes the same trilinear
        value on rows inside the volume (the main path's mask includes
        `inside`), held against the twin on the masked rows first."""
        import ctypes

        import torch
        import torch.nn.functional as F

        from sdfest_torch.render import _build, kernels as k

        r = self.report["sample"]
        reps = len(inp)
        r["hot"] = dict(ms=cuda_ms(lambda x: k.sample(self.sdf, *x),
                                   [inp[0]] * reps))
        print(f"time sample hot (one set x {reps}) kernel "
              f"{r['hot']['ms']:.4f} ms (cold: {r['ms']:.4f} ms)")
        # the library call: sdf[x][y][z] is grid_sample's (D, H, W), and its
        # coordinates come in (W, H, D) order, so a point (x, y, z) is (z,
        # y, x)
        grid = self.sdf[None, None]
        coords = [(o[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3).contiguous(), m)
                  for o, m in inp]
        library = lambda x: F.grid_sample(
            grid, x[0], mode="bilinear", align_corners=True).reshape(-1) * x[1]
        for (o, m), c in zip(inp, coords):
            on = m != 0
            err = float((library(c) - k.sample_plain(self.sdf, o, m))[on]
                        .abs().max())
            assert err <= 1e-5, f"grid_sample disagrees on masked rows: {err}"
        r["library_ms"] = cuda_ms(library, coords)
        print(f"time sample library F.grid_sample x mask {r['library_ms']:.4f}"
              f" ms (same function on in-volume rows; max|d| vs twin on the "
              f"masked rows <= 1e-5)")
        lib = _build.library("sample")
        if not hasattr(lib, "sdfest_empty"):  # a tree before the floor row
            return
        empty = lib.sdfest_empty
        empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
        stream = torch.cuda.current_stream().cuda_stream
        blocks = k.sample_blocks(inp[0][0].shape[0])
        ms = cuda_ms(lambda b: empty(b, stream), [blocks] * reps)
        gms = graph_ms(lambda b: empty(
            b, torch.cuda.current_stream().cuda_stream), [blocks] * reps)
        r["empty"] = dict(blocks=blocks, ms=ms, graph_ms=gms)
        print(f"time sample empty kernel at its launch geometry, {blocks} "
              f"blocks of 256: {ms:.4f} ms launched one by one, {gms:.4f} "
              f"ms each in one graph of {reps}")

    def time_grad_library(self, sample_grad_inp, scatter_inp):
        """The library yardsticks of sample-grad and the scatter:
        aten.grid_sampler_3d_backward (trilinear, zero padding, corners
        aligned: the port's normalized coordinates) on the kernels' inputs,
        the rows outside the volume masked off (zero padding and the
        kernels' extrapolation differ only there).  output_mask [False,
        True] with the mask as cotangent gives sample-grad's point
        gradient (not its value: no single call gives both); [True, False]
        with the scatter's cotangents gives the grid gradient
        (scatter_library_ms).  Each held against the plain version within
        1e-5 * max(1, max|want|) first."""
        import torch

        from sdfest_torch.render import kernels as k

        res = self.sdf.shape[0]
        grid = self.sdf[None, None].contiguous()
        backward = torch.ops.aten.grid_sampler_3d_backward
        # sample-grad: the point gradient, cotangent = the in-volume mask
        inp = [library_operands(p, m, res) for p, m in sample_grad_inp]
        call = lambda x: backward(x[1], grid, x[0], 0, 0, True,
                                  [False, True])[1]
        for (p, m), x in zip(sample_grad_inp, inp):
            want = k.sample_grad_plain(self.sdf, p, x[1].reshape(-1))[1]
            got = call(x).reshape(-1, 3)[:, [2, 1, 0]]
            err = float((got - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            assert err <= tol, f"grid_sampler_3d_backward point grad: {err}"
        ms = cuda_ms(call, inp)
        self.report["sample_grad"]["library_ms"] = ms
        print(f"time sample_grad library aten.grid_sampler_3d_backward "
              f"(point gradient, in-volume rows) {ms:.4f} ms (kernel "
              f"{self.report['sample_grad']['ms']:.4f} ms, value and "
              f"gradient)")
        # the scatter: the grid gradient of the kernel's cotangents, one
        # by one and in one graph of its calls, as the kernel is timed
        call, ops = scatter_library(scatter_inp, res)
        ms, gms = cuda_ms(call, ops), graph_ms(call, ops)
        r = self.report["scatter"]
        r["library_ms"] = ms
        r["graph"]["library_ms"] = gms
        print(f"time scatter library aten.grid_sampler_3d_backward (grid "
              f"gradient, in-volume rows) {ms:.4f} ms, in one graph of "
              f"{len(ops)} calls {gms:.4f} ms (kernel {r['ms']:.4f} ms, in "
              f"a graph {r['graph']['ms']:.4f} ms)")

    def time_scatter_stages(self, inp):
        """The scatter's device time per stage (torch.profiler over 30
        calls): on the time phase's backward rows, with zero cotangents
        and at B = 8 (windows of 8 of the sets); beside it the buckets of
        the first set (non-empty base cells, their largest row count) and
        the contributions per touched cell (what the gather sorts and
        folds for it)."""
        import torch

        from sdfest_torch.ops.interpolation import trilinear_weights

        res = self.sdf.shape[0]
        p, c = inp[0]
        idx, _ = trilinear_weights(p[c != 0], res)
        rows = torch.bincount(idx[:, 0], minlength=res ** 3)
        chain = torch.bincount(idx.reshape(-1), minlength=res ** 3)
        touched = chain[chain > 0].float()
        print(f"time scatter buckets: {int((rows > 0).sum())} non-empty of "
              f"{res ** 3}, at most {int(rows.max())} rows; contributions "
              f"per touched cell max {int(touched.max())} mean "
              f"{float(touched.mean()):.2f} over {touched.numel()} cells "
              f"({int((c != 0).sum())} active rows; gather paths "
              f"{gather_paths(chain)})")
        n = HYPOTHESES
        sets = {"main path": inp,
                "zero cotangents": [(q, torch.zeros_like(x)) for q, x in inp],
                f"B={n}": [tuple(torch.stack([inp[(i + j) % len(inp)][t]
                                              for j in range(n)])
                                 for t in (0, 1)) for i in range(len(inp))]}
        out = self.report["scatter"]["stages_ms"] = {}
        for label, data in sets.items():
            stages = scatter_stage_ms(data, res)
            assert set(SCATTER_STAGES) <= set(stages), (label, stages)
            out[label] = stages
            print(f"time scatter stages, {label}: "
                  + ", ".join(f"{st} {ms:.4f}" for st, ms in stages.items())
                  + f" ms; sum {sum(stages.values()):.4f} ms")

    def time_scatter_dense(self):
        """The scatter as the object comes closer (the first ground-truth
        pose's orientation at DENSE_DISTANCES, 10 query sets each, the
        main path's backward rows with seeded cotangents): per call its
        time (CUDA events), its plain version's, the library call's
        (scatter_library_ms) and the bound, beside the buckets (largest
        row count), the contributions per touched cell (the longest fold)
        and the cells each gather path takes; at B = HYPOTHESES (windows
        of the 10 sets) the kernel and the library call; the device time
        per stage (profiler); the first two sets bit for bit the plain
        version on CPU copies.  Runs on a parent tree too."""
        import torch

        from sdfest_torch.ops.interpolation import trilinear_weights
        from sdfest_torch.render import kernels as k

        res = self.sdf.shape[0]
        _, _, q = GT_POSES[0]
        gen = torch.Generator(device="cpu").manual_seed(6)
        out = self.report["scatter"]["dense"] = []
        for dist in DENSE_DISTANCES:
            inp = [self.backward_rows(((0.0, 0.0, -dist), 0.1, q), 200 + i,
                                      gen) for i in range(10)]
            p, c = inp[0]
            idx, _ = trilinear_weights(p[c != 0], res)
            rows = torch.bincount(idx[:, 0], minlength=res ** 3)
            chain = torch.bincount(idx.reshape(-1), minlength=res ** 3)
            active = sum(float((x != 0).sum()) for _, x in inp) / len(inp)
            n = p.shape[0]
            ms = cuda_ms(lambda x: k.scatter(*x, res), inp)
            pms = cuda_ms(lambda x: k.scatter_plain(*x, res), inp)
            lms = scatter_library_ms(inp, res, long_sums=True, check=2)
            b_ms, by = bound(n * 4 + 12 * active + res ** 3 * 4,
                             active * OPS_SCATTER)
            hyp = HYPOTHESES
            batch = [tuple(torch.stack([inp[(i + j) % len(inp)][t]
                                        for j in range(hyp)])
                           for t in (0, 1)) for i in range(len(inp))]
            batch_ms = cuda_ms(lambda x: k.scatter(*x, res), batch)
            batch_lms = scatter_library_ms(batch, res, long_sums=True,
                                           check=2)
            del batch
            stages = scatter_stage_ms(inp, res)
            # its own order, bit for bit (the plain version on CPU copies)
            exact = all(torch.equal(k.scatter(*x, res).cpu(), k.scatter_plain(
                x[0].cpu(), x[1].cpu(), res)) for x in inp[:2])
            row = dict(distance=dist, n=n, active_rows=active, ms=ms,
                       plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                       bound_by=by, batch=dict(hypotheses=hyp, ms=batch_ms,
                                               library_ms=batch_lms),
                       buckets=int((rows > 0).sum()),
                       bucket_max=int(rows.max()),
                       chain_max=int(chain.max()),
                       chain_mean=float(chain[chain > 0].float().mean()),
                       gather_paths=gather_paths(chain),
                       stages_ms=stages, bit_for_bit=exact)
            out.append(row)
            print(f"time scatter dense at {dist} m: kernel {ms:.4f} ms plain "
                  f"{pms:.4f} ms library {lms:.4f} ms bound {b_ms:.5f} ms "
                  f"({by}); B={hyp} kernel {batch_ms:.4f} ms library "
                  f"{batch_lms:.4f} ms; bit for bit the plain version on CPU "
                  f"copies {exact}; active rows {active:.0f} of {n}; buckets "
                  f"{row['buckets']}, largest {row['bucket_max']} rows; "
                  f"contributions per cell max {row['chain_max']} mean "
                  f"{row['chain_mean']:.1f}; gather paths "
                  f"{row['gather_paths']}; stages "
                  + ", ".join(f"{st} {t:.4f}" for st, t in stages.items())
                  + f" ms ({card_line()})")
        assert all(r["bit_for_bit"] for r in out), (
            "a dense scatter is not its plain version's order")

    def time_scatter_single_cell(self):
        """The scatter's worst case: 614,400 rows with cotangents, all in
        one base cell (8 cells of 614,400 contributions each, past any
        block's shared memory): time per call (CUDA events, 3 calls), bit
        for bit the plain version on CPU copies, within
        SINGLE_CELL_LIMIT_MS."""
        import torch

        from sdfest_torch.render import kernels as k

        res = self.sdf.shape[0]
        n = 614_400
        g = torch.Generator(device="cpu").manual_seed(8)
        pts = -1.0 + (40.25 + 0.5 * torch.rand(n, 3, generator=g)) * (
            2.0 / (res - 1))
        cot = torch.randn(n, generator=g)
        want = k.scatter_plain(pts, cot, res)
        x = (pts.to(self.dev), cot.to(self.dev))
        exact = torch.equal(k.scatter(*x, res).cpu(), want)
        ms = cuda_ms(lambda x: k.scatter(*x, res), [x] * 3, warmup=1)
        self.report["scatter"]["single_cell"] = dict(
            rows=n, ms=ms, bit_for_bit=exact)
        print(f"time scatter one base cell of {n} rows: {ms:.4f} ms per "
              f"call; bit for bit the plain version on CPU copies {exact} "
              f"({card_line()})")
        assert exact, "the single-cell scatter is not its plain version's"
        assert ms <= SINGLE_CELL_LIMIT_MS, f"single-cell scatter {ms} ms"

    def time_dense_call(self):
        """One full-frame call (the graph path) whose observed mug sits at
        DENSE_DISTANCES[-1], straight ahead at the first ground-truth
        pose's orientation: two calls to capture, then DENSE_CALLS timed
        calls (host clock after a synchronize) and one profiled call
        (device ms, the scatter's share).  Runs on a parent tree too."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        _, half, q = GT_POSES[0]
        depth = self.observe(((0.0, 0.0, -DENSE_DISTANCES[-1]), half, q))
        call = lambda: self.pipe(depth, depth > 0)
        for _ in range(2):
            call()
        walls = []
        for _ in range(DENSE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        scatter_ms = sum(e.self_device_time_total for e in kernels
                         if any(re.search(rf"\b{st}_kernel[(<]", e.key)
                                for st in SCATTER_STAGES)) / 1e3
        self.report["_dense_call"] = dict(
            distance=DENSE_DISTANCES[-1], ms=walls, device_ms=dev_ms,
            scatter_ms=scatter_ms)
        print(f"time dense call (mug at {DENSE_DISTANCES[-1]} m, full frame, "
              f"graph path): ms per call {[round(w, 3) for w in walls]}; "
              f"device {dev_ms:.3f} ms per call, the scatter's kernels "
              f"{scatter_ms:.3f} ms ({card_line()})")

    def time_scatter_zeros(self, sets):
        """The scatter with all-zero cotangents (the floor of launch, read
        and fill) on the time phase's 30 backward query sets."""
        import torch

        from sdfest_torch.render import kernels as k

        res = self.sdf.shape[0]
        pts = [torch.cat([s, o]).contiguous() for s, _, o, _ in sets]
        n = pts[0].shape[0]
        zeros = torch.zeros(n, device=self.dev)
        ms = cuda_ms(lambda p: k.scatter(p, zeros, res), pts)
        b_ms, by = bound(n * 4 + res ** 3 * 4, 0.0)
        self.report["scatter"]["zero_cotangents"] = dict(
            ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"time scatter zero cotangents kernel {ms:.4f} ms bound "
              f"{b_ms:.5f} ms ({by})")

    def time_march_variants(self, poses, dirs, coarse):
        """The plain branch, the relaxed march (culling on and off) and the
        warm march (cold, and mid-refinement with a real warm step's
        inputs), each at the same 30 poses as the default march."""
        import torch

        from sdfest_torch.render import kernels as k
        from sdfest_torch.render import plain

        thr = self.pipe.config["threshold"]
        n = dirs.shape[0]
        reps = len(poses)

        def march_steps(culling, adaptive, relaxation):
            out = []
            for pose in poses:
                st = {}
                plain.march_plain(self.sdf, dirs, pose, thr, 500, culling,
                                  adaptive, steps=st, relaxation=relaxation)
                out.append(st)
            return mean_steps(out)

        def report(entry, ms, pms, steps, n_bytes, ops_ray, ops_fine,
                   ops_bound):
            ops = (steps["rays"] * ops_ray + steps["fine"] * ops_fine
                   + steps["bound"] * ops_bound)
            nbytes = n_bytes + steps["cells"] * 4
            b_ms, by = bound(nbytes, ops)
            entry.update(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
                         bytes=nbytes, ops=ops, steps=steps)
            return (f"kernel {ms:.4f} ms plain {pms:.4f} ms bound "
                    f"{b_ms:.5f} ms ({by}: {nbytes / 1e6:.3f} MB, "
                    f"{ops / 1e6:.3f} Mop) steps {steps}")

        table = 16 ** 3 * 4 + 14 * 4
        # the kernels take the (H, W, 3) frame, as the main path gives it
        shape = (self.camera.height, self.camera.width)
        rays = dirs.reshape(*shape, 3)
        # plain branch: directions in, depth out, grid cells, no table
        ms = cuda_ms(lambda pose: k.march(self.sdf, rays, pose, thr, 500,
                                          False, False), poses)
        pms = cuda_ms(lambda pose: plain.march_plain(
            self.sdf, dirs, pose, thr, 500, False, False), poses, warmup=1)
        entry = self.report["march"].setdefault("plain", {})
        print("time march plain " + report(
            entry, ms, pms, march_steps(False, False, 1.0), n * 16 + 14 * 4,
            OPS_MARCH_RAY, OPS_MARCH_FINE, OPS_MARCH_BOUND))
        # relaxed, culling on and off
        r = self.report.setdefault("march_relaxed", {})
        for culling in (True, False):
            ms = cuda_ms(lambda pose: k.march(
                self.sdf, rays, pose, thr, 500, culling, True,
                coarse=coarse if culling else None,
                relaxation=RELAXATION), poses)
            pms = cuda_ms(lambda pose: plain.march_plain(
                self.sdf, dirs, pose, thr, 500, culling, True,
                relaxation=RELAXATION), poses, warmup=1)
            key = "culling" if culling else "no_culling"
            print(f"time march relaxed {key} " + report(
                r.setdefault(key, {}), ms, pms,
                march_steps(culling, True, RELAXATION),
                n * 16 + (table if culling else 14 * 4), OPS_MARCH_RAY,
                OPS_MARCH_FINE, OPS_MARCH_BOUND))
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            r[key] = r["culling"][key]
        # warm march: directions, t_init and skip in; depth and the five
        # corridor fields out
        cold = [(pose, torch.full(shape, -1.0, device=self.dev),
                 torch.zeros(shape, device=self.dev)) for pose in poses]
        mid = [self.warm_step(GT_POSES[i % len(GT_POSES)], 200 + i)
               for i in range(reps)]
        w = self.report.setdefault("march_warm", {})
        for label, inp in (("cold", cold), ("mid_refinement", mid)):
            # tiles with a ray that marches: hit, t0 < t_max and no skip
            tiles = []
            for pose, t_init, skip in inp:
                hit, t_min, t_max = (x.reshape(shape) for x in
                                     plain.ray_interval(dirs, pose))
                t0 = torch.where(t_init >= 0, torch.maximum(t_min, t_init),
                                 t_min)
                tiles.append(active_tiles(hit & (t0 < t_max) & (skip <= 0)))
            w.setdefault(label, {})["active_tiles"] = dict(
                mean=sum(tiles) / reps, min=min(tiles), max=max(tiles))
            ms = cuda_ms(lambda x: k.march_warm(self.sdf, rays, *x, thr, 500,
                                                coarse=coarse), inp)
            pms = cuda_ms(lambda x: plain.march_warm_plain(
                self.sdf, dirs, x[0], x[1].reshape(-1), x[2].reshape(-1),
                thr, 500), inp, warmup=1)
            run = []
            for pose, t_init, skip in inp:
                st = {}
                plain.march_warm_plain(self.sdf, dirs, pose,
                                       t_init.reshape(-1), skip.reshape(-1),
                                       thr, 500, steps=st)
                run.append(st)
            entry = w.setdefault(label, {})
            entry["skipped"] = sum(float(x[2].sum()) for x in inp) / reps
            entry["warm_started"] = sum(
                float(((x[1] >= 0) & (x[2] <= 0)).sum()) for x in inp) / reps
            print(f"time march_warm {label} " + report(
                entry, ms, pms, mean_steps(run), n * 44 + table,
                OPS_WARM_RAY, OPS_WARM_FINE, OPS_WARM_BOUND)
                + f" skipped {entry['skipped']:.0f} warm-started "
                  f"{entry['warm_started']:.0f} active 16x16 tiles "
                  f"{entry['active_tiles']}")
        # every ray skipped: no tile marches; the rays, t_init and skip in,
        # the six outputs out, and the pose
        skipped = [(pose, torch.full(shape, -1.0, device=self.dev),
                    torch.ones(shape, device=self.dev)) for pose in poses]
        ms = cuda_ms(lambda x: k.march_warm(self.sdf, rays, *x, thr, 500,
                                            coarse=coarse), skipped)
        b_ms, by = bound(n * 44 + 14 * 4, 0.0)
        w["all_skip"] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"time march_warm all-skip kernel {ms:.4f} ms bound "
              f"{b_ms:.5f} ms ({by})")
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            w[key] = w["mid_refinement"][key]
        self.time_bf16(poses, dirs, coarse)

    def time_bf16(self, poses, dirs, coarse):
        """The fp32 culling march without adaptive over-relaxation (the
        branch bf16 replaces) and the bf16 marches (culling, relaxed; warm
        cold and mid-refinement) at the same 30 poses.  The bf16 grid and
        the paired table are made once per grid, outside the timed kernel,
        as the min table is."""
        import torch

        from sdfest_torch.render import kernels as k
        from sdfest_torch.render import plain

        thr = self.pipe.config["threshold"]
        n = dirs.shape[0]
        reps = len(poses)
        pair = plain.coarse_pair_table(self.sdf)
        grid_b = self.sdf.to(torch.bfloat16)

        def entry(e, ms, pms, steps, n_bytes, ops_ray, ops_bound, warm):
            corridor = 6 if warm else 0
            ops = (steps["rays"] * ops_ray + steps["bound"] * ops_bound
                   + steps["fine"] * ((OPS_BF16_VERIFIED + corridor)
                                      if "fast" in steps else OPS_MARCH_FINE)
                   + steps.get("fast", 0) * (OPS_BF16_FAST + corridor))
            # the grid cells read: float32 by the fp32 samples, bf16 by the
            # bf16 samples
            nbytes = (n_bytes + steps["cells"] * 4
                      + steps.get("cells_bf16", 0) * 2)
            b_ms, by = bound(nbytes, ops)
            e.update(ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
                     bytes=nbytes, ops=ops, steps=steps)
            return (f"kernel {ms:.4f} ms plain {pms:.4f} ms bound {b_ms:.5f} "
                    f"ms ({by}: {nbytes / 1e6:.3f} MB, {ops / 1e6:.3f} Mop) "
                    f"steps {steps}")

        # the kernels take the (H, W, 3) frame, as the main path gives it
        shape = (self.camera.height, self.camera.width)
        rays = dirs.reshape(*shape, 3)
        # fp32 culling march without adaptive over-relaxation
        ms = cuda_ms(lambda pose: k.march(self.sdf, rays, pose, thr, 500,
                                          True, False, coarse=coarse), poses)
        pms = cuda_ms(lambda pose: plain.march_plain(
            self.sdf, dirs, pose, thr, 500, True, False), poses, warmup=1)
        runs = []
        for pose in poses:
            st = {}
            plain.march_plain(self.sdf, dirs, pose, thr, 500, True, False,
                              steps=st)
            runs.append(st)
        e = self.report["march"].setdefault("no_adaptive", {})
        print("time march culling without adaptive " + entry(
            e, ms, pms, mean_steps(runs), n * 16 + 16 ** 3 * 4 + 14 * 4,
            OPS_MARCH_RAY, OPS_MARCH_BOUND, False))
        # bf16 marches: directions in, depth out, the 32 KB paired table
        r = self.report["march_bf16"]
        table = 2 * 16 ** 3 * 4 + 14 * 4
        for key, relaxation in (("culling", 1.0), ("relaxed", RELAXATION)):
            ms = cuda_ms(lambda pose: k.march(
                self.sdf, rays, pose, thr, 500, True, True, coarse=pair,
                relaxation=relaxation, bf16=True, sdf_bf16=grid_b), poses)
            pms = cuda_ms(lambda pose: plain.march_plain(
                self.sdf, dirs, pose, thr, 500, True, True,
                relaxation=relaxation, bf16=True), poses, warmup=1)
            runs = []
            for pose in poses:
                st = {}
                plain.march_plain(self.sdf, dirs, pose, thr, 500, True, True,
                                  steps=st, relaxation=relaxation, bf16=True)
                runs.append(st)
            print(f"time march_bf16 {key} " + entry(
                r[key], ms, pms, mean_steps(runs), n * 16 + table,
                OPS_MARCH_RAY, OPS_MARCH_BOUND, False))
        cold = [(pose, torch.full(shape, -1.0, device=self.dev),
                 torch.zeros(shape, device=self.dev)) for pose in poses]
        mid = [self.warm_step(GT_POSES[i % len(GT_POSES)], 200 + i)
               for i in range(reps)]
        for label, inp in (("cold", cold), ("mid_refinement", mid)):
            ms = cuda_ms(lambda x: k.march_warm(
                self.sdf, rays, *x, thr, 500, coarse=pair, bf16=True,
                sdf_bf16=grid_b), inp)
            pms = cuda_ms(lambda x: plain.march_warm_plain(
                self.sdf, dirs, x[0], x[1].reshape(-1), x[2].reshape(-1),
                thr, 500, bf16=True), inp, warmup=1)
            runs = []
            for pose, t_init, skip in inp:
                st = {}
                plain.march_warm_plain(self.sdf, dirs, pose,
                                       t_init.reshape(-1), skip.reshape(-1),
                                       thr, 500, steps=st, bf16=True)
                runs.append(st)
            print(f"time march_bf16 warm {label} " + entry(
                r["warm"].setdefault(label, {}), ms, pms, mean_steps(runs),
                n * 44 + table, OPS_WARM_RAY, OPS_WARM_BOUND, True))
        for key in ("ms", "plain_ms", "bound_ms", "bound_by"):
            r[key] = r["culling"][key]

    def profile(self):
        """torch.profiler over one full-frame, fast and temporal call and
        one batched full-frame refine_batch of 8 hypotheses, on the default
        (graph) path: device busy share and the ops that take the time.  (A
        fast-adaptive call does the fast call's work: nothing freezes at
        50 iterations.)  A run the graph phase profiled in this run (same
        label, pipeline preset and input) is not profiled again."""
        views, states = self.batch_inputs()
        depth = self.observe(GT_POSES[0])
        runs = {
            "full-frame": (self.pipe, None), "fast": (self.fast_pipe, None),
            "temporal": (self.temporal_pipe, None),
            f"batch-{HYPOTHESES}-full-frame": (self.pipe, lambda: (
                self.pipe.refine_batch(states, *views)))}
        for label, (pipe, call) in runs.items():
            if f"_profile_{label}" in self.report:
                print(f"profile {label}: profiled by the graph phase")
                continue
            self._profile_run(
                label, call or (lambda p=pipe: p(depth, depth > 0)),
                pipe.config["max_iterations"])

    def _profile_run(self, label, call, n_iter):
        """torch.profiler over one ``call()`` of ``n_iter`` iterations,
        after a warm-up and one unprofiled timed call."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from torch.autograd import DeviceType

        from sdfest_torch.render import kernels as wrappers

        call()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        before = wrappers.launches()
        with profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        counted = {k: v - before[k] for k, v in wrappers.launches().items()}
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        n_kernels = sum(e.count for e in kernels)
        print(f"profile {label}: unprofiled wall {wall_ms:.3f} ms/call; "
              f"device kernels {dev_ms:.3f} ms/call ({n_kernels} launches, "
              f"{n_kernels / n_iter:.1f} per iteration); device busy share "
              f"{dev_ms / wall_ms:.4f}, idle share {1 - dev_ms / wall_ms:.4f}")
        row = self.report[f"_profile_{label}"] = dict(
            wall_ms=wall_ms, device_ms=dev_ms, launches=n_kernels,
            busy_share=dev_ms / wall_ms)
        traced = {}
        named = lambda k: [e for e in kernels
                           if re.search(rf"\b{k}_kernel[(<]", e.key)]
        for name in wrappers.KERNELS:  # the port's kernels in the trace
            rows = named(name)
            traced[name] = sum(e.count for e in rows)
            for e in rows:
                print(f"profile {label} kernel {name}: {e.count} launches, "
                      f"mean {e.self_device_time_total / e.count / 1e3:.4f} "
                      f"ms ({e.key})")
        # a scatter call is its device kernels of every stage, once each
        stages = {k: named(k) for k in SCATTER_STAGES}
        stage_counts = {k: sum(e.count for e in v) for k, v in stages.items()}
        assert set(stage_counts.values()) <= {traced["scatter"]}, (
            label, stage_counts, traced["scatter"])
        if traced["scatter"]:
            per_call = sum(e.self_device_time_total for v in stages.values()
                           for e in v) / traced["scatter"] / 1e3
            print(f"profile {label} scatter stages {stage_counts}: "
                  f"{per_call:.4f} ms per call, the memset aside")
            row["scatter_ms_per_call"] = per_call
        # the wrappers' counts (on the graph path added per replay) are
        # the kernels that ran
        print(f"profile {label}: kernels in the trace {traced}, counted "
              f"{counted}")
        assert traced == counted, (label, traced, counted)
        row["traced_launches"] = traced
        print(events.table(sort_by="self_device_time_total", row_limit=15,
                           max_name_column_width=48))
        print(events.table(sort_by="self_cpu_time_total", row_limit=12,
                           max_name_column_width=48))
        return row

    def _graph_time(self, name, fn, inputs):
        """A kernel's time inside one captured graph of its launches on the
        same distinct inputs, beside its time launched one by one (how much
        of the launch cost is the host's)."""
        r = self.report[name]
        r["graph"] = dict(ms=graph_ms(fn, inputs), launches=len(inputs),
                          eager_ms=r["ms"])
        print(f"time {name:<12} in one graph of {len(inputs)} launches "
              f"{r['graph']['ms']:.4f} ms each (launched one by one "
              f"{r['ms']:.4f} ms)")

    def _timed(self, name, ms, plain_ms, nbytes, ops):
        b_ms, by = bound(nbytes, ops)
        print(f"time {name:<12} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {b_ms:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e6:.2f} Mop)")
        self.report[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=by, bytes=nbytes, ops=ops)


def count_syncs(fn):
    """``(fn(), host syncs)``: the synchronizing CUDA operations that ``fn``
    issued, as torch.cuda's sync debug mode reports them (each one a
    warning)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def graph_against_eager(label, g, e) -> dict:
    """A call with shape optimization against another on the same input
    (rows of ``graph_path``'s ``timed``: graph against eager, or a call
    against its repeat): every estimate tensor and log entry bit for bit,
    the launch counts equal; the loss's largest difference printed."""
    import torch

    differ = [i for i, (a, b) in enumerate(zip(g["tensors"], e["tensors"]))
              if not torch.equal(a, b)]
    differ_log = [k for k in e["log"] if not torch.equal(g["log"][k],
                                                         e["log"][k])]
    loss = float((g["log"]["loss"] - e["log"]["loss"]).abs().max())
    print(f"graph {label}: bit for bit: estimate tensors differing "
          f"{differ}, log entries differing {differ_log}; loss max|d| over "
          f"all iterations {loss:.3e}; launches equal "
          f"{g['counts'] == e['counts']}")
    assert not differ and not differ_log, (label, differ, differ_log)
    assert g["counts"] == e["counts"], (label, g["counts"], e["counts"])
    return dict(bit_for_bit=True, loss_max_diff=loss)


def graph_ms(fn, inputs, replays: int = 3) -> float:
    """Mean device ms of ``fn(x)`` over the distinct ``inputs`` launched
    from ONE captured CUDA graph (after a warm-up): the kernels' time
    without the host's launch gaps or its per-launch submission."""
    import torch

    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x in inputs:
            fn(x)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(inputs))


def mean_steps(runs) -> dict:
    """The mean over runs of the plain marches' ``steps`` reports (rays,
    fine and bound steps, cells, the longest ray's steps, ...)."""
    out = {}
    for st in runs:
        for key, v in st.items():
            out[key] = out.get(key, 0.0) + v / len(runs)
    return out


def active_tiles(marches) -> int:
    """The 16x16 tiles of an ``(h, w)`` raster with a marching ray, from
    the twin's slab test (the tiles that copy the coarse table)."""
    import torch

    from sdfest_torch.render import kernels as k

    tile = k.TILE
    h, w = marches.shape
    padded = torch.zeros(-(-h // tile) * tile, -(-w // tile) * tile,
                         dtype=torch.bool, device=marches.device)
    padded[:h, :w] = marches
    return int(padded.reshape(padded.shape[0] // tile, tile,
                              padded.shape[1] // tile, tile).any(3).any(1)
               .sum())


# camera-to-object distances (m) of the time phase's dense scatter rows:
# the main path's poses are at 0.45-0.6 m; at 0.12 m the mug fills most of
# the 640x480 frame
DENSE_DISTANCES = (0.3, 0.2, 0.15, 0.12)
# timed full-frame calls with the mug at DENSE_DISTANCES[-1]
DENSE_CALLS = 3
# the device kernels of one scatter call (csrc/scatter.cu), the last stage
# ("scatter_kernel", the gather) the one each wrapper's count is traced by
SCATTER_STAGES = ("scatter_count", "scatter_alloc", "scatter_place",
                  "scatter")
# the gather's paths by a cell's contributions: a warp up to 256, a block's
# shared memory up to 4,096, windows of rows beyond
GATHER_WARP, GATHER_BLOCK = 256, 4096
# the one-base-cell scatter of 614,400 rows must finish within this
SINGLE_CELL_LIMIT_MS = 50.0
# the kernels of the fused render op (one launch each per iteration); the
# warm march launches on the temporal path only
FUSED_KERNELS = ("march", "sample", "sample_grad", "scatter")


def expect_launches(counts, n):
    """The launches of a fused-op path: ``n`` of each fused-op kernel and
    no warm march."""
    want = {name: n if name in FUSED_KERNELS else 0 for name in counts}
    assert counts == want, f"launches {counts}, expected {want}"


def gl_quaternion(q_cv):
    """An OpenCV-camera-frame orientation in the OpenGL camera frame (the
    pipeline's): a half turn about x composed on the left."""
    from scipy.spatial.transform import Rotation

    return (Rotation.from_quat([1.0, 0.0, 0.0, 0.0])
            * Rotation.from_quat(q_cv)).as_quat()


def centred_mesh(path):
    """An .obj's vertices with their bounding box centred, and faces."""
    from sdfest_torch.pipeline import synthetic

    v, f = synthetic.load_obj(path)
    return v - (v.max(axis=0) + v.min(axis=0)) / 2.0, f


def category_sample(path, category, scale, camera):
    """A sample in NOCSDataset's format as category_evaluation loads it
    (OpenCV camera frame, ``full`` extents, the canonical object frame the
    axis remap gives): the mesh at half max extent ``scale`` and
    CATEGORY_POSE, z-buffer rendered through ``camera``."""
    import numpy as np

    from sdfest_torch.ops import pointset
    from sdfest_torch.pipeline import synthetic

    v, f = centred_mesh(path)
    mesh = synthetic.Mesh(vertices=v, faces=f, scale=scale)
    mesh.position = np.asarray(CATEGORY_POSE[0], np.float64)
    mesh.orientation = np.asarray(CATEGORY_POSE[1], np.float64)
    depth = synthetic.draw_depth_geometry(mesh, camera).astype(np.float32)
    mask = depth > 0
    quat = mesh.orientation.astype(np.float32)
    return {
        "color": np.zeros(depth.shape + (3,), np.float32), "depth": depth,
        "pointset": pointset.depth_to_pointcloud(
            depth, camera, mask=mask, convention="opencv").astype(np.float32),
        "mask": mask, "position": mesh.position.astype(np.float32),
        "orientation": quat, "quaternion": quat,
        "scale": (mesh.vertices.max(axis=0)
                  - mesh.vertices.min(axis=0)).astype(np.float32),
        "color_path": path, "obj_path": path,
        "category_id": NOCS_IDS[category], "category_str": category,
    }


class InMemoryDataset:
    """Samples held in memory; meshes load from their .obj (centred, in the
    canonical frame: the procedural shapes need no axis remap)."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def load_mesh(self, path):
        return centred_mesh(path)


class TruthPipeline:
    """A stub pipeline that reports its samples' ground truth, in order, as
    a pipeline would (the OpenGL camera frame), with each sample's own
    mesh."""

    def __init__(self, samples, dataset):
        self.samples = list(samples)
        self.dataset = dataset
        self.current = None

    def __call__(self, depth, mask, **kwargs):
        import numpy as np
        import torch

        self.current = self.samples.pop(0)
        s = self.current
        pos = np.asarray(s["position"]) * [1.0, -1.0, -1.0]
        half = float(np.max(s["scale"])) / 2.0
        return (torch.tensor(pos[None], dtype=torch.float32),
                torch.tensor(gl_quaternion(s["quaternion"])[None],
                             dtype=torch.float32),
                torch.tensor([half]), torch.zeros(1, 8))

    def generate_mesh(self, latent, scale, complete_mesh=False):
        from sdfest_torch.pipeline import synthetic

        v, f = self.dataset.load_mesh(self.current["obj_path"])
        return synthetic.Mesh(vertices=v, faces=f,
                              scale=float(scale.reshape(-1)[0]))


def init_outputs(pipe, sample, u):
    """The init network's raw outputs on a sample (latent, position with
    the point centroid added, scale, orientation logits), its points
    subsampled with the uniforms ``u``."""
    import torch

    from sdfest_torch.ops import pointset

    dev = pipe.device
    depth = pipe._preprocess_depth(
        torch.as_tensor(sample["depth"], device=dev),
        torch.as_tensor(sample["mask"], device=dev))
    points, valid = pointset.depth_to_pointcloud_dense(depth, pipe.camera)
    points, centroid = pointset.normalize_points_masked(points, valid)
    rows, _ = pointset.subsample_with_uniforms(points, valid, u.to(dev))
    with torch.no_grad():
        latent, position, scale, logits = pipe.init_network(rows[None])
    return dict(latent=latent, position=position + centroid, scale=scale,
                logits=logits)


# the train phase: its data set, steps and units
TRAIN_MUGS, TRAIN_VAE_STEPS, TRAIN_CHAIN_K = 16, 20, 10
VAE_WEIGHTS = "trained_models/mug_procedural/mug_procedural.msgpack"
INIT_V3_WEIGHTS = ("trained_models/init_mug_procedural_v3/"
                   "init_mug_procedural_v3.msgpack")


# (stride, ROI) of the fast plan on the GT_POSES observations at 640x480
ROI_SHAPES = [(4, (64, 80)), (2, (128, 160)), (1, (240, 320))]

SOURCES = {
    "march": ("sdfest_torch/csrc/march.cu",
              "sdfest_tpu/render/pallas_kernel.py:546"),
    "march_warm": ("sdfest_torch/csrc/march.cu",
                   "sdfest_tpu/render/pallas_kernel.py:657"),
    "march_relaxed": ("sdfest_torch/csrc/march.cu",
                      "sdfest_tpu/render/pallas_kernel.py:1398, :1502"),
    "march_bf16": ("sdfest_torch/csrc/march.cu",
                   "sdfest_tpu/render/pallas_kernel.py:1296, :1445, :777"),
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
            "library_ms": r.get("library_ms"),
        })
        for sub in ("roi", "plain", "no_adaptive", "cold", "mid_refinement",
                    "culling", "no_culling", "relaxed", "warm",
                    "active_tiles", "all_miss", "flat", "zero_cotangents",
                    "dense", "single_cell", "vae_shaped", "stages_ms",
                    "hot", "empty", "all_skip", "batch", "graph", "mesh",
                    "category", "runtime", "parallel", "scripts", "train"):
            if sub in r:
                out[-1][sub] = r[sub]
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
    print(f"tf32: off for matmul; cuDNN allow_tf32 left at "
          f"{torch.backends.cudnn.allow_tf32}: the decoder's Conv3d runs in "
          "full fp32 by itself (sdfest_torch/models/vae.py: "
          "fp32_convolutions), as the CPU twin does")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from sdfest_torch.render import _build

    t0 = time.perf_counter()
    paths = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc {_build.build_seconds} s) -> {sorted(paths)}")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "error", "spill")):
                print(f"ptxas {name}: {line.strip()}")
    from sdfest_torch import native

    t0 = time.perf_counter()
    path = native.build()
    print(f"build: host library {time.perf_counter() - t0:.2f} s wall (g++ "
          f"{native.build_seconds} s; None: it was built before) -> {path}")

    smoke = Smoke()
    if set(phases) & {"pipeline", "fast", "temporal", "relaxed", "bf16",
                      "multiview", "batch", "mesh", "evaluate", "category",
                      "runtime", "parallel", "scripts", "train"}:
        phases = ["check"] + [p for p in phases if p != "check"]
    for phase in PHASES[1:]:
        if phase in phases:
            t0 = time.perf_counter()
            getattr(smoke, phase)()
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s wall")
    print(json.dumps({
        "pipeline": smoke.report.get("_pipeline"),
        "fast": smoke.report.get("_fast"),
        "fast_adaptive": smoke.report.get("_fast_adaptive"),
        "temporal": smoke.report.get("_temporal"),
        "bf16": smoke.report.get("_bf16"),
        "multiview": smoke.report.get("_multiview"),
        "batch": smoke.report.get("_batch"),
        "graph": smoke.report.get("_graph"),
        "mesh": smoke.report.get("_mesh"),
        "evaluate": smoke.report.get("_evaluate"),
        "category": smoke.report.get("_category"),
        "runtime": smoke.report.get("_runtime"),
        "parallel": smoke.report.get("_parallel"),
        "scripts": smoke.report.get("_scripts"),
        "profile": {k[len("_profile_"):]: v for k, v in smoke.report.items()
                    if k.startswith("_profile_")},
        "card": card}))
    print(json.dumps({"train": smoke.report.get("_train"), "card": card}))
    print(kernels_line(smoke.report))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
