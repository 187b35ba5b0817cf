"""The three kinds of traffic the benchmark drives through the port, one
caller each (with up to the traffic's ``in_flight`` calls submitted ahead
of the answer it waits for), chosen by the traffic file's ``kind``:

- ``frames``: ``SDFPipeline.__call__`` on a pool of distinct frames, each
  call timed from submission until its pose, scale and latent are on the
  host;
- ``hypotheses``: ``SDFPipeline.refine_batch`` of ``N`` hypotheses per
  frame, each call's answer read on the host;
- ``vae_train``: ``VAETrainer.make_chained_step`` dispatches of ``K``
  steps on a data set held on the card, each dispatch's losses read on the
  host as the training script reads them.

Each driver makes its inputs from the seed in :meth:`setup`, warms and
captures only what its own inputs need, runs :meth:`window`, runs the
traced calls of :meth:`slice_work` and describes their work, keeps what
the check needs, and frees the program before :meth:`check` runs the
reference.
"""
from __future__ import annotations

import collections
import copy
import gc
import random
import statistics
import time
from typing import Dict, List, Tuple

import torch

from bench_port.harness import scenes
from bench_port.reference import estimate as ref_estimate
from bench_port.reference import models as ref_models
from bench_port.reference import ops as ref_ops
from bench_port.reference import train as ref_train

KERNELS = ("march", "sample", "sample_grad", "scatter")


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_host(x: torch.Tensor):
    """Queue the copy of ``x`` to the host behind the work queued so far;
    :func:`_await` returns it.  The caller waits on a blocking event, which
    sleeps until the device signals it (a spinning wait keeps its host core
    busy, and a host shared with other machines can take a whole scheduling
    quantum from a busy core just as the result is ready)."""
    if x.device.type != "cuda":
        return x.clone(), None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event(blocking=True)
    done.record()
    return host, done


def _await(copy) -> torch.Tensor:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host


def _reservoir(sample: List, item, seen: int, k: int, rng: random.Random):
    """Keep a uniform sample of ``k`` of the items seen so far."""
    if len(sample) < k:
        sample.append(item)
    else:
        j = rng.randrange(seen)
        if j < k:
            sample[j] = item


class Driver:
    """What the three kinds share: the cell, the seed, the device, the
    program's graph counters, and the loop of calls.

    A call is :meth:`submit` (queue the work and the copy of its result to
    the host) and :meth:`finish` (wait for that copy).  One caller keeps up
    to the traffic's ``in_flight`` calls submitted (default 1: each call
    waits for the one before)."""

    # the traced slice's calls count from here, apart from the window's
    SLICE_BASE = 1 << 15

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.traffic = cell.traffic
        self.config = cell.config
        self.root = cell.root
        self.in_flight = int(self.traffic.get("in_flight", 1))
        self.graph_caches: List = []

    def captures(self) -> int:
        return sum(g.captures for g in self.graph_caches)

    def item(self, i: int) -> int:
        """What call ``i`` works on (a frame of the pool)."""
        return 0

    def calls(self, first: int, more, keep: bool) -> List[Tuple]:
        """Calls ``first``, ``first + 1``, ... while ``more(submitted)``
        holds.  Returns per call ``(i, latency s, interval s, work)``: from
        its submission, and from the end of the call before (or the start),
        to its result on the host."""
        pending: collections.deque = collections.deque()
        done, i = [], first
        last = time.perf_counter()
        while True:
            if len(pending) < self.in_flight and more(i - first):
                pending.append((i, time.perf_counter(), self.submit(i)))
                i += 1
                continue
            if not pending:
                return done
            j, t0, handle = pending.popleft()
            work = self.finish(j, handle, keep)
            now = time.perf_counter()
            done.append((j, now - t0, now - last, work))
            last = now

    def window(self, seconds: float) -> Dict:
        """Calls for ``seconds``; every call submitted completes."""
        before = self.captures()
        start = time.perf_counter()
        done = self.calls(0, lambda n: n == 0 or
                          time.perf_counter() - start < seconds, keep=True)
        elapsed = time.perf_counter() - start
        captured = self.captures() - before
        lat = [d[1] for d in done]
        # the first call's interval holds the pipeline's fill (the host's
        # launch blocks until the device takes its commands), so the walls
        # per item leave it out where the window has more calls
        walls: Dict[int, List[float]] = {}
        for j, _, wall, _ in done[1:] or done:
            walls.setdefault(self.item(j), []).append(wall)
        q = statistics.quantiles(lat, n=20) if len(lat) > 1 else lat * 19
        log(f"window: {len(done)} calls in {elapsed:.3f} s ({self.in_flight}"
            f" in flight), {captured} captures inside the window; call ms "
            f"min {min(lat) * 1e3:.2f} median {q[9] * 1e3:.2f} p95 "
            f"{q[18] * 1e3:.2f} max {max(lat) * 1e3:.2f}")
        return {"calls": len(done), "latencies": lat, "elapsed": elapsed,
                "work": sum(d[3] for d in done), "captures": captured,
                "walls": walls}

    def untraced_wall(self, w: Dict, calls: List[int]) -> float:
        """The wall time that ``calls`` take in the untraced window ``w``:
        the window's mean interval of each call's item (of all its calls
        where the window did not run that item)."""
        mean = statistics.fmean(x for v in w["walls"].values() for x in v)
        means = {k: statistics.fmean(v) for k, v in w["walls"].items()}
        return sum(means.get(self.item(i), mean) for i in calls)

    def slice_calls(self, calls: int) -> List[int]:
        """The traced slice's calls, run as the window runs them."""
        done = self.calls(self.SLICE_BASE, lambda n: n < calls, keep=False)
        _sync(self.device)
        return [d[0] for d in done]

    def release(self) -> None:
        """Drop the program's objects before the reference runs."""
        for name in ("pipe", "trainer", "chained"):
            if hasattr(self, name):
                delattr(self, name)
        self.graph_caches = []
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# per-frame estimates
# ---------------------------------------------------------------------------


class Frames(Driver):
    """``SDFPipeline.__call__`` on a pool of distinct frames."""

    def estimation_config(self) -> Dict:
        cfg = copy.deepcopy(self.config["estimation"])
        cfg.update(copy.deepcopy(self.traffic.get("estimation", {})))
        return cfg

    def setup(self, pipe=None) -> None:
        """Build the pipeline (or take ``pipe``, one built for this cell
        before), make the inputs and warm up."""
        from sdfest_torch.pipeline.pipeline import SDFPipeline

        self.est_config = self.estimation_config()
        t0 = time.perf_counter()
        self.pipe = pipe or SDFPipeline(self.est_config, device=self.device)
        self.graph_caches = [self.pipe.graphs]
        log(f"setup: weights loaded in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        self.make_inputs()
        _sync(self.device)
        log(f"setup: pool of {self.frames['depth'].shape[0]} frames made in "
            f"{time.perf_counter() - t0:.3f} s")
        self.sample, self.rng = [], random.Random(self.seed)
        self.warm_up()

    def warm_up(self) -> None:
        """One call per distinct plan of the pool captures its graph; one
        more settles."""
        n = self.frames["depth"].shape[0]
        self.plans = [tuple(ref_estimate.plan(self.est_config,
                                              self.frames["depth"][f]))
                      for f in range(n)]
        plans = {}
        for f, key in enumerate(self.plans):
            plans.setdefault(key, f)
        for key, f in plans.items():
            t0 = time.perf_counter()
            _await(self._submit(f, self.call_seeds[-1 - f])[-1])
            log(f"setup: plan {key} warmed and captured in "
                f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        _await(self._submit(self.order[0], self.call_seeds[-1])[-1])
        log(f"setup: settling call {time.perf_counter() - t0:.3f} s; "
            f"graphs {self.pipe.graphs.captures} captured, pools "
            f"{self.pipe.graphs.pool_bytes / 1e6:.1f} MB, capture "
            f"{self.pipe.graphs.capture_seconds:.3f} s, warm-up "
            f"{self.pipe.graphs.warm_up_seconds:.3f} s")

    def make_inputs(self) -> None:
        """The pool of frames, its seeded order and the calls' seeds."""
        self.frames = scenes.make_frames(self.config, self.traffic,
                                         self.seed, self.device)
        n = self.frames["depth"].shape[0]
        self.order = torch.randperm(
            n, generator=torch.Generator().manual_seed(self.seed)).tolist()
        self.call_seeds = scenes.frame_seeds(self.seed + 1, 1 << 16)

    def item(self, i: int) -> int:
        return self.order[i % len(self.order)]

    def _submit(self, f: int, seed: int) -> Tuple:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = self.pipe(self.frames["depth"][f], self.frames["mask"][f],
                        generator=gen)
        return out, self.pipe.last_log, _to_host(
            torch.cat([o.reshape(-1) for o in out]))

    def submit(self, i: int) -> Tuple:
        return self._submit(self.item(i), self.call_seeds[i])

    def finish(self, i: int, handle: Tuple, keep: bool) -> int:
        """Wait for call ``i``'s pose, scale and latent on the host; a
        seeded sample of the window's calls is kept for the check."""
        out, log_, copy_ = handle
        _await(copy_)
        if keep:
            _reservoir(self.sample, (i, self.item(i), self.call_seeds[i],
                                     out, log_), i + 1,
                       int(self.traffic["checked_calls"]), self.rng)
        return 1

    def slice_work(self, calls: int) -> Dict:
        """Run ``calls`` calls and describe their work from the frames'
        plans (the reference's plan function)."""
        launches = {k: {} for k in KERNELS}
        decodes = iterations = 0
        done = self.slice_calls(calls)
        cam = self.est_config["camera"]
        for i in done:
            for factor, n, roi in self.plans[self.item(i)]:
                rows = (roi[0] * roi[1] if roi else
                        (cam["height"] // factor) * (cam["width"] // factor))
                for k, r in (("march", rows), ("sample", rows),
                             ("sample_grad", 2 * rows),
                             ("scatter", 2 * rows)):
                    launches[k][(r, 1)] = launches[k].get((r, 1), 0) + n
                decodes += n
                iterations += n
        return {"calls": calls, "done": done, "iterations": iterations,
                "views": 1,
                "launches": {k: [(r, b, c) for (r, b), c in v.items()]
                             for k, v in launches.items()},
                "decodes": decodes, "init_sets": calls,
                "init_points": self.est_config.get("num_input_points", 2500),
                "model": self.est_config}

    def check(self) -> Dict[str, float]:
        ref = ref_estimate.Estimate(self.est_config, self.root, self.device)
        worst = {"step_gap": 0.0, "loss_gap": 0.0}
        for i, f, seed, out, log_ in self.sample:
            n_pts = self.est_config.get("num_input_points", 2500)
            u = torch.rand(n_pts, generator=torch.Generator(
                device=self.device).manual_seed(seed), device=self.device)
            prog_log = {k: log_[k] for k in ref_estimate.STATE_KEYS}
            prog_log["loss"] = log_["loss"].reshape(-1, 1)
            answer = dict(zip(ref_estimate.STATE_KEYS, out))
            got = ref.follow(self.frames["depth"][f], prog_log, answer,
                             mask=self.frames["mask"][f], uniforms=u)
            log(f"check: call {i} (frame {f}): step_gap {got['step_gap']:.6g}"
                f" at iteration {got['step_at']} ({got['step_key']}), "
                f"loss_gap {got['loss_gap']:.6g} at iteration "
                f"{got['loss_at']}")
            for k in worst:
                worst[k] = max(worst[k], got[k])
        return worst

    def end_to_end(self, w: Dict) -> Dict[str, Tuple[float, str]]:
        return {"frames_per_s": (w["work"] / w["elapsed"], "frames/s")}


# ---------------------------------------------------------------------------
# hypothesis batches
# ---------------------------------------------------------------------------


class Hypotheses(Frames):
    """``SDFPipeline.refine_batch`` of ``N`` hypotheses around each frame's
    true pose, full frame, no adaptive stop."""

    def warm_up(self) -> None:
        """Two calls: the first captures the phase's graph."""
        for j in range(2):
            t0 = time.perf_counter()
            _await(self._submit(self.item(j))[-1])
            log(f"setup: call {j} {time.perf_counter() - t0:.3f} s; graphs "
                f"{self.pipe.graphs.captures} captured, pools "
                f"{self.pipe.graphs.pool_bytes / 1e6:.1f} MB")

    def make_inputs(self) -> None:
        """The pool of frames with their lifted clouds and starts, and
        its seeded order."""
        fr = self.frames = scenes.make_frames(self.config, self.traffic,
                                              self.seed, self.device)
        n = fr["depth"].shape[0]
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        cam = scenes.camera_of(self.est_config)
        self.items = []
        for f in range(n):
            points, mask = ref_ops.lift(fr["depth"][f], cam, order="tile")
            starts = scenes.hypothesis_starts(
                fr, f, self.traffic, self.est_config["vae"]["latent_size"],
                gen, self.device)
            self.items.append((fr["depth"][f][None].contiguous(),
                               points[None].contiguous(), mask[None],
                               starts))
        self.cam_pos = torch.zeros(1, 3, device=self.device)
        self.cam_q = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        self.order = torch.randperm(
            n, generator=torch.Generator().manual_seed(self.seed)).tolist()

    def _submit(self, f: int) -> Tuple:
        depth, points, mask, starts = self.items[f]
        states, _, log_ = self.pipe.refine_batch(
            starts, depth, points, mask, self.cam_pos, self.cam_q)
        return states, log_, _to_host(torch.cat(
            [states[k].reshape(-1) for k in ref_estimate.STATE_KEYS]))

    def submit(self, i: int) -> Tuple:
        return self._submit(self.item(i))

    def finish(self, i: int, handle: Tuple, keep: bool) -> int:
        states, log_, copy_ = handle
        _await(copy_)
        if keep:
            _reservoir(self.sample, (i, self.item(i), states, log_), i + 1,
                       int(self.traffic["checked_calls"]), self.rng)
        return int(self.traffic["hypotheses"]) * int(
            self.est_config["max_iterations"])

    def slice_work(self, calls: int) -> Dict:
        n_h = int(self.traffic["hypotheses"])
        cam = self.est_config["camera"]
        rows = cam["height"] * cam["width"]
        t = int(self.est_config["max_iterations"])
        done = self.slice_calls(calls)
        n = calls * t
        return {"calls": calls, "done": done, "iterations": n, "views": 1,
                "launches": {"march": [(rows, n_h, n)],
                             "sample": [(rows, n_h, n)],
                             "sample_grad": [(2 * rows, n_h, n)],
                             "scatter": [(2 * rows, n_h, n)]},
                "decodes": n * n_h, "init_sets": 0, "init_points": 0,
                "model": self.est_config}

    def check(self) -> Dict[str, float]:
        ref = ref_estimate.Estimate(self.est_config, self.root, self.device)
        worst = {"step_gap": 0.0, "loss_gap": 0.0}
        t = int(self.est_config["max_iterations"])
        for i, f, states, log_ in self.sample:
            depth, points, mask, starts = self.items[f]
            # the log's (N, T, 1, ...) as (T, N, ...)
            prog = {k: log_[k][:, :, 0].transpose(0, 1)
                    for k in ref_estimate.STATE_KEYS}
            prog["loss"] = log_["loss"].transpose(0, 1)
            answer = {k: states[k][:, 0] for k in ref_estimate.STATE_KEYS}
            start = {k: starts[k][:, 0] for k in ref_estimate.STATE_KEYS}
            got = ref.follow(depth[0], prog, answer, start=start,
                             points=points[0], point_mask=mask[0],
                             phases=[(1, t, None)])
            log(f"check: call {i} (frame {f}): step_gap {got['step_gap']:.6g}"
                f" at iteration {got['step_at']} ({got['step_key']}), "
                f"loss_gap {got['loss_gap']:.6g} at iteration "
                f"{got['loss_at']}")
            for k in worst:
                worst[k] = max(worst[k], got[k])
        return worst

    def end_to_end(self, w: Dict) -> Dict[str, Tuple[float, str]]:
        return {"hyp_iters_per_s": (w["work"] / w["elapsed"],
                                    "hyp-iters/s")}


# ---------------------------------------------------------------------------
# VAE training
# ---------------------------------------------------------------------------


def vae_weights(vae_config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Starting weights of the VAE from the seed, in one draw on the
    device, as the JAX package's flax layers start: every kernel normal
    with variance ``1/fan_in`` (LeCun), every bias zero."""
    shapes = {n: tuple(p.shape) for n, p in
              ref_models.VAE(vae_config).named_parameters()}
    kernels = {n: s for n, s in shapes.items() if n.endswith(".weight")}
    total = sum(torch.Size(s).numel() for s in kernels.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name not in kernels:
            out[name] = torch.zeros(shape, device=device)
            continue
        fan_in = torch.Size(shape[1:]).numel()
        n = torch.Size(shape).numel()
        out[name] = (flat[at:at + n] / fan_in ** 0.5).reshape(shape)
        at += n
    return out


class VaeTrain(Driver):
    """``VAETrainer.make_chained_step`` of ``K`` steps on procedural mugs
    held on the card."""

    def setup(self) -> None:
        from sdfest_torch.training.vae_trainer import VAETrainer

        t0 = time.perf_counter()
        self.make_inputs()
        self.trainer = VAETrainer(self.train_config, device=self.device)
        self.graph_caches = [self.trainer.graphs]
        self.trainer.vae.load_state_dict(self.start)
        self.chained = self.trainer.make_chained_step(self.data, self.batch,
                                                      self.k)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seed + 4)
        _sync(self.device)
        log(f"setup: trainer, weights and {self.data.shape[0]} grids in "
            f"{time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        first = self._run()
        names = [n for n, _ in self.trainer.vae.named_parameters()]
        self.program = {
            "losses": first["loss"].tolist(),
            "grads": {n: p.grad.detach().clone() for n, p in zip(
                names, self.trainer.vae.parameters())},
            "params": {n: p.detach().clone() for n, p in zip(
                names, self.trainer.vae.parameters())}}
        log(f"setup: first dispatch (warm-up, capture, {self.k} steps) "
            f"{time.perf_counter() - t0:.3f} s; pools "
            f"{self.trainer.graphs.pool_bytes / 1e6:.1f} MB")
        t0 = time.perf_counter()
        self._run()
        log(f"setup: second dispatch {time.perf_counter() - t0:.3f} s")

    def make_inputs(self) -> None:
        """The starting weights and the data set from the seed."""
        cfg = self.train_config = copy.deepcopy(self.config["training"])
        self.start = vae_weights(cfg, self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 3)
        self.data = scenes.mug_grids(int(self.traffic["dataset"]), gen,
                                     self.device)[:, None].contiguous()
        self.k = int(self.traffic["steps_per_dispatch"])
        self.batch = int(cfg["batch_size"])

    def submit(self, i: int) -> Tuple:
        metrics = self.chained(self.data, self.gen)
        return metrics, _to_host(metrics["loss"])

    def finish(self, i: int, handle: Tuple, keep: bool) -> int:
        _await(handle[1]).tolist()  # the training script's read
        return self.k

    def _run(self) -> Dict:
        handle = self.submit(0)
        self.finish(0, handle, False)
        return handle[0]

    def slice_work(self, calls: int) -> Dict:
        done = self.slice_calls(calls)
        cfg = self.train_config
        n = calls * self.k
        rows = cfg.get("pc_render_width", 640) * cfg.get(
            "pc_render_height", 480)
        return {"calls": calls, "done": done, "steps": n,
                "launches": {"march": [(rows, self.batch, n)],
                             "sample_grad": [(rows, self.batch, n)],
                             "scatter": [(rows, self.batch, n)]},
                "train_samples": n * self.batch, "model": cfg}

    def draws(self) -> List:
        """The first dispatch's draws, as the chained step makes them."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 4)
        n, out = self.data.shape[0], []
        for _ in range(self.k):
            idx = torch.randint(0, n, (self.batch,), generator=gen,
                                device=self.device)
            eps = torch.randn(self.batch, self.train_config["latent_size"],
                              generator=gen, device=self.device)
            quats = ref_ops.q_random((self.batch,), gen, self.device)
            out.append((idx, eps, quats))
        return out

    def check(self) -> Dict[str, float]:
        ref = ref_train.follow(self.train_config, self.start, self.data,
                               self.draws())
        got = ref_train.compare(self.program, ref, self.start)
        log(f"check: worst leaves: gradient {got['grad_leaf']}, change "
            f"{got['change_leaf']}")
        log("check: losses program " + " ".join(
            f"{x:.9g}" for x in self.program["losses"]) + " reference "
            + " ".join(f"{x:.9g}" for x in ref["losses"]))
        return got

    def end_to_end(self, w: Dict) -> Dict[str, Tuple[float, str]]:
        return {"vae_steps_per_s": (w["work"] / w["elapsed"], "steps/s")}


KINDS = {"frames": Frames, "hypotheses": Hypotheses, "vae_train": VaeTrain}
