"""Shared helpers of the benchmark's own tests: the repository root on the
path, and cells cut to a size the CPU runs in seconds (the port takes its
plain PyTorch versions there)."""
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the frame cells that PERF.md keeps for a later PR: their files are here,
# and these entries are what that PR adds to BENCHMARK.json
FRAME_CELLS = ("mug_procedural.frames", "bowl_procedural.fast")
PLANNED = {
    "configs": [{"name": "bowl_procedural", "source": "x",
                 "file": "bench_port/configs/bowl_procedural.json",
                 "reduced": ["views"], "why": "planned"}],
    "workloads": [{"name": "mug_procedural.frames",
                   "config": "mug_procedural", "traffic": "frames",
                   "chips": 1, "why": "planned"},
                  {"name": "bowl_procedural.fast",
                   "config": "bowl_procedural", "traffic": "fast",
                   "chips": 1, "why": "planned"}],
    "end_to_end": [{"name": "frames_per_s", "unit": "frames/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": list(FRAME_CELLS)}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower",
                   "source": "device_trace", "layer": "planned",
                   "moves": "frames_per_s", "workloads": list(FRAME_CELLS)}
                  for name, unit in (
                      ("frame_ms_p95", "ms"), ("idle_share.frames", "%"),
                      ("kernel_roofline.frames", "%"), ("mfu.frames", "%"),
                      ("kernels_per_iter.frames", "kernels/iter"),
                      ("conv_share.frames", "%"))]}


def spec(planned=True):
    """``BENCHMARK.json``, with the planned frame cells' entries added."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        out = json.load(f)
    if planned:
        for key, entries in PLANNED.items():
            names = {e["name"] for e in out[key]}
            out[key] += [e for e in entries if e["name"] not in names]
    return out


BENCH_CELLS = tuple(w["name"] for w in spec(False)["workloads"])
CELLS = BENCH_CELLS + tuple(c for c in FRAME_CELLS if c not in BENCH_CELLS)


def small_cell(name, root=ROOT, bench_dir=None, spec_=None):
    """The cell ``name`` with its camera cut 8x, 3 iterations, a pool of 2
    frames, 2 hypotheses, and a VAE batch of 2 over 2 steps."""
    from bench_port.harness import cell as cell_mod

    kw = {} if bench_dir is None else {"bench_dir": bench_dir}
    c = cell_mod.resolve(name, root, spec=spec_ if spec_ is not None
                         else spec() if root == ROOT else None, **kw)
    if "estimation" in c.config:
        est = c.config["estimation"]
        cam = est["camera"]
        for k in ("fx", "fy", "cx", "cy"):
            cam[k] = cam[k] / 8
        cam["width"] //= 8
        cam["height"] //= 8
        est["max_iterations"] = 3
        est["roi_margin"] = 4
    c.traffic.update(pool=2, hypotheses=2, dataset=8, steps_per_dispatch=2,
                     checked_calls=1, trace_calls=1)
    if "training" in c.config:
        c.config["training"].update(pc_render_width=80, pc_render_height=60,
                                    batch_size=2)
    return c


def run_small(cell, trace=False, seed=12345678901):
    """One run of ``cell`` on the CPU: its result line as a dict."""
    import torch

    from bench_port.harness import run

    torch.set_num_threads(2)
    return run.run_cell(cell, seed, 0.01, trace, torch.device("cpu"),
                        time.time(), os.path.join(
                            os.environ.get("TMPDIR", "/tmp"),
                            f"bench_port_trace_{os.getpid()}.json"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)
