"""One run of one cell: ``python3 bench_port/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up (the kernels' build, the weights, the inputs from the seed, the
warm-up and graph captures of the cell's own inputs), then a window of
``--seconds`` of closed-loop calls, then with ``--trace 1`` a traced slice
of the same calls for the per-layer metrics; then the program is freed
and the reference checks what the window produced.  Earlier lines report
each step; the last line of standard output is the result, and the last
lines of standard error the numbers compared beside their limits.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "sdfest_tpu")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name, clocks, power draw and power limit."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``sdfest_torch`` is not ``sdfest_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, trace_path: Optional[str] = None) -> Dict:
    """Set up, measure, trace and check one cell; returns the result line
    as a dict (``checks`` last) and prints the steps."""
    import torch

    from bench_port.harness import drivers

    driver = drivers.KINDS[cell.kind](cell, seed, device)
    if device.type == "cuda":
        from sdfest_torch.render import _build

        t0 = time.perf_counter()
        _build.build()
        log(f"setup: kernels built or found in {time.perf_counter() - t0:.3f}"
            f" s (nvcc {_build.build_seconds})")
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    setup_s = time.time() - t_start
    log(f"setup: {setup_s:.3f} s; card {card_line()}")
    w = driver.window(seconds)
    log(f"window: card {card_line()}")
    result: Dict = {"correct": False, "attempted": w["calls"], "failed": 0}
    cuda = device.type == "cuda"
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    device)) if cuda else 0}
    metrics: Dict = {}
    breakdown = None
    if trace:
        from bench_port.harness import cell as cell_mod
        from bench_port.harness import trace as trace_mod

        calls = int(cell.traffic["trace_calls"])
        t0 = time.perf_counter()
        sl = trace_mod.record(lambda: driver.slice_work(calls), trace_path)
        sl.window_ms = [x * 1e3 for x in w["latencies"]]
        sl.wall_s = driver.untraced_wall(w, sl.work["done"])
        log(f"trace: {calls} calls, {len(sl.device)} device operations, "
            f"traced wall {sl.window_s:.4f} s (untraced {sl.wall_s:.4f}), "
            f"read in "
            f"{time.perf_counter() - t0:.1f} s")
        for m in cell.per_layer:
            value = cell_mod.metric_reader(m["name"], cell.bench_dir)(sl)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
        breakdown = trace_mod.breakdown(sl)
    else:
        measured = driver.end_to_end(w)
        measured["setup_s"] = (setup_s, "s")
        for m in cell.end_to_end:
            value, unit = measured[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")
    driver.release()
    t0 = time.perf_counter()
    gaps = driver.check()
    limits = cell.traffic["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    log(f"check: reference in {time.perf_counter() - t0:.1f} s")
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = dev_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = time.time()
    args = parse(argv)
    root = os.getcwd()
    bench = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(bench, "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    from bench_port.harness import cell as cell_mod

    cell = cell_mod.resolve(args.workload, root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one process and one host thread drive the card
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out_dir = os.path.join(bench, "_out")
    os.makedirs(out_dir, exist_ok=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start,
                      os.path.join(out_dir, f"trace-{args.workload}.json"))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
