"""A traced slice of a run: ``torch.profiler`` over a few of the cell's own
calls after the measured window, saved as the profiler's Chrome trace and
read back as device intervals, kernel names and the host's spans.

:class:`Slice` is what every per-layer metric's ``read`` receives: the
device operations (kernels, copies, sets) with their times, the slice's
wall time, the port's kernel launch counts made during it, and the work
done in it (calls, iterations, hypotheses, training steps, the shapes of
each kernel's launches).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# idle gaps shorter than this are summed, not named one by one
SHORT_GAP_S = 20e-6


@dataclasses.dataclass
class Slice:
    window_s: float
    # (name, start s, end s, category): kernels, copies and sets
    device: List[Tuple[str, float, float, str]]
    host: List[Tuple[str, float, float]]
    work: Dict
    # the measured window's per-call latencies (host clock, ms)
    window_ms: List[float] = dataclasses.field(default_factory=list)
    # the wall time that the slice's calls took in the untraced window
    # (host clock, s): the profiler stretches the slice's own wall
    wall_s: float = 0.0

    def kernels(self, pattern: str = "") -> List[Tuple]:
        """The kernel launches whose names match ``pattern``."""
        rx = re.compile(pattern)
        return [e for e in self.device
                if e[3] == "kernel" and rx.search(e[0])]

    def union_s(self, events=None) -> float:
        return sum(b - a for a, b in merge(events if events is not None
                                           else self.device))

    @property
    def busy_s(self) -> float:
        return self.union_s()


def merge(events) -> List[Tuple[float, float]]:
    """The union of the intervals of ``events`` as sorted disjoint
    ``(start, end)`` pairs."""
    out: List[List[float]] = []
    for e in sorted(events, key=lambda e: e[1]):
        a, b = e[1], e[2]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def record(run: Callable[[], Dict], path: str) -> Slice:
    """Profile ``run()`` (which returns its work counts) into a Chrome
    trace at ``path`` and read it back."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.slice"):
            work = run()
        sync()
        window = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", ""), e["ts"] * 1e-6,
                (e["ts"] + e["dur"]) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(item + (cat,))
        elif cat in HOST_CATS:
            host.append(item)
    return Slice(window, device, host, work)


def breakdown(sl: Slice, n: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the device's idle
    time summed by what the host was doing (the innermost host span open
    at each gap's middle), the longest first."""
    by_name: Dict[str, float] = {}
    for name, a, b, _ in sl.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    busy = merge(sl.device)
    gaps = []
    slice_span = [h for h in sl.host if h[0] == "bench.slice"]
    if slice_span and busy:
        lo, hi = slice_span[0][1], slice_span[0][2]
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if 0 < b - a < SHORT_GAP_S:
                gaps.append((b - a, "(gaps under 20 us between device ops)"))
            elif b > a:
                mid = (a + b) / 2
                open_ = [h for h in sl.host
                         if h[1] <= mid <= h[2] and h[0] != "bench.slice"]
                name = min(open_, key=lambda h: h[2] - h[1])[0] \
                    if open_ else "(no host span)"
                gaps.append((b - a, name))
    agg: Dict[str, float] = {}
    for dur, name in gaps:
        agg[name] = agg.get(name, 0.0) + dur
    return {"device_ops": [[_short(k), v] for k, v in ops],
            "idle_gaps": [[_short(k), v] for k, v in
                          sorted(agg.items(), key=lambda kv: -kv[1])[:n]]}


def _short(name: str) -> str:
    name = " ".join(name.split())
    return name if len(name) <= 120 else name[:117] + "..."

