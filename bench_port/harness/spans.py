"""The span window: a cell's own calls for :data:`SPAN_WINDOW_S` seconds
with the program's spans and device marks recording
(``sdfest_torch.utils.trace``), run by ``bench_port/span_window.py``.  The
benchmark's own runs never turn recording on.

Untimed calls first capture the graphs that hold marks (the program keys
them apart from its unmarked graphs): the driver's warm-up, or one call.
Then the window runs with the same driver and the same calls in flight,
and the record is read once it has closed.  :func:`window` prints the
``trace:`` lines of the log: the device's gaps put down to the innermost
program span open at each one's middle, the window's rate beside the
untraced window's (tracing's cost when on), the clocks' drift and the
spans a call opens.  :func:`readings` reads the stages of an iteration or
a training step and the host-starved idle share, under the names the
benchmark's per-layer metrics would give them.

A program without the module (an older checkout) records nothing: the
window is skipped and there is nothing to read.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

SPAN_WINDOW_S = 10.0
# the window's calls count from here, apart from the window's and the
# profiler slice's
FIRST_CALL = (1 << 15) + 1024
NO_SPAN = "(no program span)"
# each stage's first and last device mark, by the cell's suffix: ``hyp``
# for the estimate's refinement iterations, ``train`` for the VAE's steps
STAGES = {
    "hyp": {"decode_ms": ("iter.begin", "decode"),
            "render_ms": ("decode", "render"),
            "backward_ms": ("render", "backward"),
            "step_ms": ("backward", "step")},
    "train": {"forward_ms": ("step.begin", "forward"),
              "backward_ms": ("forward", "backward"),
              "update_ms": ("backward", "update")},
}


@dataclasses.dataclass
class SpanWindow:
    record: Any  # the program's trace.Record
    start_ns: int
    end_ns: int
    calls: int
    rate: Tuple[float, str]  # the cell's end-to-end metric in the window

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


def log(msg: str) -> None:
    print(msg, flush=True)


def merge(intervals) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals as sorted disjoint pairs."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def call_intervals(marks) -> Dict[int, List[Tuple[int, int]]]:
    """Each call's device intervals: ``call.begin`` to ``call.end``, cut
    at each host read (from ``host_read.begin``, where the device has
    drained, to ``host_read.end``).  Calls missing either end are left
    out."""
    by_call: Dict[int, List] = collections.defaultdict(list)
    for m in marks:
        if m.graph == 0 and m.call:
            by_call[m.call].append(m)
    out = {}
    for call, ms in by_call.items():
        names = [m.name for m in ms]
        if "call.begin" not in names or "call.end" not in names:
            continue
        spans, opened = [], None
        for m in sorted(ms, key=lambda m: m.t_ns):
            if m.name in ("call.begin", "host_read.end"):
                opened = m.t_ns
            elif m.name in ("call.end", "host_read.begin") and \
                    opened is not None:
                spans.append((opened, m.t_ns))
                opened = None
        out[call] = spans
    return out


def busy(win: SpanWindow) -> List[Tuple[int, int]]:
    """The union of the calls' device intervals, inside the window."""
    clipped = [(max(a, win.start_ns), min(b, win.end_ns))
               for iv in call_intervals(win.record.marks).values()
               for a, b in iv]
    return merge([(a, b) for a, b in clipped if b > a])


def host_idle_share(win: SpanWindow) -> Optional[float]:
    """100 x (1 - the union of the calls' device intervals over the
    window's wall): in [0, 100], since the union is clipped to the
    window."""
    union = busy(win)
    if not union or win.wall_ns <= 0:
        return None
    return 100.0 * (1.0 - sum(b - a for a, b in union) / win.wall_ns)


def gaps(win: SpanWindow) -> List[Tuple[int, int]]:
    """The stretches of the window in which no call's device interval is
    open."""
    edges = [win.start_ns] + [x for iv in busy(win) for x in iv] + \
        [win.end_ns]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def innermost(spans, t: int) -> str:
    """The name of the innermost span open at ``t`` (the latest opened)."""
    open_ = [s for s in spans if s.start_ns <= t <= s.end_ns]
    return max(open_, key=lambda s: s.start_ns).name if open_ else NO_SPAN


def gap_table(win: SpanWindow) -> List[Tuple[str, int, int]]:
    """``(span, gaps, ns)`` of the window's gaps, by the innermost span
    open at each gap's middle, the longest first."""
    agg: Dict[str, List[int]] = collections.defaultdict(lambda: [0, 0])
    spans = list(win.record.spans)
    for a, b in gaps(win):
        row = agg[innermost(spans, (a + b) // 2)]
        row[0] += 1
        row[1] += b - a
    return sorted(((k, n, ns) for k, (n, ns) in agg.items()),
                  key=lambda r: -r[2])


def _replays(marks) -> List[List]:
    """The marks of each graph's last replay, in time order."""
    graphs: Dict[int, List] = collections.defaultdict(list)
    for m in marks:
        if m.graph:
            graphs[m.graph].append(m)
    return [sorted(ms, key=lambda m: m.t_ns) for ms in graphs.values()]


def stage_ns(marks, first: str, last: str) -> List[int]:
    """Device time from each ``first`` mark of a graph's last replay to
    the next ``last`` mark of the same graph."""
    out = []
    for ms in _replays(marks):
        for i, m in enumerate(ms):
            if m.name != first:
                continue
            end = next((n for n in ms[i + 1:] if n.name == last), None)
            if end is not None:
                out.append(end.t_ns - m.t_ns)
    return out


def iterations_ns(marks) -> List[int]:
    """Each iteration (step) of the graphs' last replays: from its
    ``.begin`` mark to the last mark before the next one."""
    out = []
    for ms in _replays(marks):
        starts = [i for i, m in enumerate(ms) if m.name.endswith(".begin")]
        for i, j in zip(starts, starts[1:] + [len(ms)]):
            out.append(ms[j - 1].t_ns - ms[i].t_ns)
    return out


def readings(win: Optional[SpanWindow], suffix: str) -> Dict[str, float]:
    """The median device ms of each stage of ``STAGES[suffix]`` over the
    last replays' iterations or steps, and the window's
    ``host_idle_share`` (%), each named ``<reading>.<suffix>``; a reading
    with nothing to read (no device marks, as on the CPU) is left out."""
    if win is None:
        return {}
    out = {}
    for name, (first, last) in STAGES[suffix].items():
        times = stage_ns(win.record.marks, first, last)
        if times:
            out[f"{name}.{suffix}"] = statistics.median(times) / 1e6
    share = host_idle_share(win)
    if share is not None:
        out[f"host_idle_share.{suffix}"] = share
    return out


def window(driver, untraced: Dict,
           seconds: float = SPAN_WINDOW_S) -> Optional[SpanWindow]:
    """Run the span window (see the module's docstring) for ``seconds``;
    ``untraced`` is the untraced window's summary (``Driver.window``)."""
    try:
        from sdfest_torch.utils import trace
    except ImportError:
        log("trace: the program records no spans; no span window")
        return None
    from bench_port.harness.drivers import _sync

    with trace.recording() as first:
        if hasattr(driver, "warm_up"):  # a call per graph it will run
            driver.warm_up()
        else:
            driver.calls(FIRST_CALL - 1, lambda n: n < 1, keep=False)
        _sync(driver.device)
    made = {n: sum(s.end_ns - s.start_ns for s in first.spans
                   if s.name == n) * 1e-9 for n in ("warm_up", "capture")}
    log(f"trace: untimed calls: warm_up {made['warm_up']:.3f} s, capture "
        f"{made['capture']:.3f} s (the graphs with marks)")
    with trace.recording() as rec:
        start = time.perf_counter_ns()
        t0 = time.perf_counter()
        done = driver.calls(FIRST_CALL, lambda n: n == 0 or
                            time.perf_counter() - t0 < seconds,
                            keep=False)
        _sync(driver.device)
        end = time.perf_counter_ns()
    elapsed = (end - start) * 1e-9
    (name, (rate, unit)), = driver.end_to_end(
        {"work": sum(d[3] for d in done), "elapsed": elapsed}).items()
    untraced_rate = driver.end_to_end(untraced)[name][0]
    win = SpanWindow(rec, start, end, len(done), (rate, unit))
    report(win, name, untraced_rate)
    return win


def report(win: SpanWindow, name: str, untraced_rate: float) -> None:
    """The ``trace:`` lines of the log."""
    rec = win.record
    rate, unit = win.rate
    log(f"trace: span window {win.calls} calls in {win.wall_ns * 1e-9:.3f} "
        f"s: {name} {rate:.6g} {unit} (untraced {untraced_rate:.6g}: "
        f"tracing costs {100 * (1 - rate / untraced_rate):.3f}%); "
        f"anchor drift {rec.drift_ns / 1e3:.3f} us; spans dropped "
        f"{rec.dropped}, marks dropped {rec.dropped_marks}")
    counts = collections.Counter(s.name for s in rec.spans)
    log("trace: spans per call: " + ", ".join(
        f"{k} {v / max(win.calls, 1):.3g}" for k, v in sorted(counts.items())))
    launch = [s.end_ns - s.start_ns for s in rec.spans if s.name == "launch"]
    if launch:
        log(f"trace: launch host ms median "
            f"{statistics.median(launch) / 1e6:.3f} max "
            f"{max(launch) / 1e6:.3f}")
    calls = call_intervals(rec.marks)
    if not calls:
        log("trace: no device marks (no CUDA device)")
        return
    device = [sum(b - a for a, b in iv) for iv in calls.values()]
    share = host_idle_share(win)
    log(f"trace: a call's device ms mean "
        f"{statistics.fmean(device) / 1e6:.3f} (min {min(device) / 1e6:.3f}"
        f" max {max(device) / 1e6:.3f}); host_idle_share "
        f"{share if share is not None else float('nan'):.4f}%")
    iters = iterations_ns(rec.marks)
    if iters:
        log(f"trace: last replay: {len(iters)} iterations, their marks span "
            f"{sum(iters) / 1e6:.3f} ms (a call's mean device ms "
            f"{statistics.fmean(device) / 1e6:.3f})")
    log("trace: gaps by innermost span (span, gaps, ms, % of the window):")
    for span, n, ns in gap_table(win)[:12]:
        log(f"trace:   {span:<20} {n:6d} {ns / 1e6:10.3f} "
            f"{100 * ns / win.wall_ns:8.4f}")
