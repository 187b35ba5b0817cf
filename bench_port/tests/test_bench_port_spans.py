"""The span window's readings (``harness/spans.py``) on synthetic records
of the program's spans and device marks, the span window of
``span_window.py`` run on the CPU, where the program records spans but no
device marks, and the benchmark's runs, which never record."""
import types

import pytest

from conftest import run_small, small_cell

from bench_port import span_window
from bench_port.harness import spans
from sdfest_torch.utils import trace

MS = 1_000_000
STAGES = {"decode_ms.hyp": 1.0, "render_ms.hyp": 2.25,
          "backward_ms.hyp": 3.0, "step_ms.hyp": 0.6,
          "forward_ms.train": 4.0, "backward_ms.train": 30.0,
          "update_ms.train": 1.5}
SPAN_METRICS = tuple(STAGES) + ("host_idle_share.hyp",
                                "host_idle_share.train")


def _marks(graph, t0, names_at):
    return [trace.Mark(n, t0 + int(t * MS), 0, 0, graph)
            for n, t in names_at]


def _window(marks=(), spans_=(), start=0, end=100 * MS):
    rec = types.SimpleNamespace(marks=sorted(marks, key=lambda m: m.t_ns),
                                spans=list(spans_), drift_ns=0, dropped=0,
                                dropped_marks=0)
    return spans.SpanWindow(rec, start, end, 1, (1.0, "x"))


def _read(name, win):
    """The reading ``name`` (``<reading>.<suffix>``) of ``win``, or
    ``None``."""
    return spans.readings(win, name.rsplit(".", 1)[1]).get(name)


def _call(call, begin, end, reads=()):
    out = [trace.Mark("call.begin", begin, call, call, 0),
           trace.Mark("call.end", end, call, call, 0)]
    for a, b in reads:
        out += [trace.Mark("host_read.begin", a, call, call, 0),
                trace.Mark("host_read.end", b, call, call, 0)]
    return out


def _graph_marks():
    """Two iterations of an estimate's graph and two steps of a VAE
    chain, each graph's last replay."""
    hyp = _marks(1, 0, [("iter.begin", 0), ("decode", 1), ("render", 3),
                        ("backward", 6), ("step", 6.5),
                        ("iter.begin", 6.5), ("decode", 7.5),
                        ("render", 10), ("backward", 13), ("step", 13.7)])
    vae = _marks(2, 50 * MS, [("step.begin", 0), ("forward", 4),
                              ("backward", 34), ("update", 35.5),
                              ("step.begin", 35.5), ("forward", 39.5),
                              ("backward", 69.5), ("update", 71)])
    return hyp, vae


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_ms_from_known_marks(name):
    hyp, vae = _graph_marks()
    marks = hyp if name.endswith(".hyp") else vae
    # eager marks of the same names (a warm-up's) are not a replay's
    eager = [m._replace(graph=0, t_ns=m.t_ns + 200 * MS) for m in marks]
    assert _read(name, _window(marks + eager, end=300 * MS)) == \
        pytest.approx(STAGES[name], abs=1e-9)


@pytest.mark.parametrize("calls,expected", [
    # one call busy from 10 to 90 ms of a 100 ms window
    ([_call(1, 10 * MS, 90 * MS)], 20.0),
    # two calls in flight, their intervals overlapping
    ([_call(1, 0, 60 * MS), _call(2, 40 * MS, 100 * MS)], 0.0),
    # a host read cuts its call's interval
    ([_call(1, 0, 100 * MS, reads=[(30 * MS, 55 * MS)])], 25.0),
    # intervals past the window's ends are clipped
    ([_call(1, -50 * MS, 20 * MS), _call(2, 90 * MS, 500 * MS)], 70.0),
    # a call without its end is left out
    ([_call(1, 0, 50 * MS)[:1] + _call(2, 50 * MS, 75 * MS)], 75.0),
])
def test_host_idle_share_is_a_share_of_the_window(calls, expected):
    marks = [m for c in calls for m in c]
    for name in ("host_idle_share.hyp", "host_idle_share.train"):
        got = _read(name, _window(marks))
        assert 0.0 <= got <= 100.0
        assert got == pytest.approx(expected)


def test_gaps_go_to_the_innermost_open_span():
    marks = _call(1, 10 * MS, 40 * MS) + _call(2, 60 * MS, 100 * MS)
    span = lambda i, name, a, b, parent=0: trace.Span(
        i, name, a * MS, b * MS, parent, 1)
    spans_ = [span(1, "call", 0, 40), span(2, "draws", 1, 9, 1),
              span(3, "call", 41, 100), span(4, "segment", 45, 99, 3),
              span(5, "launch", 46, 58, 4)]
    table = spans.gap_table(_window(marks, spans_))
    # 0-10 ms: in draws (mid 5); 40-60 ms: in launch (mid 50)
    assert table == [("launch", 1, 20 * MS), ("draws", 1, 10 * MS)]
    late = _call(1, 10 * MS, 40 * MS) + _call(2, 80 * MS, 100 * MS)
    assert spans.gap_table(_window(late, spans_[:2]))[0] == (
        spans.NO_SPAN, 1, 40 * MS)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_without_marks_read_nothing(name):
    assert _read(name, None) is None  # an older program: no window
    assert _read(name, _window()) is None  # no device
    # spans but no device marks, as on the CPU
    spans_ = [trace.Span(1, "call", 0, MS, 0, 1, "refine_batch")]
    assert _read(name, _window(spans_=spans_)) is None


def test_traced_cpu_run_has_span_window_and_no_span_metric(capsys):
    import torch

    torch.set_num_threads(2)
    out = span_window.measure(small_cell("mug_procedural.vae_train"),
                              12345678901, 0.01, torch.device("cpu"),
                              span_seconds=0.01)
    log = capsys.readouterr().out
    assert "trace: span window" in log and "trace: spans per call:" in log
    assert "trace: no device marks" in log
    assert out == {}


def test_untraced_run_never_records(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a --trace 0 run turned recording on")

    monkeypatch.setattr(trace, "recording", refuse)
    out = run_small(small_cell("mug_procedural.hyp8"))
    assert out["correct"] is True
    assert "hyp_iters_per_s" in out["metrics"]


def test_traced_run_never_records(monkeypatch):
    """The benchmark's profiler slice runs with tracing off: its graphs
    are the untraced program's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a --trace 1 run turned recording on")

    monkeypatch.setattr(trace, "recording", refuse)
    out = run_small(small_cell("mug_procedural.vae_train"), trace=True)
    assert out["correct"] is True
    assert not set(SPAN_METRICS) & set(out["metrics"])
