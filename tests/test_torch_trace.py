"""CPU tests of the port's spans and device marks
(``sdfest_torch/utils/trace.py``): nothing recorded and no graph key
changed while tracing is off; spans nested under one call id per
``__call__``, ``refine_batch`` and chained VAE dispatch; the host reads of
the probe and of early stop; a graph of its own when captured while
recording; the ring's bound; the spans in a ``torch.profiler`` trace.

The CPU has no CUDA graph and no CUDA event: the graph cache runs on a
stand-in backend (:class:`StandIn`, a capture that runs the body and a
replay that reruns it), and a recording holds no marks.
"""
import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.render.api import render_depth
from sdfest_torch.training.vae_trainer import VAETrainer
from sdfest_torch.utils import graphs, trace
from sdfest_torch.utils.presets import preset

CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
              pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
KEYS = ("position", "orientation", "scale", "latent")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class StandIn:
    """The graph cache's backend on the CPU: a warm-up, a "capture" that
    runs the body once, and a "replay" that reruns it on the static inputs
    into the captured outputs."""

    devices = ("cpu",)

    def warm_up(self, fn, device):
        fn()

    def capture(self, fn, device):
        outputs = fn()

        def replay():
            fresh = fn()
            for dst, src in zip(graphs.flatten(outputs)[0],
                                graphs.flatten(fresh)[0]):
                if dst is not src:
                    dst.copy_(src)

        return graphs.Captured(replay, outputs, 0)


def _pipe(name="mug_procedural", **overrides):
    config = preset(name)
    config["camera"] = dict(CAMERA)
    config["max_iterations"] = 3
    config.update(overrides)
    pipe = SDFPipeline(config, device="cpu")
    pipe.graphs = graphs.GraphCache(StandIn())
    return pipe


@pytest.fixture(scope="module")
def scene():
    """A decoded mug's depth at 64x48, its tile-order cloud and two
    hypotheses around its pose."""
    pipe = _pipe()
    rng = np.random.default_rng(0)
    latent = torch.from_numpy((0.5 * rng.normal(size=(1, 8))).astype(
        np.float32))
    with torch.no_grad():
        sdf = pipe._decode(latent)[0, 0]
        depth = render_depth(sdf, GT_POSITION, GT_QUAT, 10.0,
                             camera=Camera(**CAMERA), threshold=0.005,
                             culling=False, adaptive=False, device="cpu")
    points, mask = pipe._lift(depth, 1)
    states = {
        "position": torch.from_numpy(GT_POSITION)[None, None].repeat(
            2, 1, 1) + 0.002,
        "orientation": torch.from_numpy(GT_QUAT)[None, None].repeat(2, 1, 1),
        "scale": torch.full((2, 1), 0.11),
        "latent": latent[None].repeat(2, 1, 1)}
    return dict(depth=depth, mask=(depth > 0), points=points,
                point_mask=mask, states=states)


def _estimate(pipe, scene):
    return pipe(scene["depth"], scene["mask"])


def _refine_batch(pipe, scene):
    return pipe.refine_batch(scene["states"], scene["depth"][None],
                             scene["points"][None],
                             scene["point_mask"][None], torch.zeros(1, 3),
                             torch.tensor([[0.0, 0.0, 0.0, 1.0]]))


def _chain():
    config = preset("vae_mug_procedural")
    config.update(pc_render_width=32, pc_render_height=24)
    trainer = VAETrainer(config, device="cpu")
    trainer.graphs = graphs.GraphCache(StandIn(), warm_up_runs=1)
    res = trainer.resolution
    axis = torch.linspace(-1.0, 1.0, res)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"))
    data = (grid.norm(dim=0) - 0.5)[None, None].repeat(2, 1, 1, 1, 1)
    chained = trainer.make_chained_step(data, 1, 1)
    gen = torch.Generator().manual_seed(0)
    return (lambda: chained(data, gen)), trainer.graphs


def _by_name(rec, name):
    return [s for s in rec.spans if s.name == name]


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------


def test_off_reads_no_clock_and_keeps_the_graph_keys(monkeypatch):
    """Off, a replay reads no clock and records nothing, and the cache
    keys a graph as it did before spans existed."""
    cache = graphs.GraphCache(StandIn())
    x = torch.arange(6.0).reshape(2, 3)
    fn = lambda a: {"y": a["x"] * 2.0}
    cache.run("k", fn, {"x": x}, torch.device("cpu"))
    leaves, spec = graphs.flatten({"x": x})
    assert list(cache._graphs) == [
        ("k", spec, (((2, 3), torch.float32, torch.device("cpu")),), ())]
    assert cache.warm_up_seconds > 0 and cache.capture_seconds > 0

    def no_clock():
        raise AssertionError("a clock read while tracing is off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", no_clock)
    out = cache.run("k", fn, {"x": x + 1.0}, torch.device("cpu"))
    assert torch.equal(out["y"], (x + 1.0) * 2.0)
    assert cache.captures == 1 and cache.replays == 2
    assert not trace.on and trace._rec is None
    assert trace.span("segment") is trace._OFF
    trace.mark("decode")  # nothing to record into


def test_off_call_records_nothing(scene):
    pipe = _pipe()
    _estimate(pipe, scene)
    with trace.recording() as rec:
        pass
    assert not rec.spans and not rec.marks and rec.dropped == 0


# ---------------------------------------------------------------------------
# on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["estimate", "refine_batch", "chain"])
def test_spans_nest_under_one_call_id(scene, kind):
    """Each entry call is one ``call`` span of its kind; every span inside
    it carries its id and opened in a span of the same call; a graph's
    first run holds its warm-up and capture, every run its copy-in and
    launch."""
    pipe = _pipe()
    run, cache = {"estimate": (lambda: _estimate(pipe, scene), pipe.graphs),
                  "refine_batch": (lambda: _refine_batch(pipe, scene),
                                   pipe.graphs),
                  "chain": _chain()}[kind]
    with trace.recording() as rec:
        run()
        run()
    calls = _by_name(rec, "call")
    assert [c.kind for c in calls] == [kind, kind]
    assert len({c.id for c in calls}) == 2
    assert all(c.call == c.id and c.parent == 0 for c in calls)
    ids = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name == "call":
            continue
        call = ids[s.call]
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
        assert s.parent in ids and ids[s.parent].call == s.call
    segments = _by_name(rec, "segment")
    assert len(segments) >= 2
    for name in ("copy_in", "launch"):
        assert {s.parent for s in _by_name(rec, name)} == {
            s.id for s in segments}
    assert len(_by_name(rec, "capture")) == len(_by_name(rec, "warm_up")) \
        == cache.captures >= 1
    reads = {"estimate": 2, "refine_batch": 0, "chain": 0}[kind]
    assert len(_by_name(rec, "host_read")) == reads
    assert len(_by_name(rec, "draws")) == (2 if kind == "chain" else 0)
    assert not rec.marks and rec.drift_ns == 0  # no CUDA device here


@pytest.mark.parametrize("name,overrides", [
    ("mug_procedural", {}),
    ("mug_procedural_fast_adaptive",
     dict(max_iterations=10, early_stop_interval=2, roi_margin=8)),
    ("mug_procedural_fast_adaptive",
     dict(max_iterations=10, early_stop_interval=2, roi_margin=8,
          early_stop_delta=1e-9)),
])
def test_host_reads_are_the_probe_and_the_checks(scene, name, overrides):
    """``__call__`` reads the host once for the probe and once per
    early-stop check it runs."""
    pipe = _pipe(name, **overrides)
    execute, checks = pipe._execute, []

    def spy(key, fn, carry):  # once per segment run
        checks.extend(s for s in key[1] if getattr(s, "check", False))
        return execute(key, fn, carry)

    pipe._execute = spy
    with trace.recording() as rec:
        _estimate(pipe, scene)
    reads = _by_name(rec, "host_read")
    assert len(reads) == 1 + len(checks)
    if name != "mug_procedural":
        assert checks
    (call,) = _by_name(rec, "call")
    assert all(r.call == call.id for r in reads)


def test_graph_captured_while_recording_has_its_own_key():
    cache = graphs.GraphCache(StandIn())
    cpu = torch.device("cpu")
    fn = lambda a: a * 3.0
    x = torch.ones(4)
    cache.run("k", fn, x, cpu)
    plain = list(cache._graphs)
    with trace.recording() as rec:
        cache.run("k", fn, x, cpu)
        cache.run("k", fn, x, cpu)
    assert cache.captures == 2 and cache.replays == 3
    assert list(cache._graphs) == plain + [plain[0] + (trace.KEY,)]
    assert len(_by_name(rec, "capture")) == 1
    cache.run("k", fn, x, cpu)
    assert cache.captures == 2


def test_ring_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    with trace.recording() as rec:
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
    assert [s.name for s in rec.spans] == ["s6", "s7", "s8", "s9"]
    assert rec.dropped == 6


def test_spans_show_in_a_profiler_trace(tmp_path):
    """Under ``torch.profiler`` each span is a ``user_annotation`` range
    of its name; without a recording there are none."""
    from torch.profiler import ProfilerActivity, profile

    cache = graphs.GraphCache(StandIn())
    fn = lambda a: a + 1.0

    def annotations(record):
        path = tmp_path / f"trace{int(record)}.json"
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if record:
                with trace.recording() as rec:
                    with trace.span("call"):
                        cache.run("k", fn, torch.zeros(3),
                                  torch.device("cpu"))
            else:
                rec = None
                cache.run("k", fn, torch.zeros(3), torch.device("cpu"))
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        return rec, sorted(e["name"] for e in events
                           if e.get("cat") == "user_annotation")

    rec, names = annotations(True)
    assert names == sorted(s.name for s in rec.spans)
    assert set(names) == {"call", "segment", "warm_up", "capture",
                          "copy_in", "launch"}
    assert annotations(False)[1] == []


def test_recordings_do_not_nest():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass
    assert not trace.on
