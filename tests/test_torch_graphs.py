"""CPU tests of the port's captured-graph path (``sdfest_torch/pipeline/
graphs.py``): ``__call__`` and every refinement phase as graphs, the
counterpart of the JAX package's ``jax.jit`` over ``_refine`` and its
``_fused_program``.

The CPU has no CUDA graph, so the graph cache runs here on a stand-in
backend (:class:`FakeGraphs`): its capture runs the captured body once under
:func:`no_host_reads`, which makes every host read (``Tensor.item``,
``__bool__``, ``tolist``, ``cpu``, ``numpy``, ``int``, ``float``) and every
tensor made from host data (``torch.tensor``, ``torch.as_tensor`` and
``torch.from_numpy`` of Python or numpy data) raise: the CPU's proxy for
"a stream can capture it".  The kernel wrappers lift the guard while they
run their plain versions, which read the host; on the card a kernel launch
takes their place.  A replay reruns the body on the static inputs into the
captured outputs, so copy-in, static outputs, cloning, launch counts per
replay and the segments of early stop are all exercised.  On the card the
same cache captures with ``torch.cuda.graph`` (``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s graph phase).

JAX runs in float64 here (``tests/conftest.py``); its outputs are cast to
float32.
"""
import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
from sdfest_torch.ops import pointset as tpointset
from sdfest_torch.ops.camera import Camera
from sdfest_torch.pipeline import graphs
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.ops import interpolation
from sdfest_torch.render import api, kernels, plain
from sdfest_torch.render.api import render_depth
from sdfest_torch.utils.presets import preset

SMALL_CAMERA = dict(width=64, height=48, fx=64, fy=64, cx=32, cy=24,
                    pixel_center=0.5)
GT_POSITION = np.asarray([0.02, -0.01, -0.5], np.float32)
GT_QUAT = Rotation.from_euler("XYZ", [20, 35, 10], degrees=True).as_quat(
).astype(np.float32)
GT_HALF = np.float32(0.1)
KEYS = ("position", "orientation", "scale", "latent")
PLAIN = dict(coarse_culling=False, adaptive_relaxation=False)
WARM = dict(temporal_coherence=True, temporal_refresh_interval=2)
FAST = dict(roi_margin=16)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread: beside other test workers the default thread
    count makes the CPU convolutions many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the guard and the stand-in backend
# ---------------------------------------------------------------------------


class HostRead(AssertionError):
    """A captured body read the host or copied host data to the device."""


_GUARD = {"on": False}
_READS = ("item", "__bool__", "tolist", "cpu", "numpy", "__int__",
          "__float__")
_MAKERS = ("tensor", "as_tensor", "from_numpy")


@contextlib.contextmanager
def no_host_reads():
    """Inside this block the host reads of a tensor and tensors made from
    host data raise :class:`HostRead` (outside the kernel wrappers, see
    :func:`lifted`)."""
    saved = {name: getattr(torch.Tensor, name) for name in _READS}
    makers = {name: getattr(torch, name) for name in _MAKERS}

    def read(name):
        def guarded(self, *args, **kwargs):
            if _GUARD["on"]:
                raise HostRead(f"Tensor.{name} in a captured body")
            return saved[name](self, *args, **kwargs)
        return guarded

    def make(name):
        def guarded(data, *args, **kwargs):
            if _GUARD["on"] and not isinstance(data, torch.Tensor):
                raise HostRead(f"torch.{name} of host data in a captured "
                               "body")
            return makers[name](data, *args, **kwargs)
        return guarded

    was = _GUARD["on"]
    for name in _READS:
        setattr(torch.Tensor, name, read(name))
    for name in _MAKERS:
        setattr(torch, name, make(name))
    _GUARD["on"] = True
    try:
        yield
    finally:
        _GUARD["on"] = was
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        for name, fn in makers.items():
            setattr(torch, name, fn)


def lifted(fn):
    """A kernel wrapper with the guard lifted: on the CPU it runs its plain
    version (which reads the host); on the card it launches a kernel."""
    def call(*args, **kwargs):
        was = _GUARD["on"]
        _GUARD["on"] = False
        try:
            return fn(*args, **kwargs)
        finally:
            _GUARD["on"] = was
    return call


class FakeGraphs:
    """The graph cache's backend on the CPU: a warm-up, a "capture" that
    runs the body once under :func:`no_host_reads`, and a "replay" that
    reruns it on the static inputs into the captured outputs."""

    devices = ("cpu",)

    def __init__(self, pool_bytes=0):
        self.captured = 0
        self.pool_bytes = pool_bytes

    def warm_up(self, fn, device):
        fn()

    def capture(self, fn, device):
        with no_host_reads():
            outputs = fn()
        self.captured += 1

        def replay():
            # a replay runs no Python: the wrappers count nothing
            counts = kernels.counts()
            with no_host_reads():
                fresh = fn()
            kernels.set_counts(counts)
            for dst, src in zip(graphs.flatten(outputs)[0],
                                graphs.flatten(fresh)[0]):
                if dst is not src:
                    dst.copy_(src)

        return graphs.Captured(replay, outputs, self.pool_bytes)


@pytest.fixture(autouse=True)
def guarded_kernels(monkeypatch):
    for name, fn in kernels.KERNELS.items():
        monkeypatch.setattr(kernels, name, lifted(fn))


def _config(name="mug_procedural", **overrides):
    config = preset(name)
    config["camera"] = dict(SMALL_CAMERA)
    config["max_iterations"] = 3
    config.update(overrides)
    return config


def _pipes(name="mug_procedural", **overrides):
    """``(graph, eager)``: two pipelines of one config, the first on the
    stand-in graph backend."""
    graph = SDFPipeline(_config(name, **overrides), device="cpu")
    graph.graphs = graphs.GraphCache(FakeGraphs())
    return graph, SDFPipeline(_config(name, **overrides), device="cpu")


def _np(x):
    return np.array(x, dtype=np.float32)


@pytest.fixture(scope="module")
def scene():
    """An observation of a decoded mug at 64x48, its tile-order cloud and
    three perturbed starts."""
    pipe = SDFPipeline(_config(), device="cpu")
    rng = np.random.default_rng(0)
    latent = (0.5 * rng.normal(size=(1, 8))).astype(np.float32)
    with torch.no_grad():
        sdf = pipe._decode(torch.from_numpy(latent))[0, 0]
        depth = render_depth(sdf, GT_POSITION, GT_QUAT, 1.0 / GT_HALF,
                             camera=Camera(**SMALL_CAMERA), threshold=0.005,
                             culling=False, adaptive=False, device="cpu")
    assert int((depth > 0).sum()) > 150
    points, mask = pipe._lift(depth, 1)
    starts = []
    for turn in ([4, -3, 5], [-5, 2, 3], [2, 4, -4]):
        q = (Rotation.from_euler("XYZ", turn, degrees=True)
             * Rotation.from_quat(GT_QUAT)).as_quat()
        starts.append({
            "position": torch.from_numpy(
                (GT_POSITION + 0.002 * np.asarray(turn))[None]).float(),
            "orientation": torch.from_numpy(q[None]).float(),
            "scale": torch.tensor([0.11]),
            "latent": torch.from_numpy(
                latent + 0.1 * rng.normal(size=(1, 8))).float()})
    return dict(depth=depth, points=points, mask=mask, starts=starts)


def _assert_same(got, want, label=""):
    got_leaves, got_spec = graphs.flatten(got)
    want_leaves, want_spec = graphs.flatten(want)
    assert got_spec == want_spec, label
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and torch.equal(g, w), label


# ---------------------------------------------------------------------------
# capture safety, and the graph path equal to the eager loop
# ---------------------------------------------------------------------------


def _phase_run(scene, pipe, path):
    depth, points, mask = scene["depth"], scene["points"], scene["mask"]
    start = scene["starts"][0]
    if path == "roi_stride":
        depth_c = depth[::2, ::2].contiguous()
        return pipe._refine(start, depth_c, None, None, roi=(16, 16),
                            ds_factor=2, return_full=True)
    if path == "two_views":
        cams = (torch.tensor([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0]]),
                torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 2))
        return pipe._refine(start, torch.stack([depth, depth]),
                            torch.stack([points, points]),
                            torch.stack([mask, mask]), *cams,
                            point_constraint=(torch.tensor([0.0, 0.1, 0.0]),
                                              torch.tensor([0.0, 0.1, 0.0]),
                                              0.5),
                            return_full=True)
    if path == "b3":
        states = {k: torch.stack([s[k] for s in scene["starts"]])
                  for k in KEYS}
        return pipe.refine_batch(
            states, depth[None], points[None], mask[None],
            torch.zeros(1, 3), torch.tensor([[0.0, 0.0, 0.0, 1.0]]))
    return pipe._refine(start, depth, points, mask, return_full=True)


PHASE_PATHS = {
    "full_frame": {}, "roi_stride": {}, "temporal": WARM, "two_views": {},
    "b3": {}, "early_stop": dict(early_stop_delta=1.0, early_stop_interval=1)}


@pytest.mark.parametrize("path", list(PHASE_PATHS))
def test_phase_graph_makes_no_host_read_and_equals_eager(scene, path):
    """A refinement phase through the graph cache: its body captures under
    the guard (no host read, no copy from the host), and it gives what the
    eager loop gives, bit for bit.  Early stop
    (a delta no chunk meets, interval 1) runs a chunk per graph and stops
    after the first check: rows 2.. repeat row 1 with ``active`` 0."""
    graph, eager = _pipes(**PHASE_PATHS[path])
    want = _phase_run(scene, eager, path)
    _assert_same(_phase_run(scene, graph, path), want, path)
    assert graph.graphs.backend.captured == len(graph.graphs) > 0
    log = want[-1]
    if path == "early_stop":
        assert log["active"].tolist() == [1.0, 1.0, 0.0]
        assert torch.equal(log["loss"][2], log["loss"][1])
        # chunk 0 and chunk 1, each ending on a check, then the end
        assert graph.graphs.captures == 3
    else:
        assert bool((log["active"] == 1).all())
        assert graph.graphs.captures == 1
    assert graph.graphs.replays == graph.graphs.captures


CALL_PATHS = {
    "full_frame": ("mug_procedural", {}),
    "fast": ("mug_procedural_fast", FAST),
    "temporal": ("mug_procedural", WARM),
    "two_views": ("mug_procedural", dict(init_view="best")),
    "fast_adaptive": ("mug_procedural_fast_adaptive",
                      dict(FAST, max_iterations=5, early_stop_interval=1,
                           early_stop_delta=0.3)),
}


def _call_inputs(scene, path):
    depth = scene["depth"]
    if path == "two_views":
        return (torch.stack([depth, depth]), torch.stack([depth, depth]) > 0,
                dict(camera_positions=torch.tensor([[0.0, 0.0, 0.0],
                                                    [0.01, 0.0, 0.0]]),
                     camera_orientations=torch.tensor([[0.0, 0.0, 0.0, 1.0]]
                                                      * 2)))
    return depth, depth > 0, {}


@pytest.mark.parametrize("path,fused", [
    (path, fused) for path in CALL_PATHS for fused in (True, False)
    if fused or path in ("full_frame", "fast", "fast_adaptive")])
def test_call_graph_makes_no_host_read_and_equals_eager(scene, path,
                                                        fused):
    """``__call__`` through the graph cache: preprocessing, the init and
    every phase capture under the guard, the estimate and ``last_log``
    equal the eager loop's bit for bit, ``fused_call: true`` replays one
    graph per call (with early stop one more per check the host reads)
    and ``false`` one per phase."""
    name, overrides = CALL_PATHS[path]
    graph, eager = _pipes(name, fused_call=fused, **overrides)
    depth, mask, kwargs = _call_inputs(scene, path)
    want = eager(depth, mask, **kwargs)
    got = graph(depth, mask, **kwargs)
    _assert_same(got, want, path)
    _assert_same(graph.last_log, eager.last_log, path)
    levels, _, _ = graph.last_plan
    n_phases = len(levels) + 1
    if path == "fast_adaptive":
        active = eager.last_log["active"].tolist()
        per_phase = [n for _, n, _ in levels] + [graph.last_plan[2]]
        assert len(active) == sum(per_phase) == 5
        done, at = [], 0
        for n in per_phase:
            done.append(int(sum(active[at:at + n])))
            at += n
        # a graph ends at each check the host reads: after every chunk of
        # one iteration but a phase's last; a stopped phase reads no more
        reads = sum(a if a < n else n - 1 for a, n in zip(done, per_phase))
        whole = sum(a == n for a, n in zip(done[:-1], per_phase[:-1]))
        assert graph.graphs.replays == reads + 1 + (0 if fused else whole)
    else:
        assert graph.graphs.replays == (1 if fused else n_phases)
    assert graph.graphs.captures == graph.graphs.backend.captured


def test_outputs_are_the_callers_own(scene):
    """The estimate and ``last_log`` of call k are unchanged after call
    k + 1 (on another observation), and the second call of the same shapes
    captures nothing."""
    graph, _ = _pipes()
    depth = scene["depth"]
    first = graph(depth, depth > 0)
    kept = [t.clone() for t in first]
    log = graph.last_log
    kept_log = {k: v.clone() for k, v in log.items()}
    shifted = torch.roll(depth, 2, dims=1)
    second = graph(shifted, shifted > 0)
    assert graph.graphs.captures == 1 and graph.graphs.replays == 2
    assert not torch.equal(second[0], first[0])
    _assert_same(list(first), kept)
    _assert_same(log, kept_log)


# ---------------------------------------------------------------------------
# the JAX package's __call__, fused and per phase
# ---------------------------------------------------------------------------


# per path: the JAX package's estimate, and the port's of the other
# fused_call (whichever test runs first leaves it for the second)
_CALLS = {}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("path", ["full_frame", "fast"])
def test_fused_and_per_phase_calls_match_jax(scene, monkeypatch, path,
                                             fused):
    """``fused_call: true`` (one graph) and ``false`` (one per phase) give
    the same trajectory, bit for bit, and each matches the JAX package's
    fused ``__call__`` under the same key (fed its subsampling draws)
    within the 1e-4 of ``test_call_matches_jax`` and
    ``test_fast_call_matches_jax``; culling and adaptive relaxation off, as
    JAX's CPU march."""
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    u = np.array(jax.random.uniform(key, (2500,)))
    monkeypatch.setattr(tpointset, "_uniform",
                        lambda n, g, d: torch.from_numpy(u))
    name, overrides = CALL_PATHS[path]
    seen = _CALLS.setdefault(path, {})
    if "jax" not in seen:
        jpipe = JPipeline(_config(name, **PLAIN, **overrides))
        jdepth = jnp.asarray(scene["depth"].numpy())
        seen["jax"] = [_np(x) for x in jpipe(jdepth, jdepth > 0)]
    graph, _ = _pipes(name, fused_call=fused, **PLAIN, **overrides)
    depth = scene["depth"]
    got = graph(depth, depth > 0)
    assert graph.graphs.replays == (1 if fused else
                                    1 + len(graph.last_plan[0]))
    for g, w in zip(got, seen["jax"]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4)
    assert graph.last_log["loss"].shape == (3,)
    if fused not in seen:
        seen[fused] = (got, graph.last_log)
    if True in seen and False in seen:
        _assert_same(seen[True], seen[False], path)


# ---------------------------------------------------------------------------
# Adam's count, the launch counts of replays, the eager switch
# ---------------------------------------------------------------------------


def test_adam_first_steps_match_optax():
    """The port's Adam (count an int32 tensor, bias corrections on the
    device) against optax's ``adam`` (``scale_by_adam`` then the learning
    rate) for three steps, within 1e-7."""
    pipe = SDFPipeline(_config(), device="cpu")
    adam = pipe._make_adam()
    lrs = {"position": 1e-3, "orientation": 1e-2, "scale": 1e-3,
           "latent": 1e-2}
    rng = np.random.default_rng(3)
    shapes = {"position": (1, 3), "orientation": (1, 4), "scale": (1,),
              "latent": (1, 8)}
    # parameters near 0.1, so one ulp of theirs (7.5e-9) lies well inside
    # the bar and the comparison sees the updates (1e-3 to 1e-2)
    params = {k: (0.1 * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    state = {k: torch.from_numpy(v) for k, v in params.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
               for k, v in state.items()}
    count = torch.zeros((), dtype=torch.int32)
    opts = {k: optax.adam(lrs[k]) for k in shapes}
    jstate = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = {k: opts[k].init(jstate[k]) for k in shapes}
    for g in grads:
        count = count + 1
        state, moments = adam(state, {k: torch.from_numpy(v)
                                      for k, v in g.items()}, moments, count)
        for k in shapes:
            upd, jopt[k] = opts[k].update(jnp.asarray(g[k]), jopt[k])
            jstate[k] = optax.apply_updates(jstate[k], upd)
            np.testing.assert_allclose(state[k].numpy(), _np(jstate[k]),
                                       atol=1e-7, rtol=0, err_msg=k)
    assert count.dtype == torch.int32 and int(count) == 3


def test_phase_in_chunks_equals_phase_at_once_with_a_count_tensor(scene):
    """A phase run in chunks of 1 + 2 iterations through the graph cache,
    the second carrying the first's Adam state (its count now an int32
    tensor on the device) and best tracker, ends where 3 iterations at
    once end; each chunk length captures once."""
    graph, eager = _pipes()
    views = (scene["depth"], scene["points"], scene["mask"])
    start = scene["starts"][1]
    whole, best_w, log_w = eager._refine(start, *views, num_iterations=3)
    state, opt_state, best, log_a = graph._refine(
        start, *views, num_iterations=1, return_full=True)
    count = opt_state["count"]
    assert count.dtype == torch.int32 and count.shape == () and int(
        count) == 1
    state, opt_state, best, log_b = graph._refine(
        state, *views, num_iterations=2, opt_state=opt_state, best=best,
        return_full=True)
    assert int(opt_state["count"]) == 3 and int(count) == 1
    for k in KEYS:
        assert torch.equal(state[k], whole[k]), k
        assert torch.equal(best[k], best_w[k]), k
    assert torch.equal(torch.cat([log_a["loss"], log_b["loss"]]),
                       log_w["loss"])
    assert graph.graphs.captures == 2


def test_replays_add_the_launch_counts_of_the_capture():
    """A graph records the launch counts its capture made (not the
    warm-up's) and adds them on every replay; another shape captures
    again."""
    sample, march = kernels.KERNELS["sample"], kernels.KERNELS["march"]

    def body(inputs):
        # what a kernel wrapper does when it launches
        sample.launches += 1
        sample.hypotheses += 3
        march.bf16_launches += 1
        march.rasters[(4, 4)] = march.rasters.get((4, 4), 0) + 1
        return {"y": inputs["x"] * 2.0}

    cache = graphs.GraphCache(FakeGraphs())
    kernels.reset_launches()
    try:
        for i in range(3):
            out = cache.run("k", body, {"x": torch.full((2,), float(i))},
                            torch.device("cpu"))
            assert out["y"].tolist() == [2.0 * i] * 2
        assert sample.launches == 3 and sample.hypotheses == 9
        assert march.bf16_launches == 3 and march.rasters == {(4, 4): 3}
        assert kernels.launches()["march"] == 0
        assert cache.captures == 1 and cache.replays == 3
        cache.run("k", body, {"x": torch.zeros(3)}, torch.device("cpu"))
        assert cache.captures == 2 and sample.launches == 4
    finally:
        kernels.reset_launches()


def test_eager_switch_and_the_cpu_run_no_graph(scene):
    """On the CPU the default cache captures nothing (the eager loop is the
    graph's plain version); inside ``graphs.eager()`` a graph backend is
    off too."""
    pipe = SDFPipeline(_config(), device="cpu")
    depth = scene["depth"]
    pipe(depth, depth > 0)
    assert not pipe.graphs.active(pipe.device) and len(pipe.graphs) == 0
    graph, _ = _pipes()
    with graphs.eager():
        assert graphs.is_eager()
        assert not graph.graphs.active(graph.device)
        graph(depth, depth > 0)
    assert len(graph.graphs) == 0 and not graphs.is_eager()
    assert graph.graphs.active(graph.device)


def test_graph_keeps_the_cached_tensors_it_reads_alive(scene):
    """A graph reads the cameras' rays and the sampler's divisor from
    bounded caches; it keeps every tensor it took from them alive, so a
    cache that drops them (more cameras than its size) frees nothing that
    a replay reads."""
    graph, _ = _pipes("mug_procedural_fast", **FAST)
    depth = scene["depth"]
    graph(depth, depth > 0)
    dev = graph.device
    taken = [plain.pixel_directions(graph.camera, dev),
             api._tiled_directions(graph.camera, dev),
             interpolation._divisor(2.0 / 63, dev, torch.float32)]
    for level in graph.last_plan[0]:
        taken.append(plain.pixel_directions(graph.camera.strided(level[0]),
                                            dev))
    (held,) = [g.keep for g in graph.graphs._graphs.values()]
    assert all(any(h is t for h in held) for t in taken)
    refs = [weakref.ref(t) for t in taken]
    del taken, held
    for cache in (plain.pixel_directions, api._tiled_directions,
                  interpolation._divisor):
        cache.cache_clear()
    gc.collect()
    assert all(r() is not None for r in refs)
    graph.graphs = graphs.GraphCache(FakeGraphs())
    gc.collect()
    assert all(r() is None for r in refs)


def test_cache_drops_the_least_recently_run_graphs_past_its_budget():
    """Graphs are kept while their pools fit in ``max_pool_bytes``; one
    more drops the least recently run (a replay counts as a run), and a
    dropped key captures again when it runs next.  The graph just run is
    kept even when it alone exceeds the budget."""
    cache = graphs.GraphCache(FakeGraphs(pool_bytes=100),
                              max_pool_bytes=250)
    cpu = torch.device("cpu")
    run = lambda key: cache.run(key, lambda x: {"y": x["x"] + 1.0},
                                {"x": torch.zeros(2)}, cpu)
    for key in ("a", "b", "c"):
        run(key)
    assert cache.captures == 3 and len(cache) == 2
    assert cache.pool_bytes == 200
    run("b")
    run("a")
    assert cache.captures == 4 and len(cache) == 2
    run("b")
    assert cache.captures == 4
    run("c")
    assert cache.captures == 5
    small = graphs.GraphCache(FakeGraphs(pool_bytes=100), max_pool_bytes=50)
    small.run("a", lambda x: x, {"x": torch.zeros(1)}, cpu)
    assert len(small) == 1
