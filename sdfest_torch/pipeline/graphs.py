"""Captured CUDA graphs of the refinement: the port's counterpart of the
compilation cache of ``jax.jit``.

The JAX package runs every refinement phase as one jitted program (``_refine``
is ``jax.jit`` over a ``lax.scan`` of its iterations,
``sdfest_tpu/pipeline/pipeline.py:359``) and, with ``fused_call: true``, the
whole estimate after the probe as one more (``_fused_program``, ``:1009``).
On the card the port captures the same stretches of work as CUDA graphs and
replays them: one graph launch in place of the ~1,200 PyTorch launches that
one iteration of one view issues from the host.

:class:`GraphCache` keys each graph by what JAX makes static (the caller's
key: plan, ROI sizes, stride, iteration counts, flags, the frozen config)
together with the structure, shapes and dtypes of its tensor inputs, so a
tracker that calls with stable shapes captures once and then only replays.

- *Capture.*  The first run of a key warms the function up on a side stream
  (the lazy work of a first use: the kernels' ``nvcc`` build and ``ctypes``
  load, the cached ray tables, cuDNN and cuBLAS handles and workspaces),
  then captures it with ``torch.cuda.graph`` into a private memory pool.
  The graph's inputs and outputs are static tensors: each run copies its
  inputs in, replays, and hands back the static outputs, which the next
  replay of that graph overwrites (callers clone what they keep).
- *Launch counts.*  A wrapper of :mod:`sdfest_torch.render.kernels` counts
  its launch when it issues it, which in a captured function happens once,
  at capture.  The cache records each graph's counts during the capture and
  adds them on every replay (the warm-up's and the capture's own counts are
  taken back), so the counts per call are those of the eager loop.
- *Ownership.*  A graph reads every tensor at the address it had at
  capture, so it owns what it reads: its static inputs, its pool, and the
  tensors its body took from a
  :func:`~sdfest_torch.utils.device.device_cache` (the cameras' rays,
  constant divisors), which it keeps alive after the cache has dropped
  them.  The pipeline's weights are read in place (a ``load_state_dict``
  shows in the next replay).
- *Memory.*  A cache keeps graphs while their pools fit in
  :data:`POOL_SHARE` of the card's memory and drops the least recently
  run first.
- *Eager.*  :func:`eager` is the counterpart of ``jax.disable_jit()``: inside
  it the card runs the plain eager loop, for tests and ``chip_smoke.py``.
- *No fallback.*  A capture or replay that fails raises.

On the CPU nothing is captured: the eager loop runs, and it is the graph's
plain version.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from sdfest_torch.render import kernels
from sdfest_torch.utils.device import holding

# the share of the card's memory that one cache's graph pools may hold;
# past it the least recently run graphs are dropped.  Pools measured on an
# H100 at 640x480: ~111 MB for a one-hypothesis call, ~823 MB for
# refine_batch of 8 (PERF.md section 5), so a quarter of 80 GB holds ~180
# call graphs (plans, ROI sizes) or ~24 batch graphs.
POOL_SHARE = 0.25
_eager_depth = 0


@contextlib.contextmanager
def eager():
    """Run the eager loop on the card inside this block (the counterpart of
    ``jax.disable_jit()``); for tests and ``chip_smoke.py``."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def is_eager() -> bool:
    """Whether an :func:`eager` block is open."""
    return _eager_depth > 0


# ---------------------------------------------------------------------------
# trees of tensors
# ---------------------------------------------------------------------------


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensors of a tree of dicts, lists, tuples, tensors and None, in
    order, and a hashable description of its structure."""
    leaves: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return "T"
        if x is None:
            return None
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return ("list" if isinstance(x, list) else "tuple",
                    tuple(walk(v) for v in x))
        raise TypeError(f"a graph's inputs and outputs are tensors in dicts, "
                        f"lists and tuples, got {type(x).__name__}")

    return leaves, walk(tree)


def unflatten(spec, leaves: List[torch.Tensor]):
    """The tree of :func:`flatten` rebuilt from its tensors (new
    containers)."""
    it = iter(leaves)

    def build(s):
        if s == "T":
            return next(it)
        if s is None:
            return None
        kind, items = s
        if kind == "dict":
            return {k: build(v) for k, v in items}
        out = [build(v) for v in items]
        return out if kind == "list" else tuple(out)

    return build(spec)


def clone(tree):
    """A copy of a tree with every tensor cloned (a caller's own copy of a
    graph's static outputs)."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [x.clone() for x in leaves])


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


class Captured(NamedTuple):
    """What a capture leaves: ``replay()`` reruns the captured work on the
    static inputs into ``outputs``; ``pool_bytes`` is the memory the graph's
    private pool holds."""
    replay: Callable[[], None]
    outputs: Any
    pool_bytes: int


class CudaGraphs:
    """Warm-up and capture with ``torch.cuda.graph`` (the card's backend of
    :class:`GraphCache`)."""

    devices = ("cuda",)

    def warm_up(self, fn: Callable[[], Any], device: torch.device) -> None:
        """Run ``fn`` once eagerly on a side stream, so that no first-use
        work (builds, library loads, cached tables, library handles) falls
        inside the capture."""
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(device).wait_stream(stream)

    def capture(self, fn: Callable[[], Any], device: torch.device
                ) -> Captured:
        with torch.cuda.device(device):
            torch.cuda.synchronize(device)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = fn()
            pool = torch.cuda.memory_reserved(device) - reserved
        return Captured(graph.replay, outputs, pool)


class _Graph(NamedTuple):
    inputs: List[torch.Tensor]
    replay: Callable[[], None]
    outputs: List[torch.Tensor]
    out_spec: Any
    counts: dict  # the kernels' launch counts of one replay
    pool_bytes: int
    keep: list  # what the body took from device caches, kept alive


class GraphCache:
    """Captured graphs of one pipeline, keyed as ``jax.jit`` keys its
    programs (see the module docstring).

    ``backend`` captures and replays (:class:`CudaGraphs` on the card; the
    CPU tests pass a stand-in with the same protocol); it acts on the
    devices of its ``devices``.  Graphs are kept while their pools fit in
    ``max_pool_bytes`` (by default :data:`POOL_SHARE` of the card's
    memory; no bound off the card), the least recently run dropped first
    (its pool is freed with it); the graph run last is always kept.

    Totals since construction: ``captures``, ``replays`` (graph launches),
    ``warm_up_seconds``, ``capture_seconds`` (capture and instantiation)
    and ``pool_bytes`` (of the graphs kept).
    """

    def __init__(self, backend=None, max_pool_bytes: Optional[int] = None
                 ) -> None:
        self.backend = backend if backend is not None else CudaGraphs()
        self.max_pool_bytes = max_pool_bytes
        self._graphs: "collections.OrderedDict[Any, _Graph]" = (
            collections.OrderedDict())
        self.captures = 0
        self.replays = 0
        self.warm_up_seconds = 0.0
        self.capture_seconds = 0.0

    def active(self, device: torch.device) -> bool:
        """Whether work on ``device`` runs as graphs (not inside
        :func:`eager`)."""
        return device.type in self.backend.devices and not is_eager()

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self._graphs.values())

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key, fn: Callable[[Any], Any], inputs, device):
        """``fn(inputs)`` as a graph: captured on the first run of ``key``
        with inputs of this structure, shapes and dtypes, replayed after
        that.  Returns the graph's static outputs in new containers (the
        next replay of this graph overwrites the tensors)."""
        leaves, spec = flatten(inputs)
        full_key = (key, spec, tuple((tuple(x.shape), x.dtype, x.device)
                                     for x in leaves))
        graph = self._graphs.get(full_key)
        if graph is None:
            graph = self._record(fn, leaves, spec, device)
            self._graphs[full_key] = graph
            self._evict(device)
        else:
            self._graphs.move_to_end(full_key)
        for dst, src in zip(graph.inputs, leaves):
            dst.copy_(src)
        graph.replay()
        self.replays += 1
        kernels.add_counts(graph.counts)
        return unflatten(graph.out_spec, graph.outputs)

    def _evict(self, device: torch.device) -> None:
        """Drop the least recently run graphs while the pools exceed the
        budget (never the graph run last)."""
        if self.max_pool_bytes is None and device.type == "cuda":
            self.max_pool_bytes = int(POOL_SHARE * torch.cuda.
                                      get_device_properties(device).
                                      total_memory)
        while (self.max_pool_bytes is not None and len(self._graphs) > 1
               and self.pool_bytes > self.max_pool_bytes):
            self._graphs.popitem(last=False)

    def _record(self, fn, leaves, spec, device) -> _Graph:
        static = [x.detach().clone() for x in leaves]
        call = lambda: fn(unflatten(spec, static))
        before = kernels.counts()
        keep: list = []
        try:
            t0 = time.perf_counter()
            self.backend.warm_up(call, device)
            t1 = time.perf_counter()
            kernels.set_counts(before)
            with holding(keep):
                captured = self.backend.capture(call, device)
            t2 = time.perf_counter()
            counts = kernels.count_difference(kernels.counts(), before)
        finally:
            kernels.set_counts(before)
        out_leaves, out_spec = flatten(captured.outputs)
        self.captures += 1
        self.warm_up_seconds += t1 - t0
        self.capture_seconds += t2 - t1
        return _Graph(static, captured.replay, out_leaves, out_spec, counts,
                      captured.pool_bytes, keep)
