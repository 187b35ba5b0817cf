"""Captured CUDA graphs: the port's counterpart of the compilation cache of
``jax.jit``, for the pipeline and the trainers.

The JAX package runs every refinement phase as one jitted program (``_refine``
is ``jax.jit`` over a ``lax.scan`` of its iterations,
``sdfest_tpu/pipeline/pipeline.py:359``) and, with ``fused_call: true``, the
whole estimate after the probe as one more (``_fused_program``, ``:1009``);
its trainers jit every step and chain ``steps_per_dispatch`` steps into one
program (``sdfest_tpu/training/vae_trainer.py:210-250``,
``init_trainer.py:133-305``).  On the card the port captures the same
stretches of work as CUDA graphs and replays them: one graph launch in place
of the ~1,200 PyTorch launches that one iteration of one view issues from
the host.

:class:`GraphCache` keys each graph by what JAX makes static (the caller's
key: plan, ROI sizes, stride, iteration counts, K, batch sizes, flags, the
frozen config) together with the structure, shapes and dtypes of its tensor
inputs, so a caller with stable shapes captures once and then only replays.

- *Capture.*  The first run of a key warms the function up on a side stream
  (``warm_up_runs`` times: the lazy work of a first use, the kernels'
  ``nvcc`` build and ``ctypes`` load, the cached ray tables, cuDNN and
  cuBLAS handles and workspaces, autograd's buffers), then captures it with
  ``torch.cuda.graph`` into a private memory pool.  The graph's inputs and
  outputs are static tensors: each run copies its inputs in, replays, and
  hands back the static outputs, which the next replay of that graph
  overwrites (callers clone what they keep).
- *State.*  A trainer's body writes its state in place (parameters, Adam's
  moments and counts, BatchNorm statistics, a replay ring, an iteration
  counter): the caller names those tensors (``state``), the cache copies
  them before the warm-up and puts them back after the warm-up and after
  the capture, so the first run takes exactly one step.  Tensors the body
  only reads in place (``resident``: a dataset held on the card) are not
  copied.  Both are part of the key by their address and kept alive by
  the graph.
- *Launch counts.*  A wrapper of :mod:`sdfest_torch.render.kernels` counts
  its launch when it issues it, which in a captured function happens once,
  at capture.  The cache records each graph's counts during the capture and
  adds them on every replay (the warm-up's and the capture's own counts are
  taken back), so the counts per call are those of the eager loop.
- *Ownership.*  A graph reads every tensor at the address it had at
  capture, so it owns what it reads: its static inputs, its pool, its
  state and resident tensors, and the tensors its body took from a
  :func:`~sdfest_torch.utils.device.device_cache` (the cameras' rays,
  constant divisors), which it keeps alive after the cache has dropped
  them.  The pipeline's weights are read in place (a ``load_state_dict``
  shows in the next replay).
- *Memory.*  A cache keeps graphs while their pools fit in
  :data:`POOL_SHARE` of the card's memory and drops the least recently
  run first.
- *Tracing.*  Each run is a ``segment`` span (:mod:`sdfest_torch.utils.trace`)
  with ``copy_in`` and ``launch``, and ``warm_up`` and ``capture`` on a
  key's first run, whose clock reads give ``warm_up_seconds`` and
  ``capture_seconds``.  A graph captured while a recording is open holds
  the body's device marks as event nodes and is keyed apart; with tracing
  off the keys and nodes are those of an untraced cache.
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
from typing import (Any, Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from sdfest_torch.render import kernels
from sdfest_torch.utils import trace
from sdfest_torch.utils.device import holding

# the share of the card's memory that one cache's graph pools may hold;
# past it the least recently run graphs are dropped.  Pools measured on an
# H100 at 640x480: ~111 MB for a one-hypothesis call, ~823 MB for
# refine_batch of 8 (PERF.md section 5), so a quarter of 80 GB holds ~180
# call graphs (plans, ROI sizes) or ~24 batch graphs.
POOL_SHARE = 0.25
# eager runs before a trainer's capture: the first builds what a first step
# builds (Adam's state, autograd's and cuDNN's workspaces), the second runs
# on what the first left, as the capture will (PyTorch's recipe for
# capturing a whole network warms up over several steps)
TRAIN_WARM_UP_RUNS = 2
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


def stack(trees: Sequence[dict]) -> dict:
    """Dicts of per-step tensors stacked on a leading axis, oldest first
    (the stacked outputs of ``lax.scan``)."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


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
    keep: list  # state, resident and device-cache tensors, kept alive
    marks: list  # its device marks (trace.capturing), empty untraced


class GraphCache:
    """Captured graphs of one pipeline or trainer, keyed as ``jax.jit`` keys
    its programs (see the module docstring).

    ``backend`` captures and replays (:class:`CudaGraphs` on the card; the
    CPU tests pass a stand-in with the same protocol); it acts on the
    devices of its ``devices``.  Graphs are kept while their pools fit in
    ``max_pool_bytes`` (by default :data:`POOL_SHARE` of the card's
    memory; no bound off the card), the least recently run dropped first
    (its pool is freed with it); the graph run last is always kept.  A
    capture is preceded by ``warm_up_runs`` eager runs.

    Totals since construction: ``captures``, ``replays`` (graph launches),
    ``warm_up_seconds``, ``capture_seconds`` (capture and instantiation)
    and ``pool_bytes`` (of the graphs kept).
    """

    def __init__(self, backend=None, max_pool_bytes: Optional[int] = None,
                 warm_up_runs: int = 1) -> None:
        self.backend = backend if backend is not None else CudaGraphs()
        self.max_pool_bytes = max_pool_bytes
        self.warm_up_runs = warm_up_runs
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

    def call(self, key, fn: Callable[[Any], Any], inputs, device,
             state: Sequence[torch.Tensor] = (),
             resident: Sequence[torch.Tensor] = ()):
        """``fn(inputs)``: one replay of its graph (:meth:`run`) where the
        cache is :meth:`active` on ``device``, else the eager run (the
        graph's plain version)."""
        if self.active(device):
            return self.run(key, fn, inputs, device, state, resident)
        return fn(inputs)

    def run(self, key, fn: Callable[[Any], Any], inputs, device,
            state: Sequence[torch.Tensor] = (),
            resident: Sequence[torch.Tensor] = ()):
        """``fn(inputs)`` as a graph: captured on the first run of ``key``
        with inputs of this structure, shapes and dtypes (and these
        ``state`` and ``resident`` tensors), replayed after that.  Returns
        the graph's static outputs in new containers (the next replay of
        this graph overwrites the tensors)."""
        with trace.span("segment", marks=True):
            leaves, spec = flatten(inputs)
            held = list(state) + list(resident)
            full_key = (key, spec, tuple((tuple(x.shape), x.dtype, x.device)
                                         for x in leaves),
                        tuple((x.data_ptr(), tuple(x.shape), x.dtype)
                              for x in held))
            if trace.on:
                full_key += (trace.KEY,)
            graph = self._graphs.get(full_key)
            if graph is None:
                graph = self._record(fn, leaves, spec, device, list(state),
                                     held)
                self._graphs[full_key] = graph
                self._evict(device)
            else:
                self._graphs.move_to_end(full_key)
            with trace.span("copy_in"):
                for dst, src in zip(graph.inputs, leaves):
                    dst.copy_(src)
            with trace.span("launch"):
                graph.replay()
            trace.replayed(graph.marks)
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

    def _record(self, fn, leaves, spec, device, state, held) -> _Graph:
        static = [x.detach().clone() for x in leaves]
        call = lambda: fn(unflatten(spec, static))
        saved = [x.detach().clone() for x in state]

        @torch.no_grad()
        def restore():
            for dst, src in zip(state, saved):
                dst.copy_(src)

        before = kernels.counts()
        keep: list = list(held)
        try:
            with trace.timed("warm_up") as warm:
                for _ in range(self.warm_up_runs):
                    self.backend.warm_up(call, device)
                restore()
            kernels.set_counts(before)
            with trace.timed("capture") as capture, \
                    trace.capturing() as marks:
                with holding(keep):
                    captured = self.backend.capture(call, device)
                restore()
            counts = kernels.count_difference(kernels.counts(), before)
        finally:
            kernels.set_counts(before)
        out_leaves, out_spec = flatten(captured.outputs)
        self.captures += 1
        self.warm_up_seconds += warm.seconds
        self.capture_seconds += capture.seconds
        return _Graph(static, captured.replay, out_leaves, out_spec, counts,
                      captured.pool_bytes, keep, marks)
