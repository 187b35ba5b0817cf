"""SDF pose, scale and shape estimation from one or more depth views
(counterpart of ``SDFPipeline`` in ``sdfest_tpu/pipeline/pipeline.py``).

``__call__`` runs: mask + far-field cut of the depth -> the probe (empty
check and the object's bbox spans, per view) -> the plan -> dense point
clouds -> PointNet init network with the discretized SO(3) head on every
view (``init_view`` "first" or "best", optional prior orientation
distributions) -> refinement phases.  Each iteration decodes the latent to a
64^3 SDF and, for each view in its own camera frame, renders it fused with
the pc values (:func:`render_depth_with_pc_values`: march and sample kernels
forward, sample-grad and scatter kernels backward); the depth-L1 and pc
losses are summed over the views (plus an optional point constraint on the
orientation), followed by an Adam step with per-variable learning rates,
renormalization of the quaternion and tracking of the best inlier ratio
(of the last view).  ``bf16_march`` gates the march's fine steps with bf16
samples (``csrc/march.cu``).  ``reuse_plan`` keeps the plan of the previous
call and skips the probe.

The plan is the JAX package's fused one (``_plan_for``): the coarse levels
of ``multires_factor`` (each against the exactly-strided sub-observation of
``Camera.strided``), then the full-resolution phase; each phase renders
only an ROI crop around the observed pixels when ``roi_size`` is set and
the object fits (``fast.yaml``: ``roi_size: auto``, ``[4, 2]``).

With ``temporal_coherence`` (preset ``mug_procedural_temporal``) every
iteration renders through the warm/aux corridor march instead
(:mod:`sdfest_torch.render.warm`: warm starts, skipped rays and a full
refresh every ``temporal_refresh_interval`` iterations) and the pc loss is
sampled on its own; it rules out ROI and multires, so the plan is one
full-frame phase.  ``relaxation > 1`` takes the relaxed march.

The loop has no host synchronisation: the best estimate is tracked with
``torch.where`` and the log goes into preallocated ``(T, B, ...)``
buffers.  The one sync of a call reads the probe (:class:`NoDepthError`
and the plan).  Early stop (``early_stop_delta > 0``, preset
``mug_procedural_fast_adaptive``) adds one host read per check of each
phase that can still stop it: every ``early_stop_interval`` iterations but
at a phase's end, at most 4 per 50-iteration call at the default interval
of 10 (2 under the fast plan's 20 / 20 / 10).

On the card the work after the probe runs as captured CUDA graphs
(:mod:`sdfest_torch.utils.graphs`), the counterpart of the JAX
package's ``jax.jit`` over ``_refine`` and its ``_fused_program``: the
call is a list of steps (:class:`_Prologue`: preprocessing and the init;
per phase :class:`_Views`, its view inputs, and :class:`_Chunk`, its
iterations; :class:`_End`, the outputs) cut into segments
(:func:`_segment_end`), each one graph, captured on its first run and
replayed after that.  The CPU runs the same steps eagerly.

:meth:`SDFPipeline.refine_batch` refines ``N`` hypotheses against shared
views with ONE launch of each kernel per view and iteration for all of
them (the kernels take the hypothesis as a launch dimension): full frame,
multires + ROI, adaptive chunks and temporal, each hypothesis on the
trajectory of its own ``_refine``.

:meth:`SDFPipeline.generate_depth` renders an estimate with the pipeline's
camera (one march launch on the card) and :meth:`SDFPipeline.generate_mesh`
extracts its mesh (the decoder on the device, marching tetrahedra on the
host).  ``__call__``'s flight recorder (``log_path``) pickles the
per-iteration log as numpy, in the JAX package's keys and shapes, so a log
of either package plays back in the other's ``play_log``;
``animation_path`` exports its animation through
:mod:`sdfest_torch.scripts.play_log` and ``visualize`` saves a figure of
the optimization.  Plots and movies need matplotlib (and ffmpeg for an
mp4), which the card's machine lacks: there they run on the CPU side only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import pickle
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.models.vae import (
    create_decoder_from_config,
    fp32_convolutions,
)
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.pipeline import losses
from sdfest_torch.render.api import (
    crop,
    ray_set,
    render_depth,
    render_depth_with_pc_values,
)
from sdfest_torch.render.warm import (
    init_warm_views,
    motion_bound,
    warm_render_step,
)
from sdfest_torch.utils import graphs
from sdfest_torch.utils.device import resolve_device
from sdfest_torch.utils.weights import load_decoder_weights, load_init_weights

_STATE_KEYS = ("position", "orientation", "scale", "latent")
# the log's entries with one value per hypothesis and iteration
_LOSS_KEYS = ("loss", "loss_depth", "loss_pc", "inlier_ratio")


class _Phase(NamedTuple):
    """The static part of one refinement phase: what ``jax.jit`` takes as
    static in the JAX package's ``_refine`` (``pipeline.py:359``), so it
    keys the phase's graphs (:mod:`sdfest_torch.utils.graphs`)."""

    n_iter: int
    roi: Optional[Tuple[int, int]]
    ds_factor: int
    shape_optimization: bool
    constraint_weight: Optional[float]  # None without a point constraint
    early: bool  # early stop checks every early_stop_interval iterations


# the steps of the captured program (_drive); a segment of them is one graph


@dataclasses.dataclass(frozen=True)
class _Prologue:
    """``__call__`` before its phases: preprocessing and the init."""


@dataclasses.dataclass(frozen=True)
class _Views:
    """A ``__call__`` phase's view inputs: the views strided by ``factor``,
    rendered in ``roi`` crops (None: full frame)."""

    factor: int
    roi: Optional[Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class _Chunk:
    """Iterations ``start .. start + n - 1`` of phase number ``index``;
    with ``check`` an early-stop check follows, which the host reads."""

    index: int
    phase: _Phase
    start: int
    n: int
    check: bool

    @property
    def ends_phase(self) -> bool:
        return self.start + self.n == self.phase.n_iter


@dataclasses.dataclass(frozen=True)
class _End:
    """The outputs: final state, best, Adam state and the logs."""


def _segment_end(steps: list, i: int, fused: bool) -> int:
    """The end of the segment (one graph on the card) that starts at step
    ``i``: a segment ends after an early-stop check, which the host reads
    between graphs; without ``fused`` (``fused_call: false``) also after
    each phase, one graph per phase as the JAX package's per-phase
    dispatches (the prologue joins the first phase's graph, the
    :class:`_End` step the last one's)."""
    j = i
    while j < len(steps):
        step = steps[j]
        j += 1
        if isinstance(step, _Chunk) and (step.check or (
                not fused and step.ends_phase
                and not isinstance(steps[j], _End))):
            break
    return j


def _frozen(x):
    """A hashable snapshot of a config (its part of a graph's key): dicts
    and lists as tuples, tensors and arrays by identity."""
    if isinstance(x, dict):
        return tuple(sorted(((k, _frozen(v)) for k, v in x.items()),
                            key=lambda kv: str(kv[0])))
    if isinstance(x, (list, tuple)):
        return tuple(_frozen(v) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return ("object", id(x))
    return x


def _identity_quaternions(n: int, device) -> torch.Tensor:
    """``n`` identity quaternions ``(n, 4)``, made on the device (no copy
    from the host)."""
    q = torch.zeros(n, 4, device=device)
    q[:, 3] = 1.0
    return q


def _unit(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``(..., 4)``, each divided by its own norm."""
    return q / torch.sqrt(torch.sum(q ** 2, dim=-1, keepdim=True))


def _per_row(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-hypothesis ``(B,)`` mask shaped to select rows of ``x (B,
    ...)``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def _hypothesis_states(states: Dict, device) -> Dict[str, torch.Tensor]:
    """``refine_batch``'s states (``position (N, 1, 3)``, ``orientation (N,
    1, 4)``, ``scale (N, 1)``, ``latent (N, 1, L)``) as the hypothesis rows
    ``(N, 3)``, ``(N, 4)``, ``(N,)``, ``(N, L)`` of
    :meth:`SDFPipeline._refine_hypotheses`."""
    out = {k: torch.as_tensor(states[k], dtype=torch.float32, device=device)
           for k in _STATE_KEYS}
    n = out["position"].shape[0]
    return {k: x.reshape(n) if k == "scale" else x.reshape(n, -1)
            for k, x in out.items()}


def _batch_result(states, best, logs):
    """``refine_batch``'s ``(states, best, log)`` in the JAX package's
    shapes from hypothesis rows and the phases' iteration-major logs: a
    state ``(N, ...)`` becomes ``(N, 1, ...)``, the logs are concatenated
    over the phases and each entry goes hypothesis-major, ``(N, T)`` or
    ``(N, T, 1, ...)``."""
    n = states["position"].shape[0]
    log = {k: torch.cat([lg[k] for lg in logs]) for k in logs[-1]}
    log = {k: (v.expand(n, -1) if k == "active" else
               v.transpose(0, 1) if k in _LOSS_KEYS else
               v.transpose(0, 1).unsqueeze(2)) for k, v in log.items()}
    return ({k: states[k].unsqueeze(1) for k in _STATE_KEYS},
            dict({k: best[k].unsqueeze(1) for k in _STATE_KEYS},
                 inlier_ratio=best["inlier_ratio"]), log)


class NoDepthError(ValueError):
    """Raised when no valid depth data remains after preprocessing."""


def _adjust_categorical_posterior(
    posterior: torch.Tensor,
    prior: Optional[torch.Tensor],
    train_prior: Optional[torch.Tensor],
) -> torch.Tensor:
    """Re-weight a categorical posterior computed under a different prior
    (``pipeline.py:43-54``)."""
    if prior is None:
        return posterior
    adjusted = posterior * prior
    if train_prior is not None:
        adjusted = adjusted / train_prior
    return adjusted / torch.sum(adjusted, dim=-1, keepdim=True)


def _roi_offset_for(depth: torch.Tensor, roi: Tuple[int, int]
                    ) -> torch.Tensor:
    """Top-left ``[row, col]`` (int32, on the depth's device) of an ``(Hr,
    Wr)`` ROI centered on the observed pixels, clamped into the frame
    (``sdfest_tpu/pipeline/pipeline.py:57-73``).  An empty view gives
    ``(0, 0)``."""
    h, w = depth.shape
    seen = depth > 0
    rows = torch.any(seen, dim=1).to(torch.int32)
    cols = torch.any(seen, dim=0).to(torch.int32)
    rmin = torch.argmax(rows)
    rmax = h - 1 - torch.argmax(torch.flip(rows, (0,)))
    cmin = torch.argmax(cols)
    cmax = w - 1 - torch.argmax(torch.flip(cols, (0,)))
    oy = torch.clamp((rmin + rmax + 1 - roi[0]) // 2, 0, h - roi[0])
    ox = torch.clamp((cmin + cmax + 1 - roi[1]) // 2, 0, w - roi[1])
    return torch.stack([oy, ox]).to(torch.int32)


def _probe(depth: torch.Tensor) -> torch.Tensor:
    """``[valid, span_rows, span_cols]`` (int64, on the device) of each
    preprocessed view ``(..., H, W)``: whether any pixel is observed and the
    bbox spans of the observed pixels (``_probe``, ``pipeline.py:952-976``);
    shape ``(..., 3)``."""
    seen = depth > 0
    rows, cols = torch.any(seen, dim=-1), torch.any(seen, dim=-2)

    def span(b):
        n = b.shape[-1]
        idx = torch.arange(n, device=b.device)
        mx = torch.amax(torch.where(b, idx, -1), dim=-1)
        mn = torch.amin(torch.where(b, idx, n), dim=-1)
        return torch.clamp(mx - mn + 1, min=0)

    return torch.stack([torch.any(rows, dim=-1).long(), span(rows),
                        span(cols)], dim=-1)


def _normalize_multires(multires) -> List[Tuple[int, int]]:
    """Multires schedule as a (possibly empty) list of ``(factor, iters)``
    (``pipeline.py:76-90``)."""
    if multires is None:
        return []
    if isinstance(multires, tuple) and len(multires) == 2 and not isinstance(
        multires[0], (tuple, list)
    ):
        return [multires]
    return list(multires)


def _check_slice(config: dict) -> None:
    """Reject the options the JAX package rejects when it builds or
    refines (``init_view`` is checked per call, as there).

    ``fused_call`` chooses the graphs of a ``__call__`` on the card: one
    for the whole estimate (true, the default) or one per phase (false).
    Both plan as the JAX package's fused path does, so they run the same
    trajectory.
    """
    if config.get("nn_weight", 0.0) != 0.0:
        raise ValueError(
            "nn_weight != 0 is unsupported: the reference's nn loss is "
            "disabled dead code; the key exists for config compatibility."
        )
    strategy = config.get("result_selection_strategy", "last_iteration")
    if strategy not in ("last_iteration", "best_inlier_ratio"):
        raise ValueError(
            f"Result selection strategy {strategy} is not supported."
        )


class SDFPipeline:
    """SDF pose, scale and shape estimation from a depth image."""

    def __init__(self, config: dict, device="cuda") -> None:
        """Build the networks from a config dict (the schema of
        ``configs/estimation/default.yaml`` + ``models/*.yaml``, e.g.
        :data:`sdfest_torch.utils.presets.MUG_PROCEDURAL`) and load the
        weights their ``model`` keys name (flax msgpack or the reference's
        ``.pt`` checkpoints, :mod:`sdfest_torch.utils.weights`); missing
        ``model`` keys leave PyTorch's random initialization.  Runs on
        ``device`` ("cuda" unless asked otherwise).
        """
        _check_slice(config)
        self.device = resolve_device(device)
        self.config = config
        self.init_config = config["init"]
        self.vae_config = config.get("vae", self.init_config.get("vae"))
        self.camera = Camera(**config["camera"])
        self.result_selection_strategy = config.get(
            "result_selection_strategy", "last_iteration"
        )
        self._relative_inlier_threshold = config.get(
            "relative_inlier_threshold", 0.03
        )
        self._far_field = config.get("far_field", None)
        self._num_input_points = config.get("num_input_points", 2500)
        self.resolution = self.vae_config.get("sdf_size", 64)

        self.decoder = create_decoder_from_config(self.vae_config)
        load_decoder_weights(self.decoder, self.vae_config)
        self.init_network = create_pose_net(
            self.init_config, shape_dimension=self.vae_config["latent_size"]
        )
        load_init_weights(self.init_network, self.init_config)
        for net in (self.decoder, self.init_network):
            net.to(self.device).eval().requires_grad_(False)

        self.orientation_repr = self.init_config["head"]["orientation_repr"]
        self._grid_quats = None
        if self.orientation_repr == "discretized":
            grid = SO3Grid(self.init_config["head"]["orientation_grid_resolution"])
            self._grid_quats = torch.as_tensor(
                grid.quaternions(), dtype=torch.float32, device=self.device
            )
        # per-iteration log of the last __call__ (tensors stacked over
        # iterations, all phases) and its plan, read after the call returns
        self.last_log: Optional[Dict[str, torch.Tensor]] = None
        self.last_plan: Optional[Tuple] = None
        # the plan of the last probed call, which reuse_plan: true reuses
        self._cached_plan: Optional[Tuple] = None
        # the captured graphs of this pipeline's calls and phases (the card
        # only; the counterpart of jax.jit's cache)
        self.graphs = graphs.GraphCache()

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    def _decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Latents ``(B, L)`` -> SDFs ``(B, 1, D, D, D)``, one batch."""
        return self.decoder(latent)

    def render(self, sdf, position, orientation, inv_scale) -> torch.Tensor:
        """Render a depth image ``(H, W)`` with the pipeline's camera and
        march options (differentiable; ``pipeline.py:147-170``): one launch
        of the march on the card."""
        return render_depth(
            sdf, position, orientation, inv_scale, camera=self.camera,
            threshold=self.config["threshold"],
            relaxation=self.config.get("relaxation", 1.0),
            culling=self.config.get("coarse_culling", True),
            bf16=self.config.get("bf16_march", False),
            adaptive=self.config.get("adaptive_relaxation", True),
            device=self.device,
        )

    def _preprocess_depth(self, depth: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
        """Mask the depth and cut the far field."""
        depth = torch.where(mask != 0, depth, torch.zeros_like(depth))
        if self._far_field is not None:
            depth = torch.where(depth > self._far_field,
                                torch.zeros_like(depth), depth)
        return depth

    def _nn_init(
        self,
        depth: torch.Tensor,
        camera_positions: torch.Tensor,
        camera_orientations: torch.Tensor,
        generator: Optional[torch.Generator],
        prior: Optional[torch.Tensor] = None,
        training_prior: Optional[torch.Tensor] = None,
        uniforms: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ...]:
        """Init network over views with the ``init_view`` strategy
        (``_nn_init_views``, ``pipeline.py:210-287``).

        ``depth`` is ``(V, H, W)`` (or one view ``(H, W)``), the cameras'
        world poses ``(V, 3)``/``(V, 4)`` (or ``(3,)``/``(4,)``), ``prior``
        a ``(V, C)`` prior over the SO(3) grid cells and ``training_prior``
        the ``(C,)`` prior the network was trained under.  Each view lifts
        and subsamples its own cloud (draws from ``generator`` view by view,
        in order, or the rows of ``uniforms``, :meth:`_init_uniforms`); the
        networks run as one batch.  "first" takes view 0, "best" the view
        whose adjusted posterior peaks highest.  Returns ``(latent (1, L),
        position (1, 3), scale (1,), orientation (1, 4))`` in the world
        frame.
        """
        self._validate_init_options(prior)
        depth = depth.reshape(-1, *depth.shape[-2:])
        camera_positions = camera_positions.reshape(-1, 3)
        camera_orientations = camera_orientations.reshape(-1, 4)
        best = self.config.get("init_view", "first") == "best"
        n_views = self._init_views(depth.shape[0])
        sampled, centroids = [], []
        for v in range(n_views):
            points, valid = pointset.depth_to_pointcloud_dense(depth[v],
                                                               self.camera)
            centroid = torch.zeros(3, dtype=points.dtype, device=points.device)
            if self.init_config.get("normalize_pose", True):
                points, centroid = pointset.normalize_points_masked(points,
                                                                    valid)
            u = (pointset._uniform(self._num_input_points, generator,
                                   points.device)
                 if uniforms is None else uniforms[v])
            sampled.append(pointset.subsample_with_uniforms(points, valid,
                                                            u)[0])
            centroids.append(centroid)
        with torch.no_grad():
            latent, position, scale, orientation = self.init_network(
                torch.stack(sampled))
        if self.config.get("mean_shape", False):
            latent = torch.zeros_like(latent)
        position = position + torch.stack(centroids)
        if self.orientation_repr == "discretized":
            posterior = _adjust_categorical_posterior(
                torch.softmax(orientation, dim=-1),
                None if prior is None else prior[:n_views], training_prior)
            orientation = self._grid_quats[torch.argmax(posterior, dim=-1)]
            maxima = torch.amax(posterior, dim=-1)
        position = quaternion.apply(camera_orientations[:n_views], position) + (
            camera_positions[:n_views])
        orientation = quaternion.multiply(camera_orientations[:n_views],
                                          orientation)
        # "best": the argmax stays on the device (no host read)
        idx = torch.argmax(maxima).reshape(1) if best else slice(0, 1)
        return latent[idx], position[idx], scale[idx], orientation[idx]

    def _validate_init_options(self, prior) -> None:
        """The init options the JAX package checks per call
        (``pipeline.py:317-342``)."""
        if prior is not None and self.orientation_repr != "discretized":
            raise ValueError(
                "prior_orientation_distribution only supported for "
                "discretized orientation representation."
            )
        if self.orientation_repr not in ("discretized", "quaternion"):
            raise NotImplementedError(
                f"Orientation representation {self.orientation_repr} "
                "unsupported.")
        init_view = self.config.get("init_view", "first")
        if init_view == "best":
            if self.orientation_repr != "discretized":
                raise NotImplementedError(
                    '"best" init strategy requires discretized orientations')
        elif init_view != "first":
            raise NotImplementedError(
                'Only "first" and "best" init strategies are supported')

    def _init_views(self, n_views: int) -> int:
        """How many of ``n_views`` views the init network reads: all under
        "best", view 0 under "first"."""
        return n_views if self.config.get("init_view", "first") == "best" \
            else 1

    def _init_uniforms(self, n_views: int,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The init's subsampling uniforms ``(V', P)``, drawn from
        ``generator`` view by view as :meth:`_nn_init` draws them, outside
        any captured graph (a graph would replay the draws of its
        capture)."""
        return torch.stack([
            pointset._uniform(self._num_input_points, generator, self.device)
            for _ in range(self._init_views(n_views))])

    def _make_adam(self):
        """Adam (b1 0.9, b2 0.999, eps 1e-8) with per-variable learning
        rates, written out as optax's ``scale_by_adam`` + ``scale(-lr)``.

        ``step(params, grads, moments, count)`` returns the new params and
        moments; ``count`` is the step's int32 count (1 on the first step)
        on the device, and the bias corrections ``1 - b ** count`` are
        computed there, so a captured graph replays the right ones at every
        step.  They are computed in float64 and rounded to float32 once, as
        optax's ``bias_correction`` rounds its ``1 - decay ** count`` to the
        moments' dtype: in float32 ``1 - 0.999`` would lose ~1e-5 of itself
        to cancellation."""
        lrs = {
            "position": self.config.get("position_lr", 1e-3),
            "orientation": self.config.get("orientation_lr", 1e-2),
            "scale": self.config.get("scale_lr", 1e-3),
            "latent": self.config.get("latent_lr", 1e-2),
        }
        b1, b2, eps = 0.9, 0.999, 1e-8

        def step(params, grads, moments, count):
            c = count.to(torch.float64)
            c1 = (1 - torch.pow(b1, c)).to(torch.float32)
            c2 = (1 - torch.pow(b2, c)).to(torch.float32)
            out, new_moments = {}, {}
            for k in _STATE_KEYS:
                g = grads[k]
                mu = (1 - b1) * g + b1 * moments[k][0]
                nu = (1 - b2) * (g ** 2) + b2 * moments[k][1]
                new_moments[k] = (mu, nu)
                update = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + eps)
                out[k] = params[k] + (-lrs[k]) * update
            return out, new_moments

        return step

    def _use_temporal_coherence(self) -> bool:
        """Whether refinement renders take the warm march
        (``pipeline.py:1081-1095``): ``temporal_coherence`` on the kernel
        backend (``renderer_backend`` "auto" or "pallas", whose
        counterpart the port's kernels are; "xla" turns it off), with the
        culling march at relaxation 1.  The JAX package's 64^3-grid and
        16-aligned-camera conditions are the TPU kernel's limits; the
        port's warm march has neither."""
        return bool(
            self.config.get("temporal_coherence", False)
            and self.config.get("renderer_backend", "auto") in ("auto",
                                                                "pallas")
            and self.config.get("relaxation", 1.0) <= 1.0
            and self.config.get("coarse_culling", True)
        )

    # ------------------------------------------------------------------
    # the plan: ROI sizes and multires levels
    # ------------------------------------------------------------------

    def _roi_from_spans(self, spans, factor: int = 1
                        ) -> Optional[Tuple[int, int]]:
        """ROI ``(Hr, Wr)`` for views with bbox spans ``(sy, sx)`` at stride
        ``factor``, or None for full frame (``pipeline.py:772-811``).

        ``roi_size: auto`` tries a quarter- and then a half-frame crop,
        ``[Hr, Wr]`` one crop scaled by the stride; the wander margin
        ``roi_margin`` scales by the stride too, and every size is rounded
        up to a multiple of 16.  The port's march takes any ray set, so the
        alignment is kept only to give the plan of the JAX package.  None
        under temporal coherence.
        """
        roi_cfg = self.config.get("roi_size")
        if not roi_cfg or self._use_temporal_coherence():
            return None
        h = self.camera.height // factor
        w = self.camera.width // factor
        margin = -(-int(self.config.get("roi_margin", 48)) // factor)
        align = lambda x: max(16, -(-int(x) // 16) * 16)
        if roi_cfg == "auto":
            candidates = [(align(h / 4), align(w / 4)),
                          (align(h / 2), align(w / 2))]
        else:
            candidates = [(align(roi_cfg[0] / factor),
                           align(roi_cfg[1] / factor))]
        for rh, rw in candidates:
            if rh > h or rw > w:
                continue
            if all(sy + 2 * margin <= rh and sx + 2 * margin <= rw
                   for sy, sx in spans):
                return (rh, rw)
        return None

    def _multires_for(self):
        """The coarse-to-fine schedule (``pipeline.py:829-920``): None, the
        tuple ``(factor, iters)`` of a single-level ``multires_factor: f``,
        or a list of ``(factor, iters)`` for a schedule such as ``[4, 2]``
        (coarsest first).

        ``multires_iterations: auto`` gives 60% of ``max_iterations`` to a
        single level, or 80% split evenly over a schedule's levels.  A level
        whose stride does not divide the raster drops out, as does a camera
        with skew.  The port plans as the JAX package's XLA backend does:
        on the TPU the pallas backend would also drop a level whose strided
        raster is not 16-aligned when no ROI is configured (and, per call,
        one whose object fits no aligned ROI), because its march needs
        aligned tiles; the port's march takes any ray set.  None under
        temporal coherence.
        """
        f_cfg = self.config.get("multires_factor", 1) or 1
        n_cfg = self.config.get("multires_iterations", 0)
        is_schedule = isinstance(f_cfg, (list, tuple))
        factors = [int(f) for f in (f_cfg if is_schedule else [f_cfg])]
        if self._use_temporal_coherence() or self.camera.s != 0.0:
            return None
        max_iterations = int(self.config["max_iterations"])
        if n_cfg == "auto":
            if is_schedule:
                n_levels = max(len(factors), 1)
                iters = [(max_iterations * 4) // (5 * n_levels)] * n_levels
            else:
                iters = [(max_iterations * 3) // 5]
        elif isinstance(n_cfg, (list, tuple)):
            if not is_schedule or len(n_cfg) != len(factors):
                raise ValueError(
                    "multires_iterations list must match multires_factor "
                    f"({n_cfg} vs {f_cfg})"
                )
            iters = [int(n) for n in n_cfg]
        else:
            if is_schedule:
                raise ValueError(
                    "multires_factor is a schedule; multires_iterations "
                    "must be a matching list or 'auto'"
                )
            iters = [int(n_cfg or 0)]
        if is_schedule and sum(iters) > max_iterations - 1:
            raise ValueError(
                "multires schedule must leave at least one full-resolution "
                f"iteration (sum {sum(iters)} >= {max_iterations})"
            )
        h, w = self.camera.height, self.camera.width
        levels = [(f, n) for f, n in zip(factors, iters)
                  if f > 1 and n > 0 and not (h % f or w % f)]
        if not levels:
            return None
        if not is_schedule:
            factor, n = levels[0]
            n = min(n, max_iterations - 1)
            return (factor, n) if n > 0 else None
        return levels

    def _plan_for(self, spans) -> Tuple:
        """``(levels, fine_roi, fine_iters)`` from the probe's bbox spans of
        the views with observed pixels (``pipeline.py:978-1007``):
        ``levels`` holds ``(factor, iters, roi_or_None)`` per coarse level,
        whose span is the analytic strided bound ``(s - 1) // f + 1``;
        ``fine_iters`` is None (the config's ``max_iterations``) without
        coarse levels."""
        levels = []
        executed = 0
        for factor, n_iters in _normalize_multires(self._multires_for()):
            spans_c = [((sy - 1) // factor + 1, (sx - 1) // factor + 1)
                       for sy, sx in spans]
            levels.append((factor, n_iters,
                           self._roi_from_spans(spans_c, factor)))
            executed += n_iters
        fine_roi = self._roi_from_spans(spans, 1)
        fine_iters = (int(self.config["max_iterations"]) - executed
                      if executed else None)
        return tuple(levels), fine_roi, fine_iters

    def _lift(self, depth: torch.Tensor, factor: int):
        """Tile-order cloud of a (strided) full-raster depth image ``(H,
        W)``, or the stacked clouds of views ``(V, H, W)``."""
        camera = self.camera if factor == 1 else self.camera.strided(factor)
        if depth.ndim == 2:
            return pointset.depth_to_pointcloud_dense(depth, camera,
                                                      order="tile")
        clouds = [self._lift(d, factor) for d in depth]
        return (torch.stack([c[0] for c in clouds]),
                torch.stack([c[1] for c in clouds]))

    # ------------------------------------------------------------------
    # refinement
    # ------------------------------------------------------------------

    def _refine(
        self,
        state: Dict[str, torch.Tensor],
        depth_image: torch.Tensor,
        points: Optional[torch.Tensor],
        point_mask: Optional[torch.Tensor],
        camera_position: Optional[torch.Tensor] = None,
        camera_orientation: Optional[torch.Tensor] = None,
        shape_optimization: bool = True,
        num_iterations: Optional[int] = None,
        roi: Optional[Tuple[int, int]] = None,
        ds_factor: int = 1,
        point_constraint: Optional[Tuple] = None,
        allow_early_stop: bool = True,
        opt_state: Optional[dict] = None,
        best: Optional[Dict[str, torch.Tensor]] = None,
        return_full: bool = False,
    ):
        """One refinement phase of one hypothesis over one or more views.

        ``state`` holds ``position (1, 3)``, ``orientation (1, 4)``, ``scale
        (1,)`` and ``latent (1, L)`` in the world frame.  ``depth_image`` is
        ``(V, H, W)`` (or one view ``(H, W)``), ``points``/``point_mask``
        the views' lifted clouds ``(V, H*W, 3)``/``(V, H*W)`` (or ``(H*W,
        3)``/``(H*W,)``) and the cameras' world poses ``(V, 3)``/``(V, 4)``
        (or ``(3,)``/``(4,)``; identity when None).  Each view renders in its
        own camera frame and the losses are summed over the views
        (``pipeline.py:476-593``).  With ``ds_factor=f > 1`` the phase runs
        against the strided sub-observation: ``depth_image`` and the clouds
        are the ``[::f, ::f]`` slices lifted with ``camera.strided(f)``.
        With ``roi=(Hr, Wr)`` each render is the crop around the view's
        observed pixels (one size for all views, an offset per view, from
        this phase's depth) and the clouds are re-lifted from the crops, so
        ``points``/``point_mask`` are ignored and may be None
        (``pipeline.py:445-474``).  ``point_constraint=(source, target,
        weight)`` adds ``weight * point_constraint_loss`` of the raw
        orientation parameter.  Under temporal coherence (full frame only)
        each view renders through the warm march with its own warm state,
        the motion bound shared, and the pc loss is sampled apart from it.
        With ``early_stop_delta > 0`` and ``allow_early_stop`` the phase
        stops once an interval of ``early_stop_interval`` iterations
        improves the loss by less than that share (one host read per
        check); the remaining log rows repeat the last one with ``active``
        0, and state and best stay as they were.

        Adam starts afresh (zero moments, step 1) unless ``opt_state``, the
        optimizer state a ``return_full`` call returned, carries on from
        it (its step count included, an int32 tensor on the device);
        ``best`` likewise carries the best
        tracker on, so a phase run in chunks equals the phase run at once
        (``pipeline.py:372-377``).  Returns ``(state, best, log)``, or with
        ``return_full`` ``(state, opt_state, best, log)``: the final state,
        the state with the best inlier ratio of the last view's pre-step
        render, and the per-iteration log (each entry stacked over
        iterations, ``active`` 1 on the iterations that ran).
        """
        if len(state["position"]) != 1:
            raise ValueError("_refine refines one hypothesis; refine_batch "
                             "takes a batch")
        if best is not None:
            best = dict(best, inlier_ratio=torch.as_tensor(
                best["inlier_ratio"], dtype=torch.float32,
                device=self.device).reshape(1))
        state, opt_state, best, log = self._refine_hypotheses(
            state, depth_image, points, point_mask, camera_position,
            camera_orientation, shape_optimization, num_iterations, roi,
            ds_factor, point_constraint, allow_early_stop, opt_state, best)
        best = dict(best, inlier_ratio=best["inlier_ratio"][0])
        log = {k: v[:, 0] if k in _LOSS_KEYS else v for k, v in log.items()}
        if return_full:
            return state, opt_state, best, log
        return state, best, log

    def _refine_hypotheses(
        self,
        state: Dict[str, torch.Tensor],
        depth_image: torch.Tensor,
        points: Optional[torch.Tensor],
        point_mask: Optional[torch.Tensor],
        camera_position: Optional[torch.Tensor],
        camera_orientation: Optional[torch.Tensor],
        shape_optimization: bool,
        num_iterations: Optional[int],
        roi: Optional[Tuple[int, int]],
        ds_factor: int,
        point_constraint: Optional[Tuple],
        allow_early_stop: bool,
        opt_state: Optional[dict],
        best: Optional[Dict[str, torch.Tensor]],
    ):
        """:meth:`_refine` of ``B`` hypotheses at once: ``state`` holds
        ``position (B, 3)``, ``orientation (B, 4)``, ``scale (B,)`` and
        ``latent (B, L)``; the views are shared.

        Each iteration decodes the ``B`` latents as one batch and renders
        each view once for all hypotheses (one launch of each kernel per
        view, :func:`render_depth_with_pc_values` or the warm march); the
        losses are ``(B,)``, the step differentiates their sum (the
        hypotheses share no parameter, so each gets its own gradient), and
        every quaternion, the best tracker and the warm state are per
        hypothesis.  Early stop takes one hypothesis only.  Returns
        ``(state, opt_state, best, log)`` with ``best["inlier_ratio"]
        (B,)`` and the log's entries stacked iteration-major: ``(T, B)``
        for the losses and ratio, ``(T, B, ...)`` for the state, ``(T,)``
        for ``active``.  ``opt_state["count"]`` is Adam's int32 step count,
        a tensor on the device.

        On the card the phase runs as one captured graph (with early stop,
        one per chunk of ``early_stop_interval`` iterations, the check's
        host read between them), :meth:`_drive`.
        """
        dev = self.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        state = {k: f32(state[k]).detach().clone() for k in _STATE_KEYS}
        n_hyps = state["position"].shape[0]
        depth_image = f32(depth_image)
        depth_image = depth_image.reshape(-1, *depth_image.shape[-2:])
        n_views = depth_image.shape[0]
        phase = self._phase(num_iterations, roi, ds_factor, shape_optimization,
                            point_constraint, allow_early_stop, n_hyps)
        views = {
            "depth": depth_image,
            "cam_pos": (torch.zeros(n_views, 3, device=dev)
                        if camera_position is None
                        else f32(camera_position).reshape(n_views, 3)),
            "cam_q": (_identity_quaternions(n_views, dev)
                      if camera_orientation is None
                      else f32(camera_orientation).reshape(n_views, 4)),
        }
        if phase.roi is None:
            views["points"] = f32(points).reshape(n_views, -1, 3)
            views["point_mask"] = torch.as_tensor(
                point_mask, device=dev).reshape(n_views, -1)
        if point_constraint is not None:
            views["source"] = f32(point_constraint[0])
            views["target"] = f32(point_constraint[1])
        carry = {"views": views, "state": state}
        if opt_state is not None:
            carry["opt_in"] = {
                "count": torch.as_tensor(opt_state["count"],
                                         dtype=torch.int32, device=dev),
                "moments": {k: tuple(opt_state["moments"][k])
                            for k in _STATE_KEYS}}
        if best is not None:
            carry["best_in"] = {k: f32(best[k])
                                for k in ("inlier_ratio", *_STATE_KEYS)}
        out = self._drive("refine", self._phase_steps(0, phase) + [_End()],
                          carry, fused=True)
        return out["state"], out["opt"], out["best"], out["log"]

    def _phase(self, num_iterations, roi, ds_factor: int,
               shape_optimization: bool, point_constraint,
               allow_early_stop: bool, n_hyps: int) -> _Phase:
        """The static part of a refinement phase, its options checked as the
        JAX package checks them."""
        use_warm = self._use_temporal_coherence()
        refresh_k = int(self.config.get("temporal_refresh_interval", 8))
        if use_warm and refresh_k < 1:
            raise ValueError(
                f"temporal_refresh_interval must be >= 1, got {refresh_k}")
        if use_warm and roi is not None:
            raise ValueError("roi refinement and temporal_coherence are "
                             "mutually exclusive")
        if use_warm and ds_factor != 1:
            raise ValueError("multires refinement and temporal_coherence "
                             "are mutually exclusive")
        early_delta = (float(self.config.get("early_stop_delta", 0.0) or 0.0)
                       if allow_early_stop else 0.0)
        early_interval = int(self.config.get("early_stop_interval", 10))
        if early_delta > 0.0 and early_interval < 1:
            raise ValueError(
                f"early_stop_interval must be >= 1, got {early_interval}")
        if early_delta > 0.0 and n_hyps != 1:
            raise ValueError("early stop freezes one hypothesis; a batch "
                             "stops per chunk (refine_batch, adaptive=True)")
        n_iter = (num_iterations if num_iterations is not None
                  else self.config["max_iterations"])
        return _Phase(
            int(n_iter), None if roi is None else (int(roi[0]), int(roi[1])),
            int(ds_factor), bool(shape_optimization),
            None if point_constraint is None else float(point_constraint[2]),
            early_delta > 0.0)

    def _phase_steps(self, index: int, phase: _Phase) -> List[_Chunk]:
        """The chunks of phase number ``index``: the whole phase, or with
        early stop chunks of ``early_stop_interval`` iterations.  ``check``
        marks a chunk after which the phase may stop (not its last: a check
        there can skip nothing, so it reads nothing)."""
        interval = (int(self.config.get("early_stop_interval", 10))
                    if phase.early else max(phase.n_iter, 1))
        steps, start = [], 0
        while True:
            n = min(interval, phase.n_iter - start)
            steps.append(_Chunk(index, phase, start, n,
                                phase.early and start + n < phase.n_iter))
            start += n
            if start >= phase.n_iter:
                return steps

    # ------------------------------------------------------------------
    # the captured program: steps, segments and their graphs
    # ------------------------------------------------------------------

    def _drive(self, kind: str, steps: list, carry: dict,
               fused: bool) -> dict:
        """Run ``steps`` on ``carry`` as segments (:func:`_segment_end`),
        each one captured graph on the card (:meth:`_execute`), and return
        the last segment's outputs, on the card cloned out of the graph's
        static outputs (the caller's own).

        After a segment that ends on an early-stop check the host reads
        the check (the check's one host read); a stopped phase skips its
        remaining chunks, as the JAX package's ``lax.cond`` does: its log
        rows repeat the last one with ``active`` 0 and its state and best
        stay (:meth:`_stopped`, eager)."""
        i = 0
        while i < len(steps):
            j = _segment_end(steps, i, fused)
            segment = tuple(steps[i:j])
            carry = self._execute((kind, segment), functools.partial(
                self._segment, segment), carry)
            i = j
            last = segment[-1]
            if isinstance(last, _Chunk) and last.check and bool(
                    carry["phase"]["stop"]):  # the check's one host read
                carry = self._stopped(carry, last.start + last.n)
                while (i < len(steps) and isinstance(steps[i], _Chunk)
                       and steps[i].index == last.index):
                    i += 1
        return graphs.clone(carry) if self.graphs.active(self.device) \
            else carry

    def _execute(self, key, fn, carry: dict) -> dict:
        """``fn(carry)``: on the card one replay of its captured graph
        (captured on the first run of ``key`` with this config and these
        shapes), on the CPU or inside :func:`graphs.eager` the eager
        loop."""
        return self.graphs.call((key, _frozen(self.config)), fn, carry,
                                self.device)

    def _segment(self, segment: tuple, carry: dict) -> dict:
        """The captured body: the steps of ``segment`` in order.  It makes
        no host read and no copy from the host, so a stream can capture
        it."""
        for step in segment:
            if isinstance(step, _Prologue):
                carry = self._prologue(carry)
            elif isinstance(step, _Views):
                carry = self._call_views(carry, step.factor, step.roi)
            elif isinstance(step, _Chunk):
                carry = self._chunk(carry, step)
            else:
                carry = self._end(carry)
        return carry

    def _prologue(self, carry: dict) -> dict:
        """``__call__`` before its phases: preprocess the views and run the
        init network (``_fused_program``'s head, ``pipeline.py:1031-1044``),
        on the uniforms drawn before the graph."""
        c = carry["call"]
        dev = self.device
        depth = self._preprocess_depth(c["depth"], c["mask"])
        n_views = depth.shape[0]
        frame = {
            "cam_pos": c["cam_pos"] if "cam_pos" in c
            else torch.zeros(n_views, 3, device=dev),
            "cam_q": c["cam_q"] if "cam_q" in c
            else _identity_quaternions(n_views, dev)}
        if "source" in c:
            frame.update(source=c["source"], target=c["target"])
        latent, position, scale, orientation = self._nn_init(
            depth, frame["cam_pos"], frame["cam_q"], None, c.get("prior"),
            c.get("training_prior"), uniforms=c["uniforms"])
        return {"depth": depth, "frame": frame, "state": {
            "position": position, "orientation": orientation,
            "scale": scale, "latent": latent}}

    def _call_views(self, carry: dict, factor: int,
                    roi: Optional[Tuple[int, int]]) -> dict:
        """A ``__call__`` phase's view inputs from the preprocessed views:
        the exactly-strided sub-observation of a coarse level and, without
        an ROI, its tile-order clouds (an ROI phase re-lifts its crops)."""
        depth = carry["depth"]
        if factor > 1:
            depth = depth[:, ::factor, ::factor].contiguous()
        views = dict(carry["frame"], depth=depth)
        if roi is None:
            views["points"], views["point_mask"] = self._lift(depth, factor)
        return dict(carry, views=views)

    def _chunk(self, carry: dict, chunk: _Chunk) -> dict:
        """The iterations of ``chunk`` (with the phase's start when it
        starts at 0, its end when it ends the phase), then the early stop
        check when ``chunk.check``: the device computes whether the chunk
        improved the loss enough, the host reads it after the graph."""
        phase, start, n = chunk.phase, chunk.start, chunk.n
        carry = dict(carry)
        ctx = self._phase_context(phase, carry["views"])
        ph = (self._phase_start(phase, carry, ctx) if start == 0
              else dict(carry["phase"]))
        state = carry["state"]
        for it in range(start, start + n):
            state, ph = self._iteration(phase, ctx, ph, state, it)
        if chunk.check:
            # the absolute floor lets a zero-loss plateau count as
            # converged (pipeline.py:670-677)
            loss = ph["log"]["loss"][start + n - 1]
            ref = ph["ref_loss"]
            improved = (ref - loss) >= ctx["early_delta"] * torch.clamp(
                torch.abs(ref), min=1e-8)
            ph["stop"] = torch.logical_not(torch.all(improved))
            ph["ref_loss"] = loss
        carry["state"] = state
        if chunk.ends_phase:
            return self._finish_phase(carry, ph)
        carry["phase"] = ph
        return carry

    def _phase_context(self, phase: _Phase, views: dict) -> dict:
        """Per-view inputs of a phase's iterations, made on the device from
        its view inputs (the ROI crops, their offsets and re-lifted clouds,
        the rays), and its constants."""
        dev = self.device
        depth = views["depth"]
        camera = (self.camera if phase.ds_factor == 1
                  else self.camera.strided(phase.ds_factor))
        per_view = []
        if phase.roi is None:
            rays = ray_set(camera, dev)
            per_view = [(depth[v], views["points"][v], views["point_mask"][v],
                         rays) for v in range(depth.shape[0])]
        else:
            for d in depth:
                offset = _roi_offset_for(d, phase.roi)
                d = crop(d, phase.roi, offset)
                per_view.append((d, *pointset.depth_to_pointcloud_dense(
                    d, camera, order="tile", pixel_offset=offset),
                    ray_set(camera, dev, phase.roi, offset)))
        return {
            "camera": camera, "views": per_view, "cam_pos": views["cam_pos"],
            "q_w2c": quaternion.invert(views["cam_q"]),
            "source": views.get("source"), "target": views.get("target"),
            "adam": self._make_adam(),
            "early_delta": float(self.config.get("early_stop_delta", 0.0)
                                 or 0.0),
            "refresh_k": int(self.config.get("temporal_refresh_interval", 8)),
            "render": dict(
                camera=camera,
                threshold=self.config["threshold"],
                culling=bool(self.config.get("coarse_culling", True)),
                adaptive=bool(self.config.get("adaptive_relaxation", True)),
                relaxation=float(self.config.get("relaxation", 1.0)),
                bf16=bool(self.config.get("bf16_march", False)),
                device=dev),
        }

    def _phase_start(self, phase: _Phase, carry: dict, ctx: dict) -> dict:
        """A phase's own carry at its start: Adam afresh (zero moments,
        count 0) unless ``carry`` brings ``opt_in``, the best tracker afresh
        unless it brings ``best_in``, the log's ``(T, B, ...)`` buffers, the
        early-stop reference and, under temporal coherence, the views' zero
        warm state (forcing a full first march)."""
        dev = self.device
        state = carry["state"]
        n_hyps = state["position"].shape[0]
        n_views = len(ctx["views"])
        opt = carry.pop("opt_in", None)
        best = carry.pop("best_in", None)
        if opt is None:
            opt = {"count": torch.zeros((), dtype=torch.int32, device=dev),
                   "moments": {k: (torch.zeros_like(v), torch.zeros_like(v))
                               for k, v in state.items()}}
        if best is None:
            best = {"inlier_ratio": torch.full((n_hyps,), -1.0, device=dev),
                    **{k: state[k] for k in _STATE_KEYS}}
        log = {k: torch.empty((phase.n_iter, n_hyps), device=dev)
               for k in _LOSS_KEYS}
        log.update({k: torch.empty((phase.n_iter, *state[k].shape),
                                   device=dev) for k in _STATE_KEYS})
        log["active"] = torch.ones(phase.n_iter, device=dev)
        ph = {"count": opt["count"], "moments": opt["moments"], "best": best,
              "log": log}
        if phase.early:
            # the first check always improves
            ph["ref_loss"] = torch.full((n_hyps,), 1e30, device=dev)
            ph["stop"] = torch.zeros((), dtype=torch.bool, device=dev)
        if self._use_temporal_coherence():
            camera = ctx["camera"]
            warm0 = init_warm_views(n_views, camera.height, camera.width,
                                    n_hyps, dev)
            ph["warm"] = [{k: x[v] for k, x in warm0.items()}
                          for v in range(n_views)]
            ph["shared"] = {
                "position": state["position"],
                "orientation": _unit(state["orientation"]),
                "scale": state["scale"],
                "sdf": torch.zeros((n_hyps,) + (self.resolution,) * 3,
                                   device=dev),
            }
        return ph

    def _iteration(self, phase: _Phase, ctx: dict, ph: dict,
                   state: Dict[str, torch.Tensor], it: int):
        """Iteration ``it`` of a phase: decode, render and losses per view,
        the gradient, Adam's step, the best tracker and the log's row
        ``it``.  Returns ``(state, phase carry)``."""
        dev = self.device
        params = {k: state[k].detach().requires_grad_(True)
                  for k in _STATE_KEYS}
        norm_q = _unit(params["orientation"])
        latent = params["latent"]
        if not phase.shape_optimization:
            latent = latent.detach()
        # with shape optimization the gradient runs through the decoder:
        # its forward and backward under fp32_convolutions(deterministic=
        # True), as a trainer's step (cuDNN reads the flags when the
        # backward runs): the convolutions in full fp32 with deterministic
        # algorithms (the resizes' backward is a fixed-order adjoint always)
        with (fp32_convolutions(deterministic=True)
              if phase.shape_optimization else contextlib.nullcontext()):
            sdf = self._decode(latent)[:, 0]
            ph = dict(ph)
            use_warm = "warm" in ph
            if use_warm:
                motion = motion_bound(params["position"], norm_q,
                                      params["scale"], sdf, ph["shared"])
                warms = list(ph["warm"])
            view_losses = []
            for v, (depth_v, points_v, mask_v, rays_v) in enumerate(
                    ctx["views"]):
                position_c = quaternion.apply(
                    ctx["q_w2c"][v], params["position"] - ctx["cam_pos"][v])
                orientation_c = quaternion.multiply(ctx["q_w2c"][v], norm_q)
                if use_warm:
                    depth_estimate, warms[v] = warm_render_step(
                        sdf, position_c, orientation_c, params["scale"],
                        warms[v], motion, it % ctx["refresh_k"] == 0,
                        ctx["camera"], self.config["threshold"], device=dev,
                    )
                    loss_pc = losses.masked_pc_loss(
                        points_v, mask_v, position_c, orientation_c,
                        params["scale"], sdf,
                    )
                else:
                    depth_estimate, pc_values = render_depth_with_pc_values(
                        sdf, position_c, orientation_c, params["scale"],
                        points_v, mask_v, rays=rays_v, **ctx["render"],
                    )
                    loss_pc = losses.masked_mean_abs(pc_values, mask_v)
                view_losses.append((losses.depth_l1_loss(
                    depth_v, depth_estimate), loss_pc))
            # summed in view order, as the JAX package's scan over views
            loss_depth, loss_pc = view_losses[0]
            for ld, lp in view_losses[1:]:
                loss_depth, loss_pc = loss_depth + ld, loss_pc + lp
            loss = (self.config.get("depth_weight", 1.0) * loss_depth
                    + self.config.get("pc_weight", 1.0) * loss_pc)
            if phase.constraint_weight is not None:
                loss = loss + phase.constraint_weight * (
                    losses.point_constraint_loss(params["orientation"],
                                                 ctx["source"], ctx["target"]))
            if use_warm:
                ph["warm"] = warms
                ph["shared"] = {"position": params["position"].detach(),
                                "orientation": norm_q.detach(),
                                "scale": params["scale"].detach(),
                                "sdf": sdf.detach()}
            wanted = [k for k in _STATE_KEYS
                      if k != "latent" or phase.shape_optimization]
            got = torch.autograd.grad(loss.sum(), [params[k] for k in wanted])
        grads = {k: torch.zeros_like(state[k]) for k in _STATE_KEYS}
        grads.update(zip(wanted, got))
        with torch.no_grad():
            count = ph["count"] + 1
            state, ph["moments"] = ctx["adam"](state, grads, ph["moments"],
                                               count)
            ph["count"] = count
            state["orientation"] = _unit(state["orientation"])
            # the last view's observation and pre-step render
            ratio = losses.inlier_ratio(
                ctx["views"][-1][0], depth_estimate,
                self._relative_inlier_threshold,
            )
            best = ph["best"]
            is_better = ratio > best["inlier_ratio"]
            ph["best"] = {
                "inlier_ratio": torch.where(is_better, ratio,
                                            best["inlier_ratio"]),
                **{k: torch.where(_per_row(is_better, state[k]),
                                  state[k], best[k])
                   for k in _STATE_KEYS},
            }
            row = {"loss": loss, "loss_depth": loss_depth,
                   "loss_pc": loss_pc, "inlier_ratio": ratio, **state}
            for k, v in row.items():
                ph["log"][k][it].copy_(v)
        return state, ph

    def _finish_phase(self, carry: dict, ph: dict) -> dict:
        """Hand a finished phase on: its log joins ``logs``, its best
        tracker and Adam state become ``best`` and ``opt``."""
        carry = {k: v for k, v in carry.items()
                 if k not in ("phase", "views")}
        carry["logs"] = list(carry.get("logs", [])) + [ph["log"]]
        carry["best"] = ph["best"]
        carry["opt"] = {"count": ph["count"], "moments": ph["moments"]}
        return carry

    def _stopped(self, carry: dict, done: int) -> dict:
        """A phase that early stop ended after ``done`` iterations, eagerly
        between graphs: the log rows after them repeat the last one with
        ``active`` 0, and the phase ends with its state and best as they
        were."""
        ph = carry["phase"]
        with torch.no_grad():
            for k, v in ph["log"].items():
                if k == "active":
                    v[done:] = 0.0
                else:
                    v[done:] = v[done - 1]
        return self._finish_phase(carry, ph)

    def _end(self, carry: dict) -> dict:
        """The outputs: the final state, the last phase's best and Adam
        state, the phases' logs concatenated and (``__call__``) the
        preprocessed views."""
        logs = carry["logs"]
        out = {"state": carry["state"], "best": carry["best"],
               "opt": carry["opt"],
               "log": logs[0] if len(logs) == 1 else {
                   k: torch.cat([lg[k] for lg in logs]) for k in logs[-1]}}
        if "depth" in carry:
            out["depth"] = carry["depth"]
        return out

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def __call__(
        self,
        depth_images,
        masks,
        color_images=None,
        visualize: bool = False,
        camera_positions=None,
        camera_orientations=None,
        log_path: Optional[str] = None,
        animation_path: Optional[str] = None,
        animation_mode: str = "depth",
        shape_optimization: bool = True,
        point_constraint=None,
        prior_orientation_distribution=None,
        training_orientation_distribution=None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Infer pose, scale and latent shape from depth views
        (``pipeline.py:1136-1236``).

        The parameters are the reference's, in its order and under its
        names, except ``generator`` in place of ``key``.

        Args:
            depth_images: Depth along the camera z-axis, ``(V, H, W)`` or
                one view ``(H, W)``; masked and far-field-cut internally.
            masks: Binary object masks of the same shape.
            color_images: Unused, as in the reference (visualization only).
            visualize: Save a figure of the optimization (input and
                estimated depth, their error, the loss and inlier-ratio
                trajectories) to the config's ``visualization_path``, or
                ``visualization_<time>.png``; needs matplotlib.
            log_path: Pickle the flight recorder's log here: ``{"config",
                "log"}``, the log holding each iteration's losses, inlier
                ratio, state and ``active`` flag, ``timestamp`` (seconds of
                the call), ``depth_input`` (the preprocessed views) and,
                when coarse levels ran, ``multires_boundary`` /
                ``multires_boundaries`` (the iterations at each level's
                end); numpy only.
            animation_path / animation_mode: Export an animation of the
                optimization (``play_log.export_animation``, mode "depth",
                "error" or "mesh"); needs matplotlib, and ffmpeg for an
                mp4 (else the frames go to an ``.npz``).
            camera_positions / camera_orientations: The cameras' world poses
                ``(V, 3)``/``(V, 4)`` (``(3,)``/``(4,)`` with one view);
                identity when None.
            shape_optimization: Optimize the latent during refinement.
            point_constraint: Optional ``(source, target, weight)``: adds
                ``weight * |R(q) source - target|`` of the orientation
                parameter ``q`` to every iteration's loss.
            prior_orientation_distribution: Optional ``(V, C)`` prior over
                the SO(3) grid cells (``(C,)`` with one view); discretized
                heads only.
            training_orientation_distribution: The ``(C,)`` prior the init
                network was trained under.
            generator: ``torch.Generator`` on the pipeline's device for the
                init's point subsampling; a fresh one seeded 0 when None.
        Returns:
            ``(position (1, 3), orientation (1, 4), scale (1,), latent
            (1, L))`` in the world frame, the caller's own tensors (as is
            :attr:`last_log`: the next call does not overwrite them).

        The probe (one host read) raises :class:`NoDepthError` when view 0
        ("first") or any view ("best") has no valid depth, and gives the
        plan.  With ``reuse_plan: true`` a call after the first reuses the
        previous call's plan and runs no probe, so it cannot raise
        :class:`NoDepthError` up front (``pipeline.py:1208-1216``).

        On the card the rest runs as captured graphs, captured on the first
        call of a plan and shapes and replayed after that: with
        ``fused_call: true`` (the default) ONE graph for preprocessing, the
        init network and every phase (``_fused_program``), with ``false``
        one per phase (the JAX package's per-phase dispatches; the first
        one takes preprocessing and the init too).  With early stop a graph ends at
        each check, which the host reads between graphs.  The init's
        uniforms are drawn from ``generator`` before the graph.  A call
        with ``reuse_plan`` and a cached plan makes no host sync.
        """
        start_time = time.time()
        dev = self.device
        depth = torch.as_tensor(depth_images, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(masks, device=dev)
        prior = prior_orientation_distribution
        if depth.ndim == 2:
            depth, mask = depth[None], mask[None]
            if prior is not None:
                prior = torch.as_tensor(prior)[None]
        n_views = depth.shape[0]
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        call = {"depth": depth, "mask": mask}
        if camera_positions is not None:
            call["cam_pos"] = f32(camera_positions).reshape(n_views, 3)
        if camera_orientations is not None:
            call["cam_q"] = f32(camera_orientations).reshape(n_views, 4)
        prior = None if prior is None else f32(prior)
        self._validate_init_options(prior)
        if prior is not None:
            call["prior"] = prior
        if training_orientation_distribution is not None:
            call["training_prior"] = f32(training_orientation_distribution)
        if point_constraint is not None:
            call["source"] = f32(point_constraint[0])
            call["target"] = f32(point_constraint[1])
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        plan = self._cached_plan if bool(
            self.config.get("reuse_plan", False)) else None
        if plan is None:
            # the one sync
            probe = _probe(self._preprocess_depth(depth, mask)).tolist()
            first = self.config.get("init_view", "first") == "first"
            if not (probe[0][0] if first else all(p[0] for p in probe)):
                raise NoDepthError
            plan = self._cached_plan = self._plan_for(
                [(sy, sx) for valid, sy, sx in probe if valid])
        levels, fine_roi, fine_iters = self.last_plan = plan
        call["uniforms"] = self._init_uniforms(n_views, generator)
        # coarse levels hand over their final state; their best is dropped
        # (coarse inlier ratios do not compare with full-raster ones)
        steps = [_Prologue()]
        for index, (factor, n_iters, roi) in enumerate(
                list(levels) + [(1, fine_iters, fine_roi)]):
            phase = self._phase(n_iters, roi, factor, shape_optimization,
                                point_constraint, True, 1)
            steps += [_Views(factor, roi)] + self._phase_steps(index, phase)
        steps.append(_End())
        out = self._drive("call", steps, {"call": call},
                          fused=bool(self.config.get("fused_call", True)))
        state, depth = out["state"], out["depth"]
        best = dict(out["best"], inlier_ratio=out["best"]["inlier_ratio"][0])
        self.last_log = {k: v[:, 0] if k in _LOSS_KEYS else v
                         for k, v in out["log"].items()}
        if log_path is not None or animation_path is not None:
            data = self._flight_record(depth, levels, start_time)
            if log_path is not None:
                with open(log_path, "wb") as f:
                    pickle.dump(data, f)
            if animation_path is not None:
                from sdfest_torch.scripts.play_log import export_animation

                export_animation(data, animation_path, mode=animation_mode,
                                 pipeline=self)
        chosen = state if self.result_selection_strategy == "last_iteration" \
            else best
        if visualize:
            # the estimate the caller receives (under best_inlier_ratio that
            # may differ from the final state)
            self._visualize_optimization(chosen, depth, self.last_log)
        return (chosen["position"], chosen["orientation"], chosen["scale"],
                chosen["latent"])

    def _flight_record(self, depth: torch.Tensor, levels,
                       start_time: float) -> dict:
        """The flight recorder's ``{"config", "log"}`` of the last call
        (``pipeline.py:1355-1370``), numpy only: the tensors of
        :attr:`last_log` move to the host once, after the loop."""
        log = {k: v.cpu().numpy() for k, v in self.last_log.items()}
        log["timestamp"] = time.time() - start_time
        # the preprocessed inputs travel with the log, so playback can draw
        # error images without the data set
        log["depth_input"] = depth.cpu().numpy()
        boundaries = np.cumsum([n for _, n, _ in levels]).tolist()
        if boundaries:
            # iterations before this index ran on strided coarse
            # observations (their losses reduce over fewer pixels)
            log["multires_boundary"] = boundaries[-1]
            log["multires_boundaries"] = boundaries
        return {"config": _plain_config(self.config), "log": log}

    def _visualize_optimization(self, state: Dict[str, torch.Tensor],
                                depth_images: torch.Tensor, log) -> None:
        """Save a figure of the optimization (``pipeline.py:1400-1446``):
        input depth, the estimate's depth, their error on the overlap, and
        the loss and inlier-ratio trajectories.  Written to the config's
        ``visualization_path``, or ``visualization_<time>.png`` in the
        working directory; needs matplotlib."""
        from sdfest_torch.ops.sdf_vis import agg_pyplot

        plt = agg_pyplot()
        with torch.no_grad():
            est = self.generate_depth(
                state["position"][0], state["orientation"][0],
                state["scale"][0], state["latent"]).cpu().numpy()
        inp = depth_images[-1].cpu().numpy()
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        im0 = axes[0, 0].imshow(inp)
        axes[0, 0].set_title("input depth")
        fig.colorbar(im0, ax=axes[0, 0])
        im1 = axes[0, 1].imshow(est)
        axes[0, 1].set_title("estimated depth")
        fig.colorbar(im1, ax=axes[0, 1])
        both = (inp > 0) & (est > 0)
        im2 = axes[1, 0].imshow(np.where(both, np.abs(inp - est), np.nan))
        axes[1, 0].set_title("abs depth error (overlap)")
        fig.colorbar(im2, ax=axes[1, 0])
        axes[1, 1].plot(log["loss"].cpu().numpy(), label="loss")
        axes[1, 1].plot(log["inlier_ratio"].cpu().numpy(),
                        label="inlier ratio")
        axes[1, 1].set_xlabel("iteration")
        axes[1, 1].legend()
        axes[1, 1].set_yscale("log")
        fig.tight_layout()
        path = self.config.get(
            "visualization_path", f"visualization_{int(time.time())}.png")
        fig.savefig(path)
        plt.close(fig)

    # ------------------------------------------------------------------
    # hypothesis batches
    # ------------------------------------------------------------------

    def refine_batch(
        self,
        states: Dict[str, torch.Tensor],
        depth_images: torch.Tensor,
        points: torch.Tensor,
        point_masks: torch.Tensor,
        camera_positions: torch.Tensor,
        camera_orientations: torch.Tensor,
        shape_optimization: bool = True,
        roi: Optional[Tuple[int, int]] = None,
        multires=None,
        adaptive: bool = False,
    ):
        """Refine a batch of hypotheses together (``pipeline.py:1448-1528``).

        ``states`` hold ``position (N, 1, 3)``, ``orientation (N, 1, 4)``,
        ``scale (N, 1)`` and ``latent (N, 1, L)``; the views are shared:
        ``depth_images (V, H, W)``, ``points (V, H*W, 3)``, ``point_masks
        (V, H*W)``, ``camera_positions (V, 3)``, ``camera_orientations (V,
        4)``.  Every iteration renders each view ONCE for all ``N``
        hypotheses (one launch of each kernel per view and iteration,
        whatever ``N``: the kernels take the hypothesis as a launch
        dimension), where the JAX package maps ``_refine`` over them.  Each
        hypothesis follows the trajectory of its own :meth:`_refine`.

        ``roi`` as in :meth:`_refine` (``self._roi_for(depth_images)``
        applies the config policy).  ``multires=(factor, iters)``, or a
        list of such levels coarsest first (``self._multires_for()``), runs
        the coarse-to-fine schedule, each coarse level against its strided
        sub-observation with its own stride-scaled ROI; the log then
        concatenates all phases.  Early stop does not act inside a phase;
        ``adaptive=True`` with ``early_stop_delta`` configured runs the
        full-resolution phase in chunks of ``early_stop_interval``
        iterations, chained through the Adam state and the best tracker
        (so the trajectory equals the unchunked one), with one host read
        per chunk, and stops once no hypothesis's chunk-final loss improved
        by ``early_stop_delta`` on the previous chunk's; the log then covers
        the executed iterations only.  Under temporal coherence every
        hypothesis keeps its own warm state (not with ``adaptive``).

        Returns ``(states, best, log)`` in the shapes of the JAX package:
        final and best states as ``states``, ``best["inlier_ratio"] (N,)``,
        and the log's entries ``(N, T, ...)`` (``log["loss"] (N, T)``).
        """
        early_delta = float(self.config.get("early_stop_delta", 0.0) or 0.0)
        if adaptive and early_delta > 0.0:
            return self._refine_batch_adaptive(
                states, depth_images, points, point_masks, camera_positions,
                camera_orientations, shape_optimization, roi, multires,
                early_delta)
        states, logs, executed = self._run_coarse_levels_batched(
            states, depth_images, camera_positions, camera_orientations,
            shape_optimization, multires)
        fine_iters = (int(self.config["max_iterations"]) - executed
                      if executed else None)
        states, _, best, log = self._refine_hypotheses(
            states, depth_images, points, point_masks, camera_positions,
            camera_orientations, shape_optimization, fine_iters, roi, 1,
            None, False, None, None)
        return _batch_result(states, best, logs + [log])

    def _run_coarse_levels_batched(self, states, depth_images,
                                   camera_positions, camera_orientations,
                                   shape_optimization: bool, multires):
        """The coarse levels of a batched refinement
        (``pipeline.py:1530-1576``): ``(states, per-level logs, executed
        coarse iterations)``, the states as :meth:`_refine_hypotheses`
        takes them.  A level not viable for these inputs is skipped, its
        iterations folding into the full-resolution phase."""
        schedule = _normalize_multires(multires)
        max_iterations = int(self.config["max_iterations"])
        if sum(n for _, n in schedule) >= max_iterations:
            raise ValueError(
                "multires schedule must leave at least one full-resolution "
                f"iteration (got {schedule} for max_iterations="
                f"{max_iterations})")
        states = _hypothesis_states(states, self.device)
        depth_images = torch.as_tensor(depth_images, dtype=torch.float32,
                                       device=self.device)
        logs, executed = [], 0
        for factor, n_iters in schedule:
            phase = self._coarse_phase(depth_images, factor)
            if phase is None:
                continue
            depth_c, points_c, point_masks_c, roi_c = phase
            states, _, _, log = self._refine_hypotheses(
                states, depth_c, points_c, point_masks_c, camera_positions,
                camera_orientations, shape_optimization, n_iters, roi_c,
                factor, None, False, None, None)
            logs.append(log)
            executed += n_iters
        return states, logs, executed

    def _refine_batch_adaptive(self, states, depth_images, points,
                               point_masks, camera_positions,
                               camera_orientations, shape_optimization: bool,
                               roi, multires, early_delta: float):
        """Batched early stop through chained chunks (see
        :meth:`refine_batch`, ``pipeline.py:1578-1663``): the coarse levels
        run whole, the full-resolution phase in ``early_stop_interval``
        chunks with one host read of the chunk-final losses each."""
        interval = int(self.config.get("early_stop_interval", 10))
        if interval < 1:
            raise ValueError(
                f"early_stop_interval must be >= 1, got {interval}")
        if self._use_temporal_coherence():
            # the warm state would restart at every chunk, so chunked would
            # no longer equal unchunked
            raise ValueError("adaptive refine_batch and temporal_coherence "
                             "are mutually exclusive")
        states, logs, executed = self._run_coarse_levels_batched(
            states, depth_images, camera_positions, camera_orientations,
            shape_optimization, multires)
        fine_iters = int(self.config["max_iterations"]) - executed
        opt_state = best = ref_loss = None
        done = 0
        while done < fine_iters:
            n = min(interval, fine_iters - done)
            states, opt_state, best, log = self._refine_hypotheses(
                states, depth_images, points, point_masks, camera_positions,
                camera_orientations, shape_optimization, n, roi, 1, None,
                False, opt_state, best)
            logs.append(log)
            done += n
            last_loss = log["loss"][-1]
            if ref_loss is not None:
                improved = (ref_loss - last_loss) >= early_delta * torch.clamp(
                    torch.abs(ref_loss), min=1e-8)
                if not bool(improved.any()):  # the chunk's one host read
                    break
            ref_loss = last_loss
        return _batch_result(states, best, logs)

    def _roi_for(self, depth_images, factor: int = 1
                 ) -> Optional[Tuple[int, int]]:
        """The refinement ROI of these views ``(V, H, W)`` (strided by
        ``factor`` for a coarse level), or None for full frame
        (``pipeline.py:741-770``): :meth:`_roi_from_spans` of the observed
        pixels' bbox spans, read on the host once."""
        depth = torch.as_tensor(depth_images, device=self.device)
        probe = _probe(depth.reshape(-1, *depth.shape[-2:])).tolist()
        return self._roi_from_spans(
            [(sy, sx) for valid, sy, sx in probe if valid], factor)

    def _multires_inputs(self, depth_images: torch.Tensor, factor: int):
        """``(depth, points, point_masks)`` of a coarse level: the exact
        ``[::f, ::f]`` sub-observation of the views ``(V, H, W)`` and its
        tile-order clouds lifted with ``camera.strided(f)``
        (``pipeline.py:813-827``)."""
        depth_c = depth_images[:, ::factor, ::factor].contiguous()
        return (depth_c, *self._lift(depth_c, factor))

    def _strided_needs_roi(self, factor: int) -> bool:
        """Whether a ``factor``-strided raster needs an ROI to reach the
        kernels (``pipeline.py:922-933``): never in the port, whose march
        takes any ray set; it plans as the JAX package's XLA backend does
        (see :meth:`_multires_for`)."""
        return False

    def _coarse_phase(self, depth_images: torch.Tensor, factor: int):
        """``(depth, points, point_masks, roi)`` of a coarse level for these
        views, or None when the level is not viable for them
        (``pipeline.py:935-951``; never None in the port, see
        :meth:`_strided_needs_roi`)."""
        depth_c, points_c, point_masks_c = self._multires_inputs(
            depth_images, factor)
        roi_c = self._roi_for(depth_c, factor)
        if roi_c is None and self._strided_needs_roi(factor):
            return None
        return depth_c, points_c, point_masks_c, roi_c

    def generate_depth(self, position, orientation, scale, latent
                       ) -> torch.Tensor:
        """Depth image ``(H, W)`` of an estimate (``pipeline.py:1664-1673``):
        ``position (3,)``, ``orientation (4,)`` and ``scale`` (one value) in
        the camera frame, ``latent (1, L)``; the decoder, then one march
        launch (:meth:`render`)."""
        latent = torch.as_tensor(latent, dtype=torch.float32,
                                 device=self.device)
        scale = torch.as_tensor(scale, dtype=torch.float32,
                                device=self.device)
        sdf = self._decode(latent.reshape(1, -1))[0, 0]
        return self.render(sdf, position, orientation,
                           1.0 / scale.reshape(()))

    def generate_mesh(self, latent, scale, complete_mesh: bool = False):
        """The estimate's mesh at its scale (``pipeline.py:1675-1703``):
        the decoder on the device, then on the host marching tetrahedra at
        ``iso_threshold`` (of the grid padded with 1 when
        ``complete_mesh``), centred on the grid.  Returns a
        :class:`sdfest_torch.pipeline.synthetic.Mesh`, or None when the
        level lies outside the grid's values."""
        from sdfest_torch.ops import marching_cubes as mc
        from sdfest_torch.pipeline.synthetic import Mesh

        with torch.no_grad():
            latent = torch.as_tensor(latent, dtype=torch.float32,
                                     device=self.device).reshape(1, -1)
            sdf = self._decode(latent)[0, 0].cpu().numpy()
        inc = 0
        if complete_mesh:
            inc = 2
            sdf = np.pad(sdf, 1, constant_values=1.0)
        s = 2.0 / (self.resolution - 1)
        vertices, faces = mc.marching_cubes(
            sdf, level=self.config["iso_threshold"], spacing=(s, s, s))
        if vertices is None or len(vertices) == 0:
            return None
        c = s * (self.resolution + inc - 1) / 2.0
        vertices = vertices - np.array([[c, c, c]])
        return Mesh(vertices=vertices, faces=faces,
                    scale=float(torch.as_tensor(scale).reshape(-1)[0]),
                    rel_scale=True)


def _plain_config(config: dict) -> dict:
    """A copy of a config with its tensors as numpy arrays, for the flight
    recorder's pickle (``pipeline.py:1706-1716``)."""
    out = {}
    for k, v in config.items():
        if isinstance(v, dict):
            out[k] = _plain_config(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = v
    return out
