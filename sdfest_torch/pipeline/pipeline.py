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
``torch.where`` and the log is stacked at the end.  The one sync of a call
reads the probe (:class:`NoDepthError` and the plan).  Early stop
(``early_stop_delta > 0``, preset ``mug_procedural_fast_adaptive``) adds
one host read per check of each phase: every ``early_stop_interval``
iterations, at most 5 per 50-iteration call at the default interval of 10.

:meth:`SDFPipeline.refine_batch` refines ``N`` hypotheses against shared
views with ONE launch of each kernel per view and iteration for all of
them (the kernels take the hypothesis as a launch dimension): full frame,
multires + ROI, adaptive chunks and temporal, each hypothesis on the
trajectory of its own ``_refine``.

Not ported, and raising ``NotImplementedError``: ``generate_mesh`` and
``generate_depth``; ``__call__`` has no ``log_path``, ``animation_path`` or
``visualize`` outputs (they need the evaluation modules).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.models.vae import create_decoder_from_config
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.pipeline import losses
from sdfest_torch.render.api import (
    crop,
    ray_set,
    render_depth_with_pc_values,
)
from sdfest_torch.render.warm import (
    init_warm_views,
    motion_bound,
    warm_render_step,
)
from sdfest_torch.utils import msgpack_reader
from sdfest_torch.utils.device import resolve_device
from sdfest_torch.utils.weights import load_flax_into, resolve_model_path

_STATE_KEYS = ("position", "orientation", "scale", "latent")
# the log's entries with one value per hypothesis and iteration
_LOSS_KEYS = ("loss", "loss_depth", "loss_pc", "inlier_ratio")


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

    ``fused_call`` is accepted and ignored: the port has one path, whose
    plan is the JAX package's fused one.
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
        :data:`sdfest_torch.utils.presets.MUG_PROCEDURAL`) and load their
        committed flax weights; missing ``model`` keys leave PyTorch's random
        initialization.  Runs on ``device`` ("cuda" unless asked otherwise).
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
        path = resolve_model_path(self.vae_config)
        if path is not None:
            load_flax_into(self.decoder, msgpack_reader.load(path)["decoder"])
        self.init_network = create_pose_net(
            self.init_config, shape_dimension=self.vae_config["latent_size"]
        )
        path = resolve_model_path(self.init_config)
        if path is not None:
            load_flax_into(self.init_network, msgpack_reader.load(path))
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

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    def _decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Latents ``(B, L)`` -> SDFs ``(B, 1, D, D, D)``, one batch."""
        return self.decoder(latent)

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
    ) -> Tuple[torch.Tensor, ...]:
        """Init network over views with the ``init_view`` strategy
        (``_nn_init_views``, ``pipeline.py:210-287``).

        ``depth`` is ``(V, H, W)`` (or one view ``(H, W)``), the cameras'
        world poses ``(V, 3)``/``(V, 4)`` (or ``(3,)``/``(4,)``), ``prior``
        a ``(V, C)`` prior over the SO(3) grid cells and ``training_prior``
        the ``(C,)`` prior the network was trained under.  Each view lifts
        and subsamples its own cloud (draws from ``generator`` view by view,
        in order); the networks run as one batch.  "first" takes view 0,
        "best" the view whose adjusted posterior peaks highest.  Returns
        ``(latent (1, L), position (1, 3), scale (1,), orientation (1, 4))``
        in the world frame.
        """
        self._validate_init_options(prior)
        depth = depth.reshape(-1, *depth.shape[-2:])
        camera_positions = camera_positions.reshape(-1, 3)
        camera_orientations = camera_orientations.reshape(-1, 4)
        best = self.config.get("init_view", "first") == "best"
        n_views = depth.shape[0] if best else 1  # "first" needs view 0 only
        sampled, centroids = [], []
        for v in range(n_views):
            points, valid = pointset.depth_to_pointcloud_dense(depth[v],
                                                               self.camera)
            centroid = torch.zeros(3, dtype=points.dtype, device=points.device)
            if self.init_config.get("normalize_pose", True):
                points, centroid = pointset.normalize_points_masked(points,
                                                                    valid)
            sampled.append(pointset.subsample_masked(
                points, valid, self._num_input_points, generator)[0])
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

    def _make_adam(self):
        """Adam (b1 0.9, b2 0.999, eps 1e-8) with per-variable learning
        rates, written out as optax's ``scale_by_adam`` + ``scale(-lr)``."""
        lrs = {
            "position": self.config.get("position_lr", 1e-3),
            "orientation": self.config.get("orientation_lr", 1e-2),
            "scale": self.config.get("scale_lr", 1e-3),
            "latent": self.config.get("latent_lr", 1e-2),
        }
        b1, b2, eps = 0.9, 0.999, 1e-8

        def step(params, grads, moments, count):
            out = {}
            for k in _STATE_KEYS:
                g = grads[k]
                mu = (1 - b1) * g + b1 * moments[k][0]
                nu = (1 - b2) * (g ** 2) + b2 * moments[k][1]
                moments[k] = (mu, nu)
                mu_hat = mu / (1 - b1 ** count)
                nu_hat = nu / (1 - b2 ** count)
                update = mu_hat / (torch.sqrt(nu_hat + 0.0) + eps)
                out[k] = params[k] + (-lrs[k]) * update
            return out

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
        it (its step count included); ``best`` likewise carries the best
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
        for ``active``.
        """
        dev = self.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        state = {k: f32(state[k]).detach().clone() for k in _STATE_KEYS}
        n_hyps = state["position"].shape[0]
        depth_image = f32(depth_image)
        depth_image = depth_image.reshape(-1, *depth_image.shape[-2:])
        n_views = depth_image.shape[0]
        camera = (self.camera if ds_factor == 1
                  else self.camera.strided(ds_factor))
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
        if camera_position is None:
            camera_position = torch.zeros(n_views, 3, device=dev)
        if camera_orientation is None:
            camera_orientation = f32([0.0, 0.0, 0.0, 1.0]).expand(n_views, 4)
        camera_position = f32(camera_position).reshape(n_views, 3)
        q_w2c = quaternion.invert(f32(camera_orientation).reshape(n_views, 4))
        # per view: (observed depth, cloud, cloud mask, rays)
        views = []
        if roi is None:
            points = f32(points).reshape(n_views, -1, 3)
            point_mask = torch.as_tensor(point_mask, device=dev).reshape(
                n_views, -1)
            rays = ray_set(camera, dev)
            views = [(depth_image[v], points[v], point_mask[v], rays)
                     for v in range(n_views)]
        else:
            roi = (int(roi[0]), int(roi[1]))
            for d in depth_image:
                offset = _roi_offset_for(d, roi)
                d = crop(d, roi, offset)
                views.append((d, *pointset.depth_to_pointcloud_dense(
                    d, camera, order="tile", pixel_offset=offset),
                    ray_set(camera, dev, roi, offset)))
        if point_constraint is not None:
            source, target, pc_w = point_constraint
            source, target, pc_w = f32(source), f32(target), float(pc_w)
        n_iter = (num_iterations if num_iterations is not None
                  else int(self.config["max_iterations"]))
        depth_weight = self.config.get("depth_weight", 1.0)
        pc_weight = self.config.get("pc_weight", 1.0)
        threshold = self.config["threshold"]
        render_kwargs = dict(
            camera=camera,
            threshold=threshold,
            culling=bool(self.config.get("coarse_culling", True)),
            adaptive=bool(self.config.get("adaptive_relaxation", True)),
            relaxation=float(self.config.get("relaxation", 1.0)),
            bf16=bool(self.config.get("bf16_march", False)),
            device=dev,
        )
        adam = self._make_adam()
        if opt_state is None:
            count = 0
            moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
                       for k, v in state.items()}
        else:
            count, moments = opt_state["count"], dict(opt_state["moments"])
        if best is None:
            best = {"inlier_ratio": f32([-1.0] * n_hyps),
                    **{k: state[k].clone() for k in _STATE_KEYS}}
        else:
            best = {k: f32(best[k]) for k in ("inlier_ratio", *_STATE_KEYS)}
        if use_warm:
            warm0 = init_warm_views(n_views, camera.height, camera.width,
                                    n_hyps, dev)
            view_warms = [{k: x[v] for k, x in warm0.items()}
                          for v in range(n_views)]
            shared = {
                "position": state["position"],
                "orientation": _unit(state["orientation"]),
                "scale": state["scale"],
                "sdf": torch.zeros((n_hyps,) + (self.resolution,) * 3,
                                   device=dev),
            }
        ref_loss = f32(1e30)  # early stop: the first check always improves
        logs = []
        for it in range(n_iter):
            params = {k: state[k].detach().requires_grad_(True)
                      for k in _STATE_KEYS}
            norm_q = _unit(params["orientation"])
            latent = params["latent"]
            if not shape_optimization:
                latent = latent.detach()
            sdf = self._decode(latent)[:, 0]
            if use_warm:
                motion = motion_bound(params["position"], norm_q,
                                      params["scale"], sdf, shared)
            view_losses = []
            for v, (depth_v, points_v, mask_v, rays_v) in enumerate(views):
                position_c = quaternion.apply(
                    q_w2c[v], params["position"] - camera_position[v])
                orientation_c = quaternion.multiply(q_w2c[v], norm_q)
                if use_warm:
                    depth_estimate, view_warms[v] = warm_render_step(
                        sdf, position_c, orientation_c, params["scale"],
                        view_warms[v], motion, it % refresh_k == 0, camera,
                        threshold, device=dev,
                    )
                    loss_pc = losses.masked_pc_loss(
                        points_v, mask_v, position_c, orientation_c,
                        params["scale"], sdf,
                    )
                else:
                    depth_estimate, pc_values = render_depth_with_pc_values(
                        sdf, position_c, orientation_c, params["scale"],
                        points_v, mask_v, rays=rays_v, **render_kwargs,
                    )
                    loss_pc = losses.masked_mean_abs(pc_values, mask_v)
                view_losses.append((losses.depth_l1_loss(
                    depth_v, depth_estimate), loss_pc))
            # summed in view order, as the JAX package's scan over views
            loss_depth, loss_pc = view_losses[0]
            for ld, lp in view_losses[1:]:
                loss_depth, loss_pc = loss_depth + ld, loss_pc + lp
            loss = depth_weight * loss_depth + pc_weight * loss_pc
            if point_constraint is not None:
                loss = loss + pc_w * losses.point_constraint_loss(
                    params["orientation"], source, target)
            if use_warm:
                shared = {"position": params["position"].detach(),
                          "orientation": norm_q.detach(),
                          "scale": params["scale"].detach(),
                          "sdf": sdf.detach()}
            wanted = [k for k in _STATE_KEYS
                      if k != "latent" or shape_optimization]
            got = torch.autograd.grad(loss.sum(),
                                      [params[k] for k in wanted])
            grads = {k: torch.zeros_like(state[k]) for k in _STATE_KEYS}
            grads.update(zip(wanted, got))
            with torch.no_grad():
                count += 1
                state = adam(state, grads, moments, count)
                state["orientation"] = _unit(state["orientation"])
                # the last view's observation and pre-step render
                ratio = losses.inlier_ratio(
                    views[-1][0], depth_estimate,
                    self._relative_inlier_threshold,
                )
                is_better = ratio > best["inlier_ratio"]
                best = {
                    "inlier_ratio": torch.where(is_better, ratio,
                                                best["inlier_ratio"]),
                    **{k: torch.where(_per_row(is_better, state[k]),
                                      state[k], best[k])
                       for k in _STATE_KEYS},
                }
                logs.append({
                    "loss": loss.detach(),
                    "loss_depth": loss_depth.detach(),
                    "loss_pc": loss_pc.detach(),
                    "inlier_ratio": ratio,
                    **{k: state[k] for k in _STATE_KEYS},
                    "active": f32(1.0),
                })
                if early_delta > 0.0 and (it + 1) % early_interval == 0:
                    # the absolute floor lets a zero-loss plateau count as
                    # converged (pipeline.py:670-677)
                    improved = (ref_loss - loss) >= early_delta * torch.clamp(
                        torch.abs(ref_loss), min=1e-8)
                    ref_loss = loss.detach()
                    if not bool(improved.all()):  # the check's host read
                        break
        if logs:
            logs += [dict(logs[-1], active=f32(0.0))] * (n_iter - len(logs))
        log = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]} if (
            logs) else {}
        return state, {"count": count, "moments": moments}, best, log

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
            visualize / log_path / animation_path / animation_mode: The
                reference's plots, flight recorder and animation.  Not
                ported yet (ROADMAP section 1, item 4): ``visualize=True``,
                a ``log_path`` or an ``animation_path`` raises
                ``NotImplementedError`` before any device work.
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
            (1, L))`` in the world frame.

        The probe (one host read) raises :class:`NoDepthError` when view 0
        ("first") or any view ("best") has no valid depth, and gives the
        plan.  With ``reuse_plan: true`` a call after the first reuses the
        previous call's plan and runs no probe, so it cannot raise
        :class:`NoDepthError` up front (``pipeline.py:1208-1216``).
        """
        unported = [name for name, given in (
            ("visualize", visualize), ("log_path", log_path is not None),
            ("animation_path", animation_path is not None)) if given]
        if unported:
            raise NotImplementedError(
                f"{', '.join(unported)}: not ported yet (the evaluation "
                "modules, ROADMAP section 1, item 4)")
        dev = self.device
        depth = torch.as_tensor(depth_images, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(masks, device=dev)
        prior = prior_orientation_distribution
        if depth.ndim == 2:
            depth, mask = depth[None], mask[None]
            if prior is not None:
                prior = torch.as_tensor(prior)[None]
        n_views = depth.shape[0]
        camera_positions = torch.zeros(n_views, 3, device=dev) if (
            camera_positions is None) else torch.as_tensor(
                camera_positions, dtype=torch.float32, device=dev
            ).reshape(n_views, 3)
        camera_orientations = torch.tensor(
            [[0.0, 0.0, 0.0, 1.0]] * n_views, device=dev
        ) if camera_orientations is None else torch.as_tensor(
            camera_orientations, dtype=torch.float32, device=dev
        ).reshape(n_views, 4)
        f32 = lambda x: None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=dev)
        prior = f32(prior)
        training_prior = f32(training_orientation_distribution)
        self._validate_init_options(prior)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        depth = self._preprocess_depth(depth, mask)
        plan = self._cached_plan if bool(
            self.config.get("reuse_plan", False)) else None
        if plan is None:
            probe = _probe(depth).tolist()  # the one sync
            first = self.config.get("init_view", "first") == "first"
            if not (probe[0][0] if first else all(p[0] for p in probe)):
                raise NoDepthError
            plan = self._cached_plan = self._plan_for(
                [(sy, sx) for valid, sy, sx in probe if valid])
        levels, fine_roi, fine_iters = self.last_plan = plan
        latent, position, scale, orientation = self._nn_init(
            depth, camera_positions, camera_orientations, generator, prior,
            training_prior,
        )
        state = {"position": position, "orientation": orientation,
                 "scale": scale, "latent": latent}
        cameras = (camera_positions, camera_orientations)
        logs = []
        # coarse levels hand over their final state; their best is dropped
        # (coarse inlier ratios do not compare with full-raster ones)
        for factor, n_iters, roi in levels:
            depth_c = depth[:, ::factor, ::factor].contiguous()
            cloud = (None, None) if roi else self._lift(depth_c, factor)
            state, _, log = self._refine(
                state, depth_c, *cloud, *cameras, shape_optimization, n_iters,
                roi, factor, point_constraint,
            )
            logs.append(log)
        cloud = (None, None) if fine_roi else self._lift(depth, 1)
        state, best, log = self._refine(
            state, depth, *cloud, *cameras, shape_optimization, fine_iters,
            fine_roi, 1, point_constraint,
        )
        logs.append(log)
        self.last_log = {k: torch.cat([lg[k] for lg in logs]) for k in log}
        chosen = state if self.result_selection_strategy == "last_iteration" \
            else best
        return (chosen["position"], chosen["orientation"], chosen["scale"],
                chosen["latent"])

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

    def generate_mesh(self, *args, **kwargs):
        raise NotImplementedError("generate_mesh is not ported yet")

    def generate_depth(self, *args, **kwargs):
        raise NotImplementedError("generate_depth is not ported yet")
