"""SDF pose, scale and shape estimation from one depth view (counterpart of
``SDFPipeline`` in ``sdfest_tpu/pipeline/pipeline.py``).

``__call__`` runs: mask + far-field cut of the depth -> the probe (empty
check and the object's bbox spans) -> the plan -> dense point cloud ->
PointNet init network with the discretized SO(3) head -> refinement phases.
Each iteration decodes the latent to a 64^3 SDF, renders it fused with the
pc values (:func:`render_depth_with_pc_values`: march and sample kernels
forward, sample-grad and scatter kernels backward), adds the depth-L1 and
pc losses, takes an Adam step with per-variable learning rates,
renormalizes the quaternion and tracks the best inlier ratio.

The plan is the JAX package's fused one (``_plan_for``): the coarse levels
of ``multires_factor`` (each against the exactly-strided sub-observation of
``Camera.strided``), then the full-resolution phase; each phase renders
only an ROI crop around the observed pixels when ``roi_size`` is set and
the object fits (``fast.yaml``: ``roi_size: auto``, ``[4, 2]``).

The loop has no host synchronisation: the best estimate is tracked with
``torch.where`` and the log is stacked at the end.  The one sync of a call
reads the probe (:class:`NoDepthError` and the plan).

Out of this slice, and raising ``NotImplementedError``: early stop,
temporal coherence, ``reuse_plan``, multi-view and ``init_view: best``,
priors and the point constraint, ``refine_batch``, ``generate_mesh`` and
``generate_depth``.
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
from sdfest_torch.utils import msgpack_reader
from sdfest_torch.utils.device import resolve_device
from sdfest_torch.utils.weights import load_flax_into, resolve_model_path

_STATE_KEYS = ("position", "orientation", "scale", "latent")


class NoDepthError(ValueError):
    """Raised when no valid depth data remains after preprocessing."""


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
    """``[valid, span_rows, span_cols]`` (int64, on the device) of a
    preprocessed view: whether any pixel is observed and the bbox spans of
    the observed pixels (``_probe``, ``pipeline.py:952-976``)."""
    seen = depth > 0

    def span(b):
        idx = torch.arange(b.shape[0], device=b.device)
        mx = torch.amax(torch.where(b, idx, -1))
        mn = torch.amin(torch.where(b, idx, b.shape[0]))
        return torch.clamp(mx - mn + 1, min=0)

    return torch.stack([torch.any(seen).long(), span(torch.any(seen, dim=1)),
                        span(torch.any(seen, dim=0))])


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
    """Reject the options this port does not implement yet.

    ``fused_call`` is accepted and ignored: the port has one path, whose
    plan is the JAX package's fused one.
    """
    unported = {
        "reuse_plan": bool(config.get("reuse_plan", False)),
        "early_stop_delta": float(config.get("early_stop_delta") or 0.0) > 0,
        "temporal_coherence": bool(config.get("temporal_coherence", False)),
        "relaxation": float(config.get("relaxation", 1.0)) > 1.0,
        "bf16_march": bool(config.get("bf16_march", False)),
        "init_view": config.get("init_view", "first") != "first",
    }
    for key, hit in unported.items():
        if hit:
            raise NotImplementedError(f"config option {key}={config[key]!r} "
                                      "is not ported yet")
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

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------

    def _decode(self, latent: torch.Tensor) -> torch.Tensor:
        """Latent ``(1, L)`` -> SDF ``(1, 1, D, D, D)``."""
        return self.decoder(latent)

    def _preprocess_depth(self, depth: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
        """Mask the depth and cut the far field."""
        depth = torch.where(mask != 0, depth, torch.zeros_like(depth))
        if self._far_field is not None:
            depth = torch.where(depth > self._far_field,
                                torch.zeros_like(depth), depth)
        return depth

    def _nn_init(self, depth: torch.Tensor, camera_position: torch.Tensor,
                 camera_orientation: torch.Tensor,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, ...]:
        """Init network on one view (``_nn_init_views`` with ``init_view:
        first``): returns ``(latent (1, L), position (1, 3), scale (1,),
        orientation (1, 4))`` in the world frame."""
        points, valid = pointset.depth_to_pointcloud_dense(depth, self.camera)
        centroid = torch.zeros(3, dtype=points.dtype, device=points.device)
        if self.init_config.get("normalize_pose", True):
            points, centroid = pointset.normalize_points_masked(points, valid)
        sampled, _ = pointset.subsample_masked(
            points, valid, self._num_input_points, generator
        )
        with torch.no_grad():
            latent, position, scale, orientation = self.init_network(
                sampled[None]
            )
        if self.config.get("mean_shape", False):
            latent = torch.zeros_like(latent)
        position = position + centroid[None]
        if self.orientation_repr == "discretized":
            posterior = torch.softmax(orientation, dim=-1)
            orientation = self._grid_quats[torch.argmax(posterior, dim=-1)]
        position = quaternion.apply(camera_orientation, position) + (
            camera_position
        )
        orientation = quaternion.multiply(camera_orientation, orientation)
        return latent, position, scale, orientation

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
        alignment is kept only to give the plan of the JAX package.
        """
        roi_cfg = self.config.get("roi_size")
        if not roi_cfg:
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
        aligned tiles; the port's march takes any ray set.
        """
        f_cfg = self.config.get("multires_factor", 1) or 1
        n_cfg = self.config.get("multires_iterations", 0)
        is_schedule = isinstance(f_cfg, (list, tuple))
        factors = [int(f) for f in (f_cfg if is_schedule else [f_cfg])]
        if self.camera.s != 0.0:
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
        """Tile-order cloud of a (strided) full-raster depth image."""
        camera = self.camera if factor == 1 else self.camera.strided(factor)
        return pointset.depth_to_pointcloud_dense(depth, camera, order="tile")

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
    ):
        """One refinement phase of one view.

        ``state`` holds ``position (1, 3)``, ``orientation (1, 4)``, ``scale
        (1,)`` and ``latent (1, L)`` in the world frame; ``points``/
        ``point_mask`` are the view's lifted cloud ``(H*W, 3)``/``(H*W,)``.
        With ``ds_factor=f > 1`` the phase runs against the strided
        sub-observation: ``depth_image`` and the cloud are the ``[::f,
        ::f]`` slice lifted with ``camera.strided(f)``.  With ``roi=(Hr,
        Wr)`` each render is the crop around the observed pixels (offset
        from this phase's depth) and the cloud is re-lifted from the crop,
        so ``points``/``point_mask`` are ignored and may be None
        (``pipeline.py:445-474``).  Adam starts afresh (zero moments, step
        1).  Returns ``(state, best, log)``: the final state, the state with
        the best inlier ratio of its pre-step render, and the per-iteration
        log (each entry stacked over iterations).
        """
        dev = self.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        state = {k: f32(state[k]).detach().clone() for k in _STATE_KEYS}
        depth_image = f32(depth_image)
        camera = (self.camera if ds_factor == 1
                  else self.camera.strided(ds_factor))
        if roi is None:
            points = f32(points)
            point_mask = torch.as_tensor(point_mask, device=dev)
            rays = ray_set(camera, dev)
        else:
            roi = (int(roi[0]), int(roi[1]))
            offset = _roi_offset_for(depth_image, roi)
            depth_image = crop(depth_image, roi, offset)
            points, point_mask = pointset.depth_to_pointcloud_dense(
                depth_image, camera, order="tile", pixel_offset=offset
            )
            rays = ray_set(camera, dev, roi, offset)
        if camera_position is None:
            camera_position = torch.zeros(3, device=dev)
        if camera_orientation is None:
            camera_orientation = f32([0.0, 0.0, 0.0, 1.0])
        q_w2c = quaternion.invert(f32(camera_orientation))
        camera_position = f32(camera_position)
        n_iter = (num_iterations if num_iterations is not None
                  else int(self.config["max_iterations"]))
        depth_weight = self.config.get("depth_weight", 1.0)
        pc_weight = self.config.get("pc_weight", 1.0)
        render_kwargs = dict(
            camera=camera,
            rays=rays,
            threshold=self.config["threshold"],
            culling=bool(self.config.get("coarse_culling", True)),
            adaptive=bool(self.config.get("adaptive_relaxation", True)),
            device=dev,
        )
        adam = self._make_adam()
        moments = {k: (torch.zeros_like(v), torch.zeros_like(v))
                   for k, v in state.items()}
        best = {"inlier_ratio": f32(-1.0),
                **{k: state[k].clone() for k in _STATE_KEYS}}
        logs = []
        for it in range(n_iter):
            params = {k: state[k].detach().requires_grad_(True)
                      for k in _STATE_KEYS}
            norm_q = params["orientation"] / torch.sqrt(
                torch.sum(params["orientation"] ** 2)
            )
            latent = params["latent"]
            if not shape_optimization:
                latent = latent.detach()
            sdf = self._decode(latent)[0, 0]
            position_c = quaternion.apply(
                q_w2c, params["position"][0] - camera_position
            )
            orientation_c = quaternion.multiply(q_w2c, norm_q[0])
            depth_estimate, pc_values = render_depth_with_pc_values(
                sdf, position_c, orientation_c, params["scale"][0], points,
                point_mask, **render_kwargs,
            )
            loss_pc = losses.masked_mean_abs(pc_values, point_mask)
            loss_depth = losses.depth_l1_loss(depth_image, depth_estimate)
            loss = depth_weight * loss_depth + pc_weight * loss_pc
            wanted = [k for k in _STATE_KEYS
                      if k != "latent" or shape_optimization]
            got = torch.autograd.grad(loss, [params[k] for k in wanted])
            grads = {k: torch.zeros_like(state[k]) for k in _STATE_KEYS}
            grads.update(zip(wanted, got))
            with torch.no_grad():
                state = adam(state, grads, moments, it + 1)
                state["orientation"] = state["orientation"] / torch.sqrt(
                    torch.sum(state["orientation"] ** 2)
                )
                ratio = losses.inlier_ratio(
                    depth_image, depth_estimate,
                    self._relative_inlier_threshold,
                )
                is_better = ratio > best["inlier_ratio"]
                best = {
                    "inlier_ratio": torch.where(is_better, ratio,
                                                best["inlier_ratio"]),
                    **{k: torch.where(is_better, state[k], best[k])
                       for k in _STATE_KEYS},
                }
                logs.append({
                    "loss": loss.detach(),
                    "loss_depth": loss_depth.detach(),
                    "loss_pc": loss_pc.detach(),
                    "inlier_ratio": ratio,
                    **{k: state[k] for k in _STATE_KEYS},
                })
        log = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]} if (
            logs) else {}
        return state, best, log

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def __call__(
        self,
        depth_images,
        masks,
        camera_positions=None,
        camera_orientations=None,
        shape_optimization: bool = True,
        point_constraint=None,
        prior_orientation_distribution=None,
        training_orientation_distribution=None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Infer pose, scale and latent shape from one depth view.

        Args:
            depth_images: Depth along the camera z-axis, ``(H, W)`` or
                ``(1, H, W)``; masked and far-field-cut internally.
            masks: Binary object mask of the same shape.
            camera_positions / camera_orientations: The camera's world pose
                (``(3,)``/``(4,)``, or with a leading view axis of 1);
                identity when None.
            shape_optimization: Optimize the latent during refinement.
            generator: ``torch.Generator`` on the pipeline's device for the
                init's point subsampling; a fresh one seeded 0 when None.
        Returns:
            ``(position (1, 3), orientation (1, 4), scale (1,), latent
            (1, L))`` in the world frame.
        """
        if point_constraint is not None:
            raise NotImplementedError("the point constraint is not ported yet")
        if (prior_orientation_distribution is not None
                or training_orientation_distribution is not None):
            raise NotImplementedError("orientation priors are not ported yet")
        dev = self.device
        depth = torch.as_tensor(depth_images, dtype=torch.float32, device=dev)
        mask = torch.as_tensor(masks, device=dev)
        if depth.ndim == 3:
            if depth.shape[0] != 1:
                raise NotImplementedError("multi-view is not ported yet")
            depth, mask = depth[0], mask[0]
        camera_position = torch.zeros(3, device=dev) if (
            camera_positions is None) else torch.as_tensor(
                camera_positions, dtype=torch.float32, device=dev
            ).reshape(3)
        camera_orientation = torch.tensor(
            [0.0, 0.0, 0.0, 1.0], device=dev
        ) if camera_orientations is None else torch.as_tensor(
            camera_orientations, dtype=torch.float32, device=dev
        ).reshape(4)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        depth = self._preprocess_depth(depth, mask)
        valid, span_rows, span_cols = _probe(depth).tolist()  # the one sync
        if not valid:
            raise NoDepthError
        levels, fine_roi, fine_iters = self.last_plan = self._plan_for(
            [(span_rows, span_cols)])
        latent, position, scale, orientation = self._nn_init(
            depth, camera_position, camera_orientation, generator
        )
        state = {"position": position, "orientation": orientation,
                 "scale": scale, "latent": latent}
        logs = []
        # coarse levels hand over their final state; their best is dropped
        # (coarse inlier ratios do not compare with full-raster ones)
        for factor, n_iters, roi in levels:
            depth_c = depth[::factor, ::factor].contiguous()
            cloud = (None, None) if roi else self._lift(depth_c, factor)
            state, _, log = self._refine(
                state, depth_c, *cloud, camera_position, camera_orientation,
                shape_optimization, n_iters, roi, factor,
            )
            logs.append(log)
        cloud = (None, None) if fine_roi else self._lift(depth, 1)
        state, best, log = self._refine(
            state, depth, *cloud, camera_position, camera_orientation,
            shape_optimization, fine_iters, fine_roi,
        )
        logs.append(log)
        self.last_log = {k: torch.cat([lg[k] for lg in logs]) for k in log}
        chosen = state if self.result_selection_strategy == "last_iteration" \
            else best
        return (chosen["position"], chosen["orientation"], chosen["scale"],
                chosen["latent"])

    def refine_batch(self, *args, **kwargs):
        raise NotImplementedError("refine_batch is not ported yet")

    def generate_mesh(self, *args, **kwargs):
        raise NotImplementedError("generate_mesh is not ported yet")

    def generate_depth(self, *args, **kwargs):
        raise NotImplementedError("generate_depth is not ported yet")
