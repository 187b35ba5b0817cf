"""SDF pose, scale and shape estimation from one depth view (counterpart of
``SDFPipeline`` in ``sdfest_tpu/pipeline/pipeline.py``).

``__call__`` runs: mask + far-field cut of the depth -> dense point cloud ->
PointNet init network with the discretized SO(3) head -> full-frame
refinement, where each iteration decodes the latent to a 64^3 SDF, renders
it fused with the pc values (:func:`render_depth_with_pc_values`: march and
sample kernels forward, sample-grad and scatter kernels backward), adds the
depth-L1 and pc losses, takes an Adam step with per-variable learning rates,
renormalizes the quaternion and tracks the best inlier ratio.

The loop has no host synchronisation: the best estimate is tracked with
``torch.where`` and the log is stacked at the end.  The one sync of a call
is the empty-observation check (:class:`NoDepthError`).

Out of this slice, and raising ``NotImplementedError``: ROI, multires,
early stop, temporal coherence, multi-view and ``init_view: best``, priors
and the point constraint, ``refine_batch``, ``generate_mesh`` and
``generate_depth``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.models.vae import create_decoder_from_config
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.camera import Camera
from sdfest_torch.ops.so3grid import SO3Grid
from sdfest_torch.pipeline import losses
from sdfest_torch.render.api import render_depth_with_pc_values
from sdfest_torch.utils import msgpack_reader
from sdfest_torch.utils.device import resolve_device
from sdfest_torch.utils.weights import load_flax_into, resolve_model_path

_STATE_KEYS = ("position", "orientation", "scale", "latent")


class NoDepthError(ValueError):
    """Raised when no valid depth data remains after preprocessing."""


def _check_slice(config: dict) -> None:
    """Reject the options this port does not implement yet."""
    unported = {
        "roi_size": bool(config.get("roi_size")),
        "multires_factor": config.get("multires_factor", 1) not in (1, None),
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
        # iterations), read after the call returns
        self.last_log: Optional[Dict[str, torch.Tensor]] = None

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

    def _refine(
        self,
        state: Dict[str, torch.Tensor],
        depth_image: torch.Tensor,
        points: torch.Tensor,
        point_mask: torch.Tensor,
        camera_position: Optional[torch.Tensor] = None,
        camera_orientation: Optional[torch.Tensor] = None,
        shape_optimization: bool = True,
        num_iterations: Optional[int] = None,
    ):
        """Full-frame refinement of one view.

        ``state`` holds ``position (1, 3)``, ``orientation (1, 4)``, ``scale
        (1,)`` and ``latent (1, L)`` in the world frame; ``points``/
        ``point_mask`` are the view's lifted cloud ``(H*W, 3)``/``(H*W,)``.
        Returns ``(state, best, log)``: the final state, the state with the
        best inlier ratio of its pre-step render, and the per-iteration log
        (each entry stacked over iterations).
        """
        dev = self.device
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        state = {k: f32(state[k]).detach().clone() for k in _STATE_KEYS}
        depth_image, points = f32(depth_image), f32(points)
        point_mask = torch.as_tensor(point_mask, device=dev)
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
            camera=self.camera,
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
        if not bool(torch.any(depth > 0)):  # the call's one host sync
            raise NoDepthError
        latent, position, scale, orientation = self._nn_init(
            depth, camera_position, camera_orientation, generator
        )
        points, point_mask = pointset.depth_to_pointcloud_dense(
            depth, self.camera, order="tile"
        )
        state = {"position": position, "orientation": orientation,
                 "scale": scale, "latent": latent}
        state, best, self.last_log = self._refine(
            state, depth, points, point_mask, camera_position,
            camera_orientation, shape_optimization,
        )
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
