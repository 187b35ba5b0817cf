"""The reference estimate: the init network on a subsample of the lifted
depth, the coarse-to-fine plan with its ROI crops, and render-and-compare
refinement (depth-L1 and pc losses, Adam with per-variable learning rates,
the quaternion renormalized after each step).

Two uses.  :meth:`Estimate.run` is the estimate from raw inputs, free
running, as a caller would compute it (the control puts it, in a lower
precision, in the program's place).  :meth:`Estimate.follow` checks a
program's estimate step by step: it computes the start from the raw inputs
itself, and every later iteration from the program's own state before that
iteration, keeping its own Adam moments from its own gradients along the
program's trajectory; so a rounding difference does not grow through the
sphere tracer's discontinuities from one iteration to the next.  The plan,
the crops, the grids and all states are recomputed here from the inputs.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

from bench_port.reference import models, ops, render

STATE_KEYS = ("position", "orientation", "scale", "latent")
B1, B2, EPS = 0.9, 0.999, 1e-8


def _unit(q):
    return q / torch.sqrt(torch.sum(q ** 2, dim=-1, keepdim=True))


def _align(x) -> int:
    return max(16, -(-int(x) // 16) * 16)


class Estimate:
    """The reference of ``SDFPipeline.__call__`` and ``refine_batch`` for
    one view with the camera at the origin."""

    def __init__(self, config: Dict, root: str, device, tf32: bool = False):
        self.config = config
        self.device = torch.device(device)
        self.tf32 = tf32
        self.camera = ops.Camera(**config["camera"])
        vae = config["vae"]
        self.latent_size = vae["latent_size"]
        self.decoder = models.Decoder(vae["latent_size"],
                                      vae["decoder"]["fc_layers"],
                                      vae["decoder"]["conv_layers"])
        models.load_into(self.decoder, models.flax_state(
            models.load_msgpack(os.path.join(root, vae["model"]))["decoder"]))
        init = config["init"]
        self.init_net = models.InitNet(init, vae["latent_size"])
        models.load_into(self.init_net, models.flax_state(
            models.load_msgpack(os.path.join(root, init["model"]))))
        for net in (self.decoder, self.init_net):
            models.set_tf32(net, tf32)
            net.to(self.device).eval().requires_grad_(False)
        self.grid_quats = torch.as_tensor(
            models.so3_quaternions(init["head"]["orientation_grid_resolution"]),
            dtype=torch.float32, device=self.device)
        self.num_points = config.get("num_input_points", 2500)
        self.lrs = {"position": config.get("position_lr", 1e-3),
                    "orientation": config.get("orientation_lr", 1e-2),
                    "scale": config.get("scale_lr", 1e-3),
                    "latent": config.get("latent_lr", 1e-2)}

    # -- inputs, init and plan ----------------------------------------------

    def preprocess(self, depth, mask):
        depth = torch.where(mask != 0, depth, torch.zeros_like(depth))
        far = self.config.get("far_field")
        if far is not None:
            depth = torch.where(depth > far, torch.zeros_like(depth), depth)
        return depth

    def init(self, depth, uniforms) -> Dict[str, torch.Tensor]:
        """The init network's state ``(1, ...)`` from a preprocessed view
        ``(H, W)`` and the subsampling uniforms ``(P,)``."""
        points, valid = ops.lift(depth, self.camera)
        points, centroid = ops.normalize_masked(points, valid)
        sampled = ops.subsample(points, valid, uniforms)
        with torch.no_grad(), models.precision(self.tf32):
            latent, position, scale, logits = self.init_net(sampled[None])
        position = position + centroid[None]
        q = self.grid_quats[torch.argmax(torch.softmax(logits, dim=-1),
                                         dim=-1)]
        ident = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)
        position = ops.q_apply(ident, position) + torch.zeros(
            1, 3, device=self.device)
        q = ops.q_multiply(ident, q)
        return {"position": position, "orientation": q, "scale": scale,
                "latent": latent}

    def plan(self, depth):
        return plan(self.config, depth)

    def _roi_offset(self, depth, roi):
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

    def view(self, depth, factor: int, roi, points=None, point_mask=None):
        """A phase's view: ``(depth, points, mask, rays)`` of the
        preprocessed full view, strided by ``factor`` and cropped to
        ``roi``; ``points``/``point_mask`` are the full-frame cloud a caller
        passed (``refine_batch``), lifted here otherwise."""
        camera = self.camera if factor == 1 else self.camera.strided(factor)
        if factor > 1:
            depth = depth[::factor, ::factor].contiguous()
        if roi is None:
            if points is None:
                points, point_mask = ops.lift(depth, camera, order="tile")
            return depth, points, point_mask, render.ray_set(camera,
                                                             self.device)
        offset = self._roi_offset(depth, roi)
        d = render.crop(depth, roi, offset)
        points, mask = ops.lift(d, camera, order="tile", pixel_offset=offset)
        return d, points, mask, render.ray_set(camera, self.device, roi,
                                               offset)

    # -- one iteration -------------------------------------------------------

    def step(self, view, state, moments, count: int, shape: bool = True):
        """Iteration ``count`` (1 on a phase's first) of ``B`` hypotheses
        ``state`` ``(B, ...)``: returns ``(state, moments, losses)``, the
        losses ``(B,)`` those of the state given."""
        depth, points, mask, rays = view
        params = {k: state[k].detach().clone().requires_grad_(True)
                  for k in STATE_KEYS}
        norm_q = _unit(params["orientation"])
        latent = params["latent"] if shape else params["latent"].detach()
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=self.device)
        q_w2c = ops.q_invert(ident[None])[0]
        with models.precision(self.tf32):
            sdf = self.decoder(latent)[:, 0]
            position_c = ops.q_apply(q_w2c, params["position"] - torch.zeros(
                3, device=self.device))
            orientation_c = ops.q_multiply(q_w2c, norm_q)
            est, pc = render.render_with_pc(
                sdf, position_c, orientation_c, params["scale"], points,
                mask, rays, self.config["threshold"])
            overlap = (depth > 0) & (est > 0)
            w = overlap.to(est.dtype)
            loss_depth = torch.sum(torch.abs(est - depth) * w, dim=(-2, -1)) \
                / torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)
            wm = (mask != 0).to(pc.dtype)
            loss_pc = torch.sum(torch.abs(pc) * wm, dim=-1) / torch.clamp(
                torch.sum(wm), min=1.0)
            loss = (self.config.get("depth_weight", 1.0) * loss_depth
                    + self.config.get("pc_weight", 1.0) * loss_pc)
            wanted = [k for k in STATE_KEYS if k != "latent" or shape]
            got = torch.autograd.grad(loss.sum(), [params[k] for k in wanted])
        grads = {k: torch.zeros_like(state[k]) for k in STATE_KEYS}
        grads.update(zip(wanted, got))
        with torch.no_grad():
            c = torch.tensor(count, dtype=torch.float64, device=self.device)
            c1 = (1 - torch.pow(B1, c)).to(torch.float32)
            c2 = (1 - torch.pow(B2, c)).to(torch.float32)
            out, new_moments = {}, {}
            for k in STATE_KEYS:
                g = grads[k]
                mu = (1 - B1) * g + B1 * moments[k][0]
                nu = (1 - B2) * (g ** 2) + B2 * moments[k][1]
                new_moments[k] = (mu, nu)
                update = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + EPS)
                out[k] = state[k] + (-self.lrs[k]) * update
            out["orientation"] = _unit(out["orientation"])
        return out, new_moments, loss.detach()

    @staticmethod
    def _zero_moments(state):
        return {k: (torch.zeros_like(v), torch.zeros_like(v))
                for k, v in state.items()}

    # -- the two uses ---------------------------------------------------------

    def _phases(self, depth, mask, points, point_mask, phases):
        depth = self.preprocess(depth, mask) if mask is not None else depth
        if phases is None:
            phases = self.plan(depth)
        return depth, phases, [self.view(depth, f, roi, points, point_mask)
                               for f, _, roi in phases]

    def run(self, state0, depth, mask=None, points=None, point_mask=None,
            phases=None):
        """The free-running estimate from ``state0`` (``(B, ...)``; None:
        the init network's, which needs ``mask`` and ``state0`` replaced by
        the uniforms ``(P,)`` under the key ``"uniforms"``).  Returns
        ``(final state, log)``, the log's states ``(T, B, ...)`` and
        losses ``(T, B)``."""
        depth, phases, views = self._phases(depth, mask, points, point_mask,
                                            phases)
        state = (self.init(depth, state0["uniforms"])
                 if "uniforms" in state0 else dict(state0))
        log = {k: [] for k in (*STATE_KEYS, "loss")}
        for (f, n, roi), view in zip(phases, views):
            moments = self._zero_moments(state)
            for it in range(n):
                state, moments, loss = self.step(view, state, moments, it + 1)
                log["loss"].append(loss)
                for k in STATE_KEYS:
                    log[k].append(state[k])
        return state, {k: torch.stack(v) for k, v in log.items()}

    def follow(self, depth, log, answer, mask=None, uniforms=None,
               start=None, points=None, point_mask=None, phases=None):
        """Check a program's estimate iteration by iteration.

        ``log`` holds the program's states after each iteration ``(T, B,
        ...)`` and its losses ``(T, B)``; ``answer`` the states it returned
        ``(B, ...)``, which stand in for the log's last row.  The start is
        the init network's on ``uniforms`` (with ``mask``) or ``start``.
        Returns the worst ``step_gap`` (the distance between the program's
        state after an iteration and the reference's, in units of that
        variable's nominal Adam step, ``lr * sqrt(dim)``) and ``loss_gap``
        (the relative gap of the losses), with the iteration of each."""
        depth, phases, views = self._phases(depth, mask, points, point_mask,
                                            phases)
        state = self.init(depth, uniforms) if start is None else {
            k: v.to(torch.float32) for k, v in start.items()}
        n_total = sum(n for _, n, _ in phases)
        if log["loss"].shape[0] != n_total:
            return {"step_gap": float("inf"), "loss_gap": float("inf"),
                    "step_at": -1, "loss_at": -1}
        worst = {"step_gap": 0.0, "loss_gap": 0.0, "step_at": 0,
                 "loss_at": 0, "step_key": ""}
        t = 0
        for (f, n, roi), view in zip(phases, views):
            moments = self._zero_moments(state)
            for it in range(n):
                ref, moments, loss = self.step(view, state, moments, it + 1)
                prog = ({k: answer[k] for k in STATE_KEYS}
                        if t == n_total - 1 else
                        {k: log[k][t] for k in STATE_KEYS})
                for k in STATE_KEYS:
                    unit = self.lrs[k] * ref[k][0].numel() ** 0.5
                    gap = float(torch.max(torch.linalg.norm(
                        (prog[k] - ref[k]).reshape(ref[k].shape[0], -1),
                        dim=-1))) / unit
                    if not gap <= worst["step_gap"]:
                        worst.update(step_gap=gap, step_at=t, step_key=k)
                lg = float(torch.max(torch.abs(log["loss"][t] - loss)
                                     / torch.clamp(torch.abs(loss),
                                                   min=1e-12)))
                if not lg <= worst["loss_gap"]:
                    worst["loss_gap"], worst["loss_at"] = lg, t
                state = {k: v.to(torch.float32) for k, v in prog.items()}
                t += 1
        return worst


def _roi(config: Dict, spans, factor: int) -> Optional[Tuple[int, int]]:
    """The ROI ``(Hr, Wr)`` of views with bbox spans at stride ``factor``:
    ``roi_size: auto`` tries a quarter- then a half-frame crop, each side
    a multiple of 16, with ``roi_margin`` around the spans; None: full
    frame."""
    roi_cfg = config.get("roi_size")
    if not roi_cfg:
        return None
    camera = config["camera"]
    h, w = camera["height"] // factor, camera["width"] // factor
    margin = -(-int(config.get("roi_margin", 48)) // factor)
    if roi_cfg == "auto":
        candidates = [(_align(h / 4), _align(w / 4)),
                      (_align(h / 2), _align(w / 2))]
    else:
        candidates = [(_align(roi_cfg[0] / factor),
                       _align(roi_cfg[1] / factor))]
    for rh, rw in candidates:
        if rh <= h and rw <= w and all(
                sy + 2 * margin <= rh and sx + 2 * margin <= rw
                for sy, sx in spans):
            return (rh, rw)
    return None


def _levels(config: Dict):
    """The coarse levels ``[(factor, iterations), ...]``: ``auto`` gives
    a schedule 80% of the budget split evenly (one level: 60%)."""
    f_cfg = config.get("multires_factor", 1) or 1
    n_cfg = config.get("multires_iterations", 0)
    schedule = isinstance(f_cfg, (list, tuple))
    factors = [int(f) for f in (f_cfg if schedule else [f_cfg])]
    total = int(config["max_iterations"])
    if n_cfg == "auto":
        iters = ([(total * 4) // (5 * len(factors))] * len(factors)
                 if schedule else [(total * 3) // 5])
    elif isinstance(n_cfg, (list, tuple)):
        iters = [int(n) for n in n_cfg]
    else:
        iters = [int(n_cfg or 0)]
    h, w = config["camera"]["height"], config["camera"]["width"]
    levels = [(f, n) for f, n in zip(factors, iters)
              if f > 1 and n > 0 and not (h % f or w % f)]
    if not schedule and levels:
        f, n = levels[0]
        n = min(n, total - 1)
        levels = [(f, n)] if n > 0 else []
    return levels


def plan(config: Dict, depth) -> List[Tuple[int, int, Optional[Tuple]]]:
    """The phases ``(factor, iterations, roi)`` of a preprocessed view
    ``(H, W)``: the coarse levels, then full resolution."""
    seen = depth > 0
    rows, cols = torch.any(seen, dim=-1), torch.any(seen, dim=-2)

    def span(b):
        idx = torch.nonzero(b)[:, 0]
        return int(idx.max() - idx.min() + 1) if len(idx) else 0

    sy, sx = span(rows), span(cols)
    phases, done = [], 0
    for f, n in _levels(config):
        phases.append((f, n, _roi(config,
                                  [((sy - 1) // f + 1, (sx - 1) // f + 1)],
                                  f)))
        done += n
    phases.append((1, int(config["max_iterations"]) - done,
                   _roi(config, [(sy, sx)], 1)))
    return phases
