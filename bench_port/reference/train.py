"""The reference VAE training step: the reparameterized VAE, the near/far
L2 reconstruction terms, the KLD (weighted after the warm-up), the
render-based pc loss (each input grid rendered at distance 5 from a given
orientation, the depth lifted, the reconstruction sampled there, squared
and summed) and optax's Adam, in plain PyTorch.

:func:`follow` takes the same starting weights, data set and draws as the
program's first dispatch and runs its steps; :func:`compare` turns the
program's readings and these into the numbers that decide ``correct``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.reference import models, ops, render

PC_DISTANCE = 5.0
PC_THRESHOLD = 0.01
WARM_UP_ITERATIONS = 1000


def pc_camera(config: Dict) -> ops.Camera:
    w = config.get("pc_render_width", 640)
    h = config.get("pc_render_height", 480)
    f = config.get("pc_render_f", w / 2)
    return ops.Camera(width=w, height=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
                      pixel_center=0.5)


def loss(vae: models.VAE, config: Dict, x, eps, quats, iteration: int):
    """The total loss and its terms on grids ``x (B, 1, R, R, R)``."""
    warm = iteration > WARM_UP_ITERATIONS
    recon, mean, log_var = vae(x, eps)
    l1 = torch.abs(recon - x)
    l2 = l1 ** 2
    near = torch.abs(x) < 0.1
    zero = torch.zeros((), device=x.device)
    terms = {"loss_l2_small": torch.sum(torch.where(near, l2, zero)),
             "loss_l2_large": torch.sum(torch.where(near, zero, l2)),
             "loss_l1_small": torch.sum(torch.where(near, l1, zero)),
             "loss_l1_large": torch.sum(torch.where(near, zero, l1))}
    pc_weight = config.get("pc_weight", 0.0)
    if pc_weight > 0.0:
        camera = pc_camera(config)
        b = x.shape[0]
        position = torch.tensor([0.0, 0.0, -PC_DISTANCE],
                                device=x.device).expand(b, 3)
        depth = render.render_depth(x[:, 0].contiguous(), position, quats,
                                    x.new_ones(b), camera, PC_THRESHOLD)
        points, valid = ops.lift(depth, camera)
        q = ops.q_invert(ops.q_normalize(quats))[:, None, :]
        obj = ops.q_apply(q, points - position[0])
        _, _, inside = ops.base_and_frac(obj, recon.shape[-1])
        values = ops.sample_masked(recon[:, 0], obj,
                                   torch.logical_and(inside, valid))
        terms["loss_pc"] = torch.sum(values ** 2)
    else:
        terms["loss_pc"] = zero
    terms["loss_kld"] = -0.5 * torch.sum(1 + log_var - mean ** 2
                                         - torch.exp(log_var))
    kld_weight = config.get("kld_weight", 1.0) if warm else 0.0
    total = (config.get("l2_small_weight", 1.0) * terms["loss_l2_small"]
             + config.get("l2_large_weight", 1.0) * terms["loss_l2_large"]
             + config.get("l1_small_weight", 0.0) * terms["loss_l1_small"]
             + config.get("l1_large_weight", 0.0) * terms["loss_l1_large"]
             + pc_weight * terms["loss_pc"] + kld_weight * terms["loss_kld"])
    return total, terms


class Adam:
    """optax's Adam (b1 0.9, b2 0.999, eps 1e-8), bias corrections in
    float64 rounded once."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr = params, lr
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads):
        self.count += 1
        c = torch.tensor(float(self.count), dtype=torch.float64,
                         device=self.params[0].device)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            c1 = (1 - torch.pow(0.9, c)).to(p.dtype)
            c2 = (1 - torch.pow(0.999, c)).to(p.dtype)
            mu.copy_((1 - 0.9) * g + 0.9 * mu)
            nu.copy_((1 - 0.999) * (g ** 2) + 0.999 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + 1e-8)
            p.copy_(p + update * (-self.lr))


def follow(config: Dict, weights: Dict[str, torch.Tensor], data, draws,
           tf32: bool = False, fault=None):
    """Run the steps of ``draws`` (``[(indices, eps, quats), ...]``) from
    ``weights`` on the data set ``data (N, 1, R, R, R)``.  Returns the
    losses of each step, the last step's gradients and the final
    parameters, by parameter name.  ``fault`` may alter a step: the
    planted faults of the control's checks."""
    device = data.device
    vae = models.set_tf32(models.VAE(config), tf32).to(device)
    models.load_into(vae, {k: v.clone() for k, v in weights.items()})
    names = [n for n, _ in vae.named_parameters()]
    params = [p for _, p in vae.named_parameters()]
    opt = Adam(params, config.get("learning_rate", 1e-3))
    losses, grads = [], None
    with models.precision(tf32):
        for it, (idx, eps, quats) in enumerate(draws):
            x = torch.index_select(data, 0, idx)
            if fault == "half_batch":
                h = x.shape[0] // 2
                total, _ = loss(vae, config, x[:h], eps[:h], quats[:h], it)
                total = total * (x.shape[0] / h)
            else:
                total, _ = loss(vae, config, x, eps, quats, it)
            grads = list(torch.autograd.grad(total, params,
                                             allow_unused=True,
                                             materialize_grads=True))
            if fault != "unchanged":
                opt.update(grads)
            losses.append(float(total.detach()))
    return {"losses": losses,
            "grads": {n: g.detach() for n, g in zip(names, grads)},
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}


def compare(program: Dict, ref: Dict, start: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``grad_gap`` and ``change_gap``: by the worst parameter leaf, the gap
    between the program's and the reference's norms of the last step's
    gradient and of the change from ``start``, over the reference's norm
    of that leaf or of the median leaf, whichever is larger.  Leaves whose
    reference gradient is under a thousandth of the median leaf's (a bias
    that a later normalization cancels) are left out of both.  The worst
    leaves are named under ``grad_leaf`` and ``change_leaf``."""
    lp, lr = program["losses"], ref["losses"]
    if len(lp) != len(lr):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
    g_ref = {n: float(torch.linalg.norm(g)) for n, g in ref["grads"].items()}
    med = sorted(g_ref.values())[len(g_ref) // 2]
    keep = [n for n, v in g_ref.items() if v >= 1e-3 * med]

    def worst(a: Dict[str, float], b: Dict[str, float]):
        m = sorted(b[n] for n in keep)[len(keep) // 2]
        return max((abs(a[n] - b[n]) / max(b[n], m, 1e-30), n) for n in keep)

    g_prog = {n: float(torch.linalg.norm(g))
              for n, g in program["grads"].items()}
    d_ref = {n: float(torch.linalg.norm(p - start[n]))
             for n, p in ref["params"].items()}
    d_prog = {n: float(torch.linalg.norm(p - start[n]))
              for n, p in program["params"].items()}
    grad_gap, grad_at = worst(g_prog, g_ref)
    change_gap, change_at = worst(d_prog, d_ref)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_at,
            "change_leaf": change_at}
