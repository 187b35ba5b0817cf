"""Adam with its count on the device: the trainers' optimizer (optax's
``adam``, as the JAX trainers build it), written so that a captured CUDA
graph replays the right step.

``torch.optim.Adam`` keeps its step count on the host unless it is built
``capturable``, which refuses CPU tensors; then a replayed graph would reuse
the bias correction of its capture.  Here the count is an int32 0-d tensor
beside each parameter, and every step computes the bias corrections from
it on the parameter's device, in float64 rounded once to the parameter's
dtype (optax rounds its ``1 - decay ** count`` to the moments' dtype), then
applies optax's ``scale_by_adam`` and ``scale(-lr)`` in optax's order of
operations.  The same code runs eagerly on the CPU and inside a graph on the
card.

The state keeps ``torch.optim.Adam``'s layout (``step``, ``exp_avg``,
``exp_avg_sq`` per parameter), so a checkpoint written with either loads
into the other and a JAX training state loads through
:func:`sdfest_torch.utils.weights.load_flax_state`; :meth:`Adam.init_state`
turns a loaded state's ``step`` into the int32 device count.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import torch


class Adam(torch.optim.Optimizer):
    """Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) whose count
    lives on the parameters' device."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    def params(self) -> List[torch.nn.Parameter]:
        return [p for group in self.param_groups for p in group["params"]]

    def init_state(self) -> None:
        """Create the missing state (zero moments, count 0) and bring a
        loaded one to its parameter's device and dtype, the count to int32
        (outside any captured graph: it may read a loaded count)."""
        for p in self.params():
            st = self.state[p]
            for key in ("exp_avg", "exp_avg_sq"):
                if key not in st:
                    st[key] = torch.zeros_like(p)
                elif st[key].device != p.device or st[key].dtype != p.dtype:
                    st[key] = st[key].to(p.device, p.dtype)
            step = st.get("step")
            if step is None:
                st["step"] = torch.zeros((), dtype=torch.int32,
                                         device=p.device)
            elif step.dtype != torch.int32 or step.device != p.device:
                st["step"] = torch.full((), int(step), dtype=torch.int32,
                                        device=p.device)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor of the state (what a step writes in place)."""
        self.init_state()
        return [self.state[p][key] for p in self.params()
                for key in ("step", "exp_avg", "exp_avg_sq")]

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self.init_state()

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        """One step with ``grads`` in the order of :meth:`params` (after
        :meth:`init_state`); writes the parameters, moments and counts in
        place."""
        grads = iter(grads)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                g = next(grads)
                st = self.state[p]
                count = st["step"]
                count.add_(1)
                c = count.to(torch.float64)
                c1 = (1 - torch.pow(b1, c)).to(p.dtype)
                c2 = (1 - torch.pow(b2, c)).to(p.dtype)
                mu, nu = st["exp_avg"], st["exp_avg_sq"]
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g ** 2) + b2 * nu)
                update = (mu / c1) / (torch.sqrt(nu / c2 + 0.0) + eps)
                p.copy_(p + update * (-lr))

    @torch.no_grad()
    def step(self, closure=None):
        """``torch.optim``'s protocol: one step on the parameters'
        ``.grad`` (a parameter without one takes a zero gradient)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.init_state()
        self.update([p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params()])
        return loss
