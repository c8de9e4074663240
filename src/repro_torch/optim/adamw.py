"""AdamW with global-norm clipping over a tree of tensors.

Counterpart of ``repro.optim.adamw``: the same state ``{"m", "v",
"step"}`` (``m``, ``v`` float32 trees mirroring the params, ``step`` an
int32 scalar), the same order of operations, and the same leaf order in
the global norm.  ``apply`` returns new trees and leaves its inputs as
they were, and is the span ``adamw.apply``.  ``schedule`` is any step ->
lr callable from :mod:`repro_torch.optim.schedules`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tracing
from repro_torch.pytree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: dict) -> dict:
        def zeros(x):
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

        device = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict):
        with tracing.span("adamw.apply"):
            return self._apply(params, grads, state)

    def _apply(self, params: dict, grads: dict, state: dict):
        step = state["step"] + 1
        lr = self.schedule(step)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = step.float()

        def upd(p, g, m, v):
            g = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mhat = m / (1 - self.b1 ** t)
            vhat = v / (1 - self.b2 ** t)
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = [upd(p, g, m, v) for p, g, m, v in
               zip(leaves(params), leaves(grads), leaves(state["m"]),
                   leaves(state["v"]))]
        new_p, new_m, new_v = (unflatten(params, [o[i] for o in out])
                               for i in range(3))
        return new_p, {"m": new_m, "v": new_v, "step": step}, {
            "lr": lr, "grad_norm": gnorm}
