"""AdamW with global-norm clipping over a tree of tensors.

Counterpart of ``repro.optim.adamw``: the same state ``{"m", "v",
"step"}`` (``m``, ``v`` float32 trees mirroring the params, ``step`` an
int32 scalar), the same order of operations, and the same leaf order in
the global norm.  ``apply`` returns new trees and leaves its inputs as
they were, and is the span ``adamw.apply``.  ``schedule`` is any step ->
lr callable from :mod:`repro_torch.optim.schedules`.

Two paths, chosen by the device alone.  A CUDA tree takes the
hand-written kernel of :mod:`repro_torch.kernels.adamw` (one norm pass and
one update pass a leaf; the same p, m and v bit for bit, given the same
clip scale), whose wrappers raise on a leaf it does not take (a
``DTensor``, p neither bfloat16 nor float32, g not of p's dtype, m or v
not float32 of p's shape), so a step on the card never leaves the kernel
unseen.  Every other tree -- the CPU, the dry-run's ``DTensor`` shards on
the meta device -- takes the per-leaf PyTorch code below, the kernel's
plain version.  Neither path brings a value to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import tracing
from repro_torch.kernels import adamw as kadamw
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
        t = step.float()
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        ps, gs, ms, vs = (leaves(x) for x in (params, grads, state["m"],
                                               state["v"]))
        if ps[0].is_cuda:
            dev = ps[0].device
            gnorm, scale = kadamw.global_norm(gs, self.clip_norm)
            new_p, new_m, new_v = kadamw.update(
                ps, gs, ms, vs, scale, _scalar_on(lr, dev),
                _scalar_on(bc1, dev), _scalar_on(bc2, dev), b1=self.b1,
                b2=self.b2, eps=self.eps, weight_decay=self.weight_decay)
            kadamw.count_apply("fused")
        else:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in gs))
            new_p, new_m, new_v = self._per_leaf(
                ps, gs, ms, vs, self._clip_scale(gnorm), lr, bc1, bc2)
            kadamw.count_apply("per_leaf")
        return unflatten(params, new_p), {
            "m": unflatten(params, new_m), "v": unflatten(params, new_v),
            "step": step}, {"lr": lr, "grad_norm": gnorm}

    def _clip_scale(self, gnorm: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                           max=1.0)

    def _per_leaf(self, ps, gs, ms, vs, scale, lr, bc1, bc2):
        """New ``(ps, ms, vs)`` leaf by leaf in PyTorch ops: the fused
        kernel's plain version, in the order it follows."""
        def upd(p, g, m, v):
            g = g.float() * scale
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = [upd(*leaf) for leaf in zip(ps, gs, ms, vs)]
        return tuple([o[i] for o in out] for i in range(3))


def _scalar_on(x, device: torch.device) -> torch.Tensor:
    """``x`` (a number or a tensor of one element) as a float32 tensor on
    ``device``, without a copy where it already is one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)
