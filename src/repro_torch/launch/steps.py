"""Step-function builders shared by the launcher, the engine and tests.

Counterpart of ``repro.launch.steps``: ``default_optimizer``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``.  Each
builder resolves its device once (``"cuda"`` by default; raises without
a card) and moves the batch's arrays there: tokens, and labels, frames,
patches and enc_out where the batch has them.
"""
from __future__ import annotations

import itertools

import torch

from repro_torch import tracing
from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import model as M
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW
from repro_torch.pytree import leaves, unflatten


ARRAY_KEYS = ("tokens", "labels", "frames", "patches", "enc_out")


def _on(dev: torch.device, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=dev) if k in ARRAY_KEYS else v
            for k, v in batch.items()}


def default_optimizer(cfg) -> AdamW:
    if "minicpm" in cfg.name:  # the WSD-schedule arch
        def sched(step):
            return schedules.wsd(step, peak_lr=1e-2, warmup_steps=2000,
                                 stable_steps=40_000, decay_steps=5_000)
    else:
        def sched(step):
            return schedules.warmup_cosine(step, peak_lr=3e-4,
                                           warmup_steps=2000,
                                           total_steps=100_000)
    return AdamW(schedule=sched)


def make_train_step(cfg, opt: AdamW | None = None, *,
                    device: str | torch.device = "cuda"):
    """``train_step(params, opt_state, batch) -> (loss, params, opt_state)``:
    the gradient of :func:`repro_torch.models.model.loss_fn` by autograd
    (through the flash backward kernels when ``cfg.attn_impl == "flash"``),
    then one :class:`AdamW` step.  The params and state passed in are left
    as they were; the returned ones are new tensors.  On ``DTensor``
    params each gradient is first laid out as its param (:func:`_sync`).
    A step is the span ``steps.train`` (its request id the step's index
    among this function's calls) over ``steps.forward``,
    ``steps.backward`` and the optimizer's ``adamw.apply``."""
    dev = resolve_device(device)
    opt = opt or default_optimizer(cfg)
    calls = itertools.count()

    def train_step(params, opt_state, batch):
        with tracing.span("steps.train", next(calls)):
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            with tracing.span("steps.forward"):
                loss = M.loss_fn(cfg, unflatten(params, flat),
                                 _on(dev, batch))
            with tracing.span("steps.backward"):
                # xLSTM blocks carry leaves that no layer reads (each
                # branch's own norm); their gradient is 0, as the
                # reference's
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
                grads = [_sync(g, p) for g, p in zip(grads, flat)]
            params, opt_state, _ = opt.apply(unflatten(params, flat),
                                             unflatten(params, list(grads)),
                                             opt_state)
            return loss.detach(), params, opt_state

    return train_step


def _sync(grad: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """The gradient sync: the identity on a plain tensor; on a
    ``DTensor``, the gradient's partial sums reduced once into its param's
    placements (an all-reduce where the param is replicated, a
    reduce-scatter where it is sharded), so that no optimizer op reduces
    them again."""
    if not cm.is_dtensor(grad):
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def make_prefill_step(cfg, *, device: str | torch.device = "cuda"):
    dev = resolve_device(device)

    def prefill_step(params, batch):
        with torch.no_grad():
            return M.prefill_logits(cfg, params, _on(dev, batch))

    return prefill_step


def make_serve_step(cfg, *, device: str | torch.device = "cuda"):
    dev = resolve_device(device)

    def serve_step(params, cache, batch):
        with torch.no_grad():
            return M.serve_step(cfg, params, cache, _on(dev, batch))

    return serve_step
