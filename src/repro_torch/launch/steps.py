"""Step-function builders shared by the launcher, the engine and tests.

Counterpart of ``repro.launch.steps``: ``default_optimizer``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``.  Each
builder resolves its device once (``"cuda"`` by default; raises without
a card) and moves the batch's tokens (and labels) there.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW
from repro_torch.pytree import leaves, unflatten


def _on(dev: torch.device, batch: dict) -> dict:
    out = {**batch, "tokens": torch.as_tensor(batch["tokens"], device=dev)}
    if "labels" in batch:
        out["labels"] = torch.as_tensor(batch["labels"], device=dev)
    return out


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
    as they were; the returned ones are new tensors."""
    dev = resolve_device(device)
    opt = opt or default_optimizer(cfg)

    def train_step(params, opt_state, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        loss = M.loss_fn(cfg, unflatten(params, flat), _on(dev, batch))
        grads = torch.autograd.grad(loss, flat)
        params, opt_state, _ = opt.apply(unflatten(params, flat),
                                         unflatten(params, list(grads)),
                                         opt_state)
        return loss.detach(), params, opt_state

    return train_step


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
