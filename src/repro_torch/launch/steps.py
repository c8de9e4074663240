"""Step-function builders shared by the launcher, the engine and tests.

Counterpart of ``repro.launch.steps`` for serving: ``make_prefill_step``
and ``make_serve_step``.  ``make_train_step`` and ``default_optimizer``
wait for the training slice (ROADMAP Queue 1 item 10).  Each builder
resolves its device once (``"cuda"`` by default; raises without a card)
and moves the batch's tokens there.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _on(dev: torch.device, batch: dict) -> dict:
    return {**batch, "tokens": torch.as_tensor(batch["tokens"], device=dev)}


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
