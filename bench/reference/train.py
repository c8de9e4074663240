"""Plain float32 reference of a training step: the causal-LM loss of a
reference model class that the caller passes (an architecture's ``Model``,
such as :class:`bench.reference.lm.Model`), its gradients by autograd, and
AdamW with global-norm clipping, over the benchmark's weight tree.

It imports nothing of the program.  Each step computes in float32 from
the parameters as stored, then stores them back in the configuration's
dtype (bfloat16), as a step hands them on; AdamW's moments stay float32.
AdamW as configured: b1 0.9, b2 0.95, eps 1e-8, weight decay 0.1 on
every leaf, the gradient scaled by min(1, 1 / global norm), bias
correction, and a linear warm-up into a cosine schedule (peak 3e-4 at
2,000 steps, 100,000 steps, floor 0.1 of the peak).
"""
from __future__ import annotations

import math

import torch

B1, B2, EPS, WD, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0
PEAK_LR, WARMUP, TOTAL, MIN_RATIO = 3e-4, 2000, 100_000, 0.1


def lr_at(step: int) -> float:
    if step < WARMUP:
        return PEAK_LR * step / WARMUP
    prog = min(max((step - WARMUP) / (TOTAL - WARMUP), 0.0), 1.0)
    return PEAK_LR * (MIN_RATIO + (1 - MIN_RATIO) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def items(tree: dict, prefix: str = "") -> list:
    """(path, leaf) pairs in sorted-key order."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += items(tree[key], f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", tree[key]))
    return out


def build(paths: list, leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def loss_of(model, cfg: dict, tree: dict, batch: dict, matmul: str
            ) -> torch.Tensor:
    """The mean next-token loss of the reference class ``model``."""
    logits = model(cfg, tree, matmul=matmul, remat=True).forward(
        batch["tokens"])
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, batch["labels"].long()[..., None]).mean()


def steps(cfg: dict, params: dict, batches: list, start_step: int, *,
          model, matmul: str = "float32", judge: list | None = None) -> dict:
    """Run one step a batch of the reference class ``model`` from
    ``params`` (bf16, as drawn) with the optimizer's moments at 0 and its
    step counter at ``start_step``.
    Returns each step's loss, each leaf's norm of the clipped gradient of
    the first step (and the gradient itself, on the host), and each
    leaf's norm of its change over the steps, as stored (path order).
    ``judge``, another run's first clipped gradients (host tensors in
    path order), adds each leaf's norm of their difference from this
    run's."""
    paths = [p for p, _ in items(params)]
    start = [leaf for _, leaf in items(params)]
    stored = list(start)
    m = [torch.zeros(x.shape, device=x.device) for x in start]
    v = [torch.zeros(x.shape, device=x.device) for x in start]
    losses, grad1 = [], None
    for k, batch in enumerate(batches):
        flat = [x.float().requires_grad_(True) for x in stored]
        loss = loss_of(model, cfg, build(paths, flat), batch, matmul)
        grads = torch.autograd.grad(loss, flat)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(CLIP / torch.clamp(gnorm, min=1e-9), max=1.0)
            t = start_step + k + 1
            lr = lr_at(t)
            if k == 0:
                first = [(g * scale).cpu() for g in grads]
                grad1 = [float(g.norm()) for g in first]
                diff = None if judge is None else [
                    float((g - j).norm()) for g, j in zip(first, judge)]
            new = []
            for i, (p, g) in enumerate(zip(flat, grads)):
                g = g * scale
                m[i] = B1 * m[i] + (1 - B1) * g
                v[i] = B2 * v[i] + (1 - B2) * g * g
                mhat = m[i] / (1 - B1 ** t)
                vhat = v[i] / (1 - B2 ** t)
                step = mhat / (torch.sqrt(vhat) + EPS) + WD * p
                new.append((p - lr * step).to(stored[i].dtype))
            del flat, grads
            stored = new
    with torch.no_grad():
        change = [float((a.float() - b.float()).norm())
                  for a, b in zip(stored, start)]
    return {"paths": paths, "loss": losses, "grad1": grad1, "change": change,
            "grad1_t": first, "grad1_diff": diff}
