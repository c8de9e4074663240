"""The LM cells' program configuration and weights, both from the
configuration file: the port's ``ModelConfig`` is built from the file's
widths by the configuration's architecture module, and the weights are
drawn on the card from the seed.

An architecture is a file: ``bench/arch/<model_type>.py``, found by the
file's ``model_type`` (:func:`arch`; ``bench/arch/__init__.py`` says what it
gives).

Weights: the tree is the port's (``models.model.param_shapes``); every
leaf of one dtype and scale is a view into one buffer that one
``normal_`` call per group fills from a generator on the card.  The
file's ``init`` gives the scales: a norm weight (the architecture's rule)
is ``norm``; ``embed/tok`` has the standard deviation ``embed_std``; every
other matrix ``matrix_std``, a number or "1/sqrt(fan_in)", fan-in being
its second-to-last dimension (the rule of the port's own initialiser).
"""
from __future__ import annotations

import math

import torch

from bench import harness, traffic

# elements a normal_ call fills at most
CHUNK = 1 << 30
WEIGHT_STREAM = 10


def arch(cfg: dict):
    """The architecture module of a configuration:
    ``bench/arch/<model_type>.py``."""
    kind = cfg["model_type"]
    return harness.load_module(harness.BENCH / "arch" / f"{kind}.py",
                               f"bench_arch_{kind}")


def program_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration as run."""
    return arch(cfg).program_config(cfg)


def leaf_std(path: str, shape: tuple, cfg: dict) -> float | None:
    """The standard deviation a leaf is drawn at; None for a norm weight
    (set to the file's ``init.norm``)."""
    if arch(cfg).is_norm_leaf(path, shape):
        return None
    init = cfg["init"]
    if path == "embed/tok":
        return init["embed_std"]
    if init["matrix_std"] == "1/sqrt(fan_in)":
        return 1.0 / math.sqrt(shape[-2])
    return float(init["matrix_std"])


def make_weights(cfg: dict, prog_cfg, seed: int, device) -> dict:
    """The weight tree of ``prog_cfg`` on ``device``, drawn from ``seed``."""
    from repro_torch.models.model import param_shapes
    from repro_torch.pytree import items, unflatten
    shapes = param_shapes(prog_cfg)
    leaves = list(items(shapes))
    groups: dict = {}
    for path, meta in leaves:
        key = (meta.dtype, leaf_std(path, tuple(meta.shape), cfg))
        groups.setdefault(key, []).append((path, meta))
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.torch_seed(seed, WEIGHT_STREAM))
    out = {}
    for (dtype, std), members in groups.items():
        n = sum(m.numel() for _, m in members)
        buf = torch.empty(n, dtype=dtype, device=device)
        if std is None:
            buf.fill_(cfg["init"]["norm"])
        else:
            for i in range(0, n, CHUNK):
                buf[i:i + CHUNK].normal_(0.0, std, generator=gen)
        off = 0
        for path, meta in members:
            out[path] = buf[off:off + meta.numel()].view(meta.shape)
            off += meta.numel()
    return unflatten(shapes, [out[p] for p, _ in leaves])
