"""The LM cells' program configuration and weights, both from the
configuration file: the port's ``ModelConfig`` is built from the file's
widths, and the weights are drawn on the card from the seed.

Weights: the tree is the port's (``models.model.param_shapes``); every
leaf of one dtype and scale is a view into one buffer that one
``normal_`` call per group fills from a generator on the card.  The
file's ``init`` gives the scales: a norm weight is ``norm``;
``embed/tok`` has the standard deviation ``embed_std``; every other
matrix ``matrix_std``, a number or "1/sqrt(fan_in)", fan-in being its
second-to-last dimension (the rule of the port's own initialiser).
"""
from __future__ import annotations

import math

import torch

from bench import traffic
from bench.reference.lm import as_run

# elements a normal_ call fills at most
CHUNK = 1 << 30
WEIGHT_STREAM = 10
# what the port runs whatever a configuration says: a file whose value
# as run is another is refused
PORT_FIXED = {"rms_norm_eps": 1e-6, "norm_topk_prob": True,
              "rope_scaling": None}


def program_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration as run."""
    from repro_torch.models.model import ModelConfig
    for key, value in PORT_FIXED.items():
        if key in cfg and as_run(cfg, key) != value:
            raise ValueError(f"the port runs {key} = {value!r}, not "
                             f"{as_run(cfg, key)!r}")
    run = cfg["program"]
    return ModelConfig(
        name=cfg["name"], family=run["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=cfg["rope_theta"],
        moe_num_experts=cfg.get("num_experts", 0),
        moe_top_k=cfg.get("num_experts_per_tok", 0),
        moe_d_ff=cfg["intermediate_size"] if cfg.get("num_experts") else 0,
        moe_capacity_factor=as_run(cfg, "capacity_factor", 1.25),
        num_patches=cfg.get("num_patches", 0),
        dtype=getattr(torch, cfg["torch_dtype"]),
        remat=run["remat"], attn_impl=run["attn_impl"])


def leaf_std(path: str, shape: tuple, cfg: dict) -> float | None:
    """The standard deviation a leaf is drawn at; None for a norm weight
    (set to the file's ``init.norm``)."""
    init = cfg["init"]
    if len(shape) <= 2 and path.split("/")[-2].startswith("ln"):
        return None
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
