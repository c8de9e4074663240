"""The port's ``ModelConfig`` of a pre-norm attention LM with optional
experts (``moe``) and patch embeddings (``vlm``), as the configuration
file's widths give it, and the rule of its norm leaves (``ln*``)."""
from __future__ import annotations

import torch

from bench.reference.lm import as_run

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


def is_norm_leaf(path: str, shape: tuple) -> bool:
    """A norm weight: a leaf of at most two dimensions under an ``ln*``
    group (``blocks/ln1/w``, ``ln_f/w``)."""
    return len(shape) <= 2 and path.split("/")[-2].startswith("ln")
