"""DeepSeek-V2 (``model_type`` "deepseek_v2"): the port's ``PortConfig`` of
the configuration file, its norm leaves, and the float32 reference.

The file holds the published keys, save ``num_hidden_layers`` and
``n_routed_experts``, which give the layers and the experts held here
(``published`` has the model's), and ``deployment``, which says which
routing group this chip holds.
"""
from __future__ import annotations

import torch

from bench.reference.deepseek_v2 import Model  # noqa: F401
from bench.reference.lm import as_run

# what the port runs whatever a configuration says: a file whose value
# as run is another is refused
PORT_FIXED = {"hidden_act": "silu", "scoring_func": "softmax",
              "moe_layer_freq": 1, "attention_bias": False,
              "rms_norm_eps": 1e-6}
# YaRN as the port runs it: the published correction range, and cos/sin
# left unscaled (mscale equal to mscale_all_dim)
PORT_YARN = {"beta_fast": 32, "beta_slow": 1}
NORMS = ("q_a_norm", "kv_a_norm")


def program_config(cfg: dict):
    """The port's ``PortConfig`` of the configuration as run."""
    from repro_torch.models.model import PortConfig
    for key, value in PORT_FIXED.items():
        if as_run(cfg, key) != value:
            raise ValueError(f"the port runs {key} = {value!r}, not "
                             f"{as_run(cfg, key)!r}")
    method = as_run(cfg, "topk_method")
    if method not in ("greedy", "group_limited_greedy"):
        raise ValueError(f"no top-k method {method!r} in the port")
    yarn = as_run(cfg, "rope_scaling") or {}
    if yarn and yarn.get("type") != "yarn":
        raise ValueError(f"the port runs YaRN, not {yarn.get('type')!r}")
    for key, value in PORT_YARN.items():
        if yarn and yarn[key] != value:
            raise ValueError(f"the port runs YaRN's {key} = {value}, not "
                             f"{yarn[key]!r}")
    if yarn and yarn["mscale"] != yarn["mscale_all_dim"]:
        raise ValueError("the port runs YaRN with mscale = mscale_all_dim")
    held = cfg["n_routed_experts"]
    run = cfg["program"]
    return PortConfig(
        name=cfg["name"], family=run["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"], vocab_size=cfg["vocab_size"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        moe_num_experts=cfg["published"]["n_routed_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        moe_num_shared=cfg["n_shared_experts"],
        moe_d_ff=cfg["moe_intermediate_size"],
        moe_capacity_factor=as_run(cfg, "capacity_factor", 1.25),
        use_mla=True, kv_lora_rank=cfg["kv_lora_rank"],
        q_lora_rank=cfg["q_lora_rank"] or 0,
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
        dtype=getattr(torch, cfg["torch_dtype"]),
        remat=run["remat"], attn_impl=run["attn_impl"],
        moe_expert_first=cfg["deployment"]["expert_group"] * held,
        moe_experts_held=held,
        moe_n_group=(cfg["n_group"] if method == "group_limited_greedy"
                     else 1),
        moe_topk_group=(cfg["topk_group"] if method == "group_limited_greedy"
                        else 1),
        moe_norm_topk=as_run(cfg, "norm_topk_prob"),
        moe_routed_scale=float(as_run(cfg, "routed_scaling_factor")),
        first_dense_layers=cfg["first_k_dense_replace"],
        dense_d_ff=cfg["intermediate_size"],
        **({} if not yarn else dict(
            rope_yarn_factor=float(yarn["factor"]),
            rope_yarn_original_max=yarn["original_max_position_embeddings"],
            rope_yarn_mscale_all_dim=float(yarn["mscale_all_dim"]))))


def is_norm_leaf(path: str, shape: tuple) -> bool:
    """A norm weight: a leaf of at most two dimensions under an ``ln*``
    group or MLA's ``q_a_norm`` / ``kv_a_norm``."""
    group = path.split("/")[-2]
    return len(shape) <= 2 and (group.startswith("ln") or group in NORMS)


def flops_parts(cfg: dict, batch: int, seq: int) -> dict:
    """Model FLOPs of one causal forward over ``batch`` x ``seq`` tokens,
    by part, from the file's widths: 2 per multiply-add of each weight
    at each position; attention's two products over the causal pairs at
    (qk_nope + qk_rope, v); the routed experts at the share of the top-k
    choices that fall on the experts held (k x held / published); the
    head over the published vocabulary."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    vd, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    qr = cfg["q_lora_rank"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    tokens = batch * seq
    q_proj = d * qr + qr * h * qk if qr else d * h * qk
    proj = (q_proj + d * (r + cfg["qk_rope_head_dim"])
            + h * r * (cfg["qk_nope_head_dim"] + vd) + h * vd * d)
    pairs = seq * (seq + 1) // 2
    held_share = cfg["n_routed_experts"] / cfg["published"]["n_routed_experts"]
    expert = 3 * d * cfg["moe_intermediate_size"]
    return {
        "mla_projections": 2.0 * tokens * proj * layers,
        "mla_attention": 2.0 * batch * h * pairs * (qk + vd) * layers,
        "dense_mlp": 2.0 * tokens * 3 * d * cfg["intermediate_size"] * dense,
        "router": 2.0 * tokens * d * cfg["published"]["n_routed_experts"]
        * (layers - dense),
        "shared_experts": 2.0 * tokens * cfg["n_shared_experts"] * expert
        * (layers - dense),
        "routed_experts": 2.0 * tokens * cfg["num_experts_per_tok"]
        * held_share * expert * (layers - dense),
        "head": 2.0 * tokens * d * cfg["vocab_size"],
    }


def forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """The sum of :func:`flops_parts`."""
    return sum(flops_parts(cfg, batch, seq).values())
