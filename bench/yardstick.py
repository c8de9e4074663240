"""The benchmark's frozen arithmetic: the card's peaks, the flash kernels'
roofline bounds, and the model FLOP and byte counts of each cell's step.

Copied from the program's measuring scripts (``chip_smoke.flash_bound``,
``chip_smoke.flash_bwd_bound``) and kept here so that a change to the
program cannot move the yardstick.  Every count is worked out from the
configuration file's widths, never from the program's objects.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps over ``s`` positions."""
    return s * (s + 1) // 2


def flash_bound(bh, s, d, dv, dtype="bfloat16", causal=True, with_lse=True):
    """Least time in s of one flash forward: each input read once, each
    output written once; the score and P.V products over the (causal)
    pairs this input has."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = causal_pairs(s) if causal else s * s
    ops_done = 2 * bh * pairs * (d + dv)
    peak = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S
    bytes_moved = bh * s * (2 * d + 2 * dv) * item + (bh * s * 4
                                                      if with_lse else 0)
    return max(ops_done / peak, bytes_moved / PEAK_BYTES_PER_S)


def flash_bwd_bound(bh, s, d, dv, entry, dtype="bfloat16", causal=True):
    """Least time in s of one backward kernel: each input (q, k, v, do,
    lse, delta) read once, each output written once; the dq kernel does
    Q K^T, dO V^T and dS K (2 (2d + dv) FLOP a pair), the dk/dv kernel
    Q K^T, dO V^T, P^T dO and dS^T Q (2 (2d + 2dv))."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = bh * (causal_pairs(s) if causal else s * s)
    if entry == "flash_bwd_dq":
        ops_done, out_cols = 2 * pairs * (2 * d + dv), d
    else:
        ops_done, out_cols = 2 * pairs * (2 * d + 2 * dv), d + dv
    bytes_moved = (bh * s * (2 * d + 2 * dv + out_cols) * item
                   + 2 * bh * s * 4)
    peak = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S
    return max(ops_done / peak, bytes_moved / PEAK_BYTES_PER_S)


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies by in one block: the four attention
    projections and the MLP, or the router and the top-k experts."""
    d, h, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    hd = head_dim(cfg)
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.get("num_experts"):
        ffn = (d * cfg["num_experts"]
               + cfg["num_experts_per_tok"] * 3 * d * cfg["intermediate_size"])
    else:
        ffn = 3 * d * cfg["intermediate_size"]
    return attn + ffn


def forward_flops(cfg: dict, layers: int, batch: int, positions: int,
                  logit_positions: int) -> float:
    """Model FLOPs of one causal forward: 2 per multiply-add of every
    block's weights at every position, causal attention's two products
    over the kept pairs, and the LM head at the positions that get logits
    (the published vocabulary, not the padded one)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = head_dim(cfg)
    blocks = 2.0 * batch * positions * layer_matmul_params(cfg) * layers
    attn = 4.0 * batch * h * hd * causal_pairs(positions) * layers
    head = 2.0 * batch * logit_positions * d * cfg["vocab_size"]
    return blocks + attn + head
