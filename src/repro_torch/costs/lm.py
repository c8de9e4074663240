"""Per-layer (c_jl FLOPs, d_jl bytes) cost profiles for LM architectures.

Counterpart of ``repro.costs.lm``, in float64 numpy as the reference, so
the profiles (and the plans built on them) are bit-equal.  An inference
request against an architecture becomes an
:class:`~repro_torch.core.jobs.InferenceJob` whose layers are (embed,
block_1, ..., block_L, head); d_jl is the hidden state handed between
layers, c_jl counts forward FLOPs (2 per MAC).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.model import ModelConfig


def _attn_flops(cfg: ModelConfig, b: int, s: int) -> float:
    hd = cfg.head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    d = cfg.d_model
    if cfg.use_mla:
        r, qr, qk, vd = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                         cfg.qk_nope_head_dim, cfg.v_head_dim)
        proj = d * (cfg.q_lora_rank or d) + (cfg.q_lora_rank or 0) * h * (qk + qr) \
            + d * (r + qr) + r * h * (qk + vd) + h * vd * d
        score = s * h * (qk + qr) + s * h * vd
    else:
        proj = d * h * hd + 2 * d * kv * hd + h * hd * d
        score = s * h * hd * 2
    return 2.0 * b * s * (proj + score)


def _ffn_flops(cfg: ModelConfig, b: int, s: int) -> float:
    d = cfg.d_model
    if cfg.moe_num_experts > 0:
        routed = 3 * d * cfg.moe_d_ff * cfg.moe_top_k
        shared = 3 * d * cfg.moe_d_ff * cfg.moe_num_shared
        router = d * cfg.moe_num_experts
        return 2.0 * b * s * (routed + shared + router)
    if cfg.family == "ssm":
        hd = d // cfg.num_heads
        return 2.0 * b * s * (4 * d * d + cfg.num_heads * hd * hd * 3)
    if cfg.family == "hybrid":
        inner = cfg.num_heads * cfg.mamba_headdim
        return 2.0 * b * s * (d * (2 * inner + 2 * cfg.ssm_state)
                              + inner * cfg.ssm_state * 2 + inner * d)
    return 2.0 * b * s * 3 * d * cfg.d_ff


def cost_profile(cfg: ModelConfig, *, seq_len: int, batch: int = 1,
                 act_bytes: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Returns (comp [L], data [L+1]) for a b x s inference of this arch.

    Layers: embed, block_1..block_L, head => L = num_layers + 2.
    data[0] = input token ids; data[i] = hidden state between layers;
    data[-1] = predicted token ids delivered to the destination.
    """
    b, s, d = batch, seq_len, cfg.d_model
    hidden = float(b * s * d * act_bytes)
    comp = [2.0 * b * s * d]  # embedding gather + scale
    for _ in range(cfg.num_layers):
        blk = _ffn_flops(cfg, b, s)
        if cfg.family not in ("ssm",):
            blk += _attn_flops(cfg, b, s)
        comp.append(blk)
    comp.append(2.0 * b * s * d * cfg.padded_vocab)  # unembed
    data = [float(b * s * 4)] + [hidden] * (cfg.num_layers + 1) + [float(b * s * 4)]
    assert len(data) == len(comp) + 1
    return np.asarray(comp, np.float64), np.asarray(data, np.float64)
