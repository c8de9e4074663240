"""Decoder-only transformer LM covering the dense / MoE / MLA / vlm families.

Counterpart of ``repro.models.transformer``: llama-style dense blocks
(smollm-135m, olmo-1b, minicpm-2b, and phi-3-vision's backbone behind its
patch prefix), gemma3-style local/global sliding windows, MoE blocks with
shared + routed experts (olmoe-1b-7b, deepseek-v2-236b;
:mod:`repro_torch.models.moe`) and MLA with the absorbed-form decode
(deepseek-v2; :mod:`repro_torch.models.mla`).

Blocks are stacked ``[L, ...]`` as in the reference; the reference scans
them, the port loops over layer views (``scan_layers`` computes the same
function either way).  The KV cache (the latent cache for MLA) is updated
**in place**: the reference's ``decode_step`` returns an updated copy, the
port writes into the cache it is given and returns that same dict.
"""
from __future__ import annotations

import torch

from . import common as cm
from .mla import init_mla, init_mla_cache, mla_attention
from .moe import init_moe, moe_block


def _block_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """One block's params, each weight drawn on the CPU and moved to
    ``device`` as it is drawn."""
    p = {}
    if cfg.use_mla:
        p["attn"] = init_mla(gen, cfg, device)
    else:
        p["attn"] = cm.to_device(cm.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.dtype), device)
    p["ln1"] = cm.to_device(cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
                            device)
    p["ln2"] = cm.to_device(cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
                            device)
    if cfg.moe_num_experts > 0:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["mlp"] = cm.to_device(cm.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                            cfg.dtype), device)
    return p


def init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """Random params drawn from ``gen`` on the CPU, weight by weight, each
    moved to ``device`` as it is drawn, so a seed gives the same weights
    on every device and host memory holds one weight at a time."""
    blocks = cm.stack_layers(cfg.num_layers,
                             lambda: _block_init(gen, cfg, device))
    embed = cm.init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype,
                          tie=cfg.tie_embeddings)
    return {
        "blocks": blocks,
        "embed": cm.to_device(embed, device),
        "ln_f": cm.to_device(cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
                             device),
    }


def _layer_windows(cfg) -> list[int]:
    """Per-layer attention window (0 = full/global)."""
    if cfg.local_global_pattern <= 0:
        return [cfg.sliding_window] * cfg.num_layers
    # gemma3: (pattern-1) local layers then 1 global, repeating
    return [0 if i % cfg.local_global_pattern == cfg.local_global_pattern - 1
            else cfg.sliding_window for i in range(cfg.num_layers)]


def _block_apply(cfg, p, h, positions, window, kv_cache=None, cache_pos=None):
    x = cm.apply_norm(p["ln1"], h, cfg.norm)
    if cfg.use_mla:
        attn_out, new_cache = mla_attention(p["attn"], x, positions, cfg,
                                            kv_cache=kv_cache,
                                            cache_pos=cache_pos)
    elif cfg.local_global_pattern > 0:
        attn_out, new_cache = _dyn_window_attention(
            cfg, p["attn"], x, positions, window, kv_cache, cache_pos)
    else:
        attn_out, new_cache = cm.attention(
            p["attn"], x, positions, n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, window=cfg.sliding_window,
            kv_cache=kv_cache, cache_pos=cache_pos, chunk_q=cfg.attn_chunk_q,
            attn_impl=cfg.attn_impl, grouped=cfg.gqa_grouped)
    h = h + attn_out
    x = cm.apply_norm(p["ln2"], h, cfg.norm)
    if cfg.moe_num_experts > 0:
        return h + moe_block(p["moe"], x, cfg), new_cache
    return h + cm.mlp(p["mlp"], x), new_cache


def _dyn_window_attention(cfg, p, x, positions, window, kv_cache, cache_pos):
    """Attention whose sliding window changes per layer (local/global
    pattern): keys within ``window`` of the query when window > 0,
    unrestricted otherwise."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        if cfg.attn_chunk_q > 0 and s % cfg.attn_chunk_q == 0 \
                and s > cfg.attn_chunk_q:
            out = cm._sdpa_chunked(q, k, v, window=window,
                                   chunk=cfg.attn_chunk_q)
        else:
            out = cm._sdpa(q, k, v, cm.causal_mask(s, s, window, x.device))
        new_cache = None
    else:
        new_cache = cm.write_kv(kv_cache, k, v, cache_pos)
        t = kv_cache["k"].shape[1]
        kpos = torch.arange(t, device=x.device)[None, :]
        valid = kpos <= (cache_pos + s - 1)
        if window > 0:
            valid &= kpos > cache_pos + s - 1 - window
        out = cm._sdpa(q, new_cache["k"].to(q.dtype),
                       new_cache["v"].to(q.dtype), valid[None, None],
                       grouped=cfg.gqa_grouped)
    return out.reshape(b, s, cfg.num_heads * hd) @ p["wo"], new_cache


def forward(cfg, params, tokens: torch.Tensor, *,
            extra_embeds: torch.Tensor | None = None,
            remat: bool | None = None) -> torch.Tensor:
    """tokens: [B, S] -> float32 logits [B, S, padded_vocab].

    ``extra_embeds`` [B, P, D] (the vlm family's patch stub) are put
    before the tokens in ``cfg.dtype``; positions count over P + S and the
    logits of the P patch positions are dropped.

    With ``remat`` (``cfg.remat`` when None) and autograd recording, each
    block runs under :func:`repro_torch.models.common.remat_wrap`, as the
    reference wraps its scan body: the backward recomputes the block's
    activations, flash forward included.  Under ``torch.no_grad`` there is
    nothing to recompute and the blocks run plainly."""
    remat = cfg.remat if remat is None else remat
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    n_extra = 0
    if extra_embeds is not None:
        n_extra = extra_embeds.shape[1]
        h = torch.cat([extra_embeds.to(cfg.dtype), h], dim=1)
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]

    def block(h, p, window):
        return _block_apply(cfg, p, h, positions, window)[0]

    if remat and torch.is_grad_enabled():
        block = cm.remat_wrap(block, cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        h = block(h, cm.layer(params["blocks"], i), window)
    h = cm.apply_norm(params["ln_f"], h, cfg.norm)[:, n_extra:]
    return cm.unembed(params["embed"], h).float()


def init_cache(cfg, batch: int, max_len: int, device: torch.device) -> dict:
    """Stacked per-layer KV cache {'k','v'} [L, B, max_len, Hkv, hd] (the
    latent cache {'c_kv', 'k_rope'} for MLA)."""
    if cfg.use_mla:
        return init_mla_cache(cfg, batch, max_len, device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos: int):
    """tokens: [B, 1]; pos: int -> (float32 logits [B, vocab], cache).

    Writes this step's K/V into ``cache`` in place and returns it.
    """
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    positions = torch.full((1, 1), pos, dtype=torch.long, device=h.device)
    for i, window in enumerate(_layer_windows(cfg)):
        h, _ = _block_apply(cfg, cm.layer(params["blocks"], i), h, positions,
                            window, kv_cache=cm.layer(cache, i),
                            cache_pos=pos)
    h = cm.apply_norm(params["ln_f"], h, cfg.norm)
    return cm.unembed(params["embed"], h[:, -1]).float(), cache
