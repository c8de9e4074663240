"""Decoder-only transformer LM: the dense family.

Counterpart of ``repro.models.transformer`` for llama-style dense blocks
(smollm-135m, olmo-1b) and gemma3-style local/global sliding windows.  The
MoE and MLA blocks of the reference are not ported yet (ROADMAP Queue 1
item 12): ``repro_torch.models.model`` refuses a config that asks for
them before it reaches this module.

Blocks are stacked ``[L, ...]`` as in the reference; the reference scans
them, the port loops over layer views (``scan_layers`` computes the same
function either way).  The KV cache is updated **in place**: the
reference's ``decode_step`` returns an updated copy, the port writes into
the cache it is given and returns that same dict.
"""
from __future__ import annotations

import torch

from ..pytree import tree_map
from . import common as cm


def _block_init(gen: torch.Generator, cfg) -> dict:
    return {
        "attn": cm.init_attention(gen, cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, cfg.dtype),
        "ln1": cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
        "ln2": cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
        "mlp": cm.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
    }


def _stack(trees: list) -> dict | torch.Tensor:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked ``[L, ...]`` tree (no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """Random params drawn from ``gen`` on the CPU, then moved to
    ``device``, so a seed gives the same weights on every device."""
    blocks = _stack([_block_init(gen, cfg) for _ in range(cfg.num_layers)])
    params = {
        "blocks": blocks,
        "embed": cm.init_embed(gen, cfg.padded_vocab, cfg.d_model, cfg.dtype,
                               tie=cfg.tie_embeddings),
        "ln_f": cm.init_norm(cfg.d_model, cfg.norm, cfg.dtype),
    }
    return tree_map(lambda x: x.to(device), params)


def _layer_windows(cfg) -> list[int]:
    """Per-layer attention window (0 = full/global)."""
    if cfg.local_global_pattern <= 0:
        return [cfg.sliding_window] * cfg.num_layers
    # gemma3: (pattern-1) local layers then 1 global, repeating
    return [0 if i % cfg.local_global_pattern == cfg.local_global_pattern - 1
            else cfg.sliding_window for i in range(cfg.num_layers)]


def _block_apply(cfg, p, h, positions, window, kv_cache=None, cache_pos=None):
    x = cm.apply_norm(p["ln1"], h, cfg.norm)
    if cfg.local_global_pattern > 0:
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
            remat: bool | None = None) -> torch.Tensor:
    """tokens: [B, S] -> float32 logits [B, S, padded_vocab].

    With ``remat`` (``cfg.remat`` when None) and autograd recording, each
    block runs under :func:`repro_torch.models.common.remat_wrap`, as the
    reference wraps its scan body: the backward recomputes the block's
    activations, flash forward included.  Under ``torch.no_grad`` there is
    nothing to recompute and the blocks run plainly.  (The reference's
    ``extra_embeds`` prefix serves the vlm family, which is not ported
    yet.)"""
    remat = cfg.remat if remat is None else remat
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]

    def block(h, p, window):
        return _block_apply(cfg, p, h, positions, window)[0]

    if remat and torch.is_grad_enabled():
        block = cm.remat_wrap(block, cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        h = block(h, _layer(params["blocks"], i), window)
    h = cm.apply_norm(params["ln_f"], h, cfg.norm)
    return cm.unembed(params["embed"], h).float()


def init_cache(cfg, batch: int, max_len: int, device: torch.device) -> dict:
    """Stacked per-layer KV cache {'k','v'} [L, B, max_len, Hkv, hd]."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos: int):
    """tokens: [B, 1]; pos: int -> (float32 logits [B, vocab], cache).

    Writes this step's K/V into ``cache`` in place and returns it.
    """
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    positions = torch.full((1, 1), pos, dtype=torch.long, device=h.device)
    for i, window in enumerate(_layer_windows(cfg)):
        h, _ = _block_apply(cfg, _layer(params["blocks"], i), h, positions,
                            window, kv_cache=_layer(cache, i), cache_pos=pos)
    h = cm.apply_norm(params["ln_f"], h, cfg.norm)
    return cm.unembed(params["embed"], h[:, -1]).float(), cache
