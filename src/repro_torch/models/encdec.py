"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro.models.encdec``.  The conv audio frontend is a
stub, as in the reference: precomputed frame embeddings [B, T_enc, D] go
straight into the encoder, which is bidirectional (no mask).  The decoder
is causal, without RoPE, with cross-attention to the encoder output;
decode caches the decoder's self-attention K/V (in place) and takes the
encoder states as they are.  Attention takes the reference's default
(einsum softmax) path throughout, never the flash kernel.
"""
from __future__ import annotations

import torch

from . import common as cm


def _enc_block_init(gen: torch.Generator, cfg) -> dict:
    return {
        "attn": cm.init_attention(gen, cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, cfg.dtype),
        "mlp": cm.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype,
                           gated=False),
        "ln1": cm.init_norm(cfg.d_model, "layernorm", cfg.dtype),
        "ln2": cm.init_norm(cfg.d_model, "layernorm", cfg.dtype),
    }


def _dec_block_init(gen: torch.Generator, cfg) -> dict:
    p = _enc_block_init(gen, cfg)
    p["xattn"] = cm.init_cross_attention(gen, cfg.d_model, cfg.num_heads,
                                         cfg.head_dim, cfg.dtype)
    p["ln_x"] = cm.init_norm(cfg.d_model, "layernorm", cfg.dtype)
    return p


def init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    def norm():
        return cm.to_device(cm.init_norm(cfg.d_model, "layernorm", cfg.dtype),
                            device)

    return {
        "enc": cm.stack_layers(cfg.num_layers, lambda: cm.to_device(
            _enc_block_init(gen, cfg), device)),
        "dec": cm.stack_layers(cfg.dec_layers, lambda: cm.to_device(
            _dec_block_init(gen, cfg), device)),
        "embed": cm.to_device(cm.init_embed(gen, cfg.padded_vocab,
                                            cfg.d_model, cfg.dtype), device),
        "ln_enc": norm(),
        "ln_dec": norm(),
    }


def _sinusoid(s: int, d: int, device) -> torch.Tensor:
    """[s, d] float32: sin of position / 10000^(2i/d), then cos."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _layers(cfg, body, h, stacked, n: int, remat: bool):
    """``h`` through ``body(h, p)`` for each of the ``n`` stacked layers,
    each recomputed in the backward under ``remat`` with autograd
    recording (the reference wraps its scan body)."""
    if remat and torch.is_grad_enabled():
        body = cm.remat_wrap(body, cfg)
    for i in range(n):
        h = body(h, cm.layer(stacked, i))
    return h


def encode(cfg, params, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: [B, T, D] precomputed frame embeddings -> [B, T, D] in
    ``cfg.dtype``."""
    b, t, d = frames.shape
    h = frames.to(cfg.dtype) + \
        _sinusoid(t, d, frames.device).to(cfg.dtype)[None]
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)

    def body(h, p):
        x = cm.apply_norm(p["ln1"], h, "layernorm")
        q = (x @ p["attn"]["wq"]).reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = (x @ p["attn"]["wk"]).reshape(b, t, cfg.num_kv_heads,
                                          cfg.head_dim)
        v = (x @ p["attn"]["wv"]).reshape(b, t, cfg.num_kv_heads,
                                          cfg.head_dim)
        out = cm._sdpa(q, k, v, None)
        h = h + out.reshape(b, t, -1) @ p["attn"]["wo"]
        return h + cm.mlp(p["mlp"], cm.apply_norm(p["ln2"], h, "layernorm"),
                          gated=False, act=cm.gelu_tanh)

    h = _layers(cfg, body, h, params["enc"], cfg.num_layers, remat)
    return cm.apply_norm(params["ln_enc"], h, "layernorm")


def _dec_block(cfg, p, h, enc_out, positions, kv_cache=None, cache_pos=None):
    x = cm.apply_norm(p["ln1"], h, "layernorm")
    attn_out, new_cache = cm.attention(
        p["attn"], x, positions, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, use_rope=False,
        kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + attn_out
    x = cm.apply_norm(p["ln_x"], h, "layernorm")
    h = h + cm.cross_attention(p["xattn"], x, enc_out,
                               n_heads=cfg.num_heads, head_dim=cfg.head_dim)
    h = h + cm.mlp(p["mlp"], cm.apply_norm(p["ln2"], h, "layernorm"),
                   gated=False, act=cm.gelu_tanh)
    return h, new_cache


def decode(cfg, params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """tokens: [B, S] attending to enc_out [B, T, D] -> float32 logits
    [B, S, padded_vocab]."""
    s = tokens.shape[1]
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    h = h + _sinusoid(s, cfg.d_model, h.device).to(cfg.dtype)[None]
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    positions = torch.arange(s, device=h.device)[None, :]

    def body(h, p):
        return _dec_block(cfg, p, h, enc_out, positions)[0]

    h = _layers(cfg, body, h, params["dec"], cfg.dec_layers, remat)
    h = cm.apply_norm(params["ln_dec"], h, "layernorm")
    return cm.unembed(params["embed"], h).float()


def forward(cfg, params, frames: torch.Tensor, tokens: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    return decode(cfg, params, tokens,
                  encode(cfg, params, frames, remat=remat), remat=remat)


def init_cache(cfg, batch: int, max_len: int, device: torch.device) -> dict:
    """The decoder's self-attention cache {'k','v'} [dec_layers, B,
    max_len, Hkv, hd]."""
    shape = (cfg.dec_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
            for k in ("k", "v")}


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos: int,
                enc_out: torch.Tensor):
    """tokens: [B, 1] -> (float32 logits [B, vocab], cache), the cache
    updated in place.  The position embedding is row ``pos`` of a
    sinusoid as long as the cache."""
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    table = _sinusoid(cache["k"].shape[2], cfg.d_model, h.device)
    h = h + table[pos:pos + 1].to(cfg.dtype)[None]
    positions = torch.full((1, 1), pos, dtype=torch.long, device=h.device)
    for i in range(cfg.dec_layers):
        h, _ = _dec_block(cfg, cm.layer(params["dec"], i), h, enc_out,
                          positions, kv_cache=cm.layer(cache, i),
                          cache_pos=pos)
    h = cm.apply_norm(params["ln_dec"], h, "layernorm")
    return cm.unembed(params["embed"], h[:, -1]).float(), cache
