"""Zamba2-style hybrid: Mamba2 backbone + a single shared attention block.

Counterpart of ``repro.models.hybrid``.  Every ``attn_every`` Mamba2
layers, one *shared-weight* transformer block (full attention + MLP) runs
first; each invocation is a distinct attention instance with its own KV
cache (one per group, ``[n_groups, B, T, Hkv, hd]``) over the same
params.  The Mamba2 layers stay stacked ``[L, ...]``; group g runs layers
``g * attn_every`` to ``(g + 1) * attn_every - 1``.

The shared block's attention takes the reference's default path (the
einsum softmax): the reference never passes ``attn_impl`` to it, so this
family launches no flash kernel whatever ``cfg.attn_impl`` says.
"""
from __future__ import annotations

import torch

from . import common as cm
from .ssm import _mamba2_step, init_mamba2, mamba2_sequence, mamba2_state


def _shared_block_init(gen: torch.Generator, cfg,
                       device: torch.device) -> dict:
    return cm.to_device({
        "attn": cm.init_attention(gen, cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim, cfg.dtype),
        "mlp": cm.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        "ln1": cm.init_norm(cfg.d_model, "rmsnorm", cfg.dtype),
        "ln2": cm.init_norm(cfg.d_model, "rmsnorm", cfg.dtype),
    }, device)


def init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split "
                         f"into groups of {cfg.attn_every}")
    return {
        "mamba": cm.stack_layers(cfg.num_layers,
                                 lambda: init_mamba2(gen, cfg, device)),
        "shared": _shared_block_init(gen, cfg, device),
        "embed": cm.to_device(cm.init_embed(gen, cfg.padded_vocab,
                                            cfg.d_model, cfg.dtype), device),
        "ln_f": cm.to_device(cm.init_norm(cfg.d_model, "rmsnorm", cfg.dtype),
                             device),
    }


def _shared_apply(cfg, p, h, positions, kv_cache=None, cache_pos=None):
    x = cm.apply_norm(p["ln1"], h, "rmsnorm")
    attn_out, new_cache = cm.attention(
        p["attn"], x, positions, n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        kv_cache=kv_cache, cache_pos=cache_pos)
    h = h + attn_out
    h = h + cm.mlp(p["mlp"], cm.apply_norm(p["ln2"], h, "rmsnorm"))
    return h, new_cache


def forward(cfg, params, tokens: torch.Tensor, *,
            remat: bool = True) -> torch.Tensor:
    """tokens: [B, S] -> float32 logits [B, S, padded_vocab].  With
    ``remat`` and autograd recording, each Mamba2 layer is recomputed in
    the backward, as the reference wraps its layer body."""
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]

    def layer_body(h_seq, p):
        xn = cm.apply_norm(p["ln"], h_seq, "rmsnorm")
        return h_seq + mamba2_sequence(p, xn, cfg)

    if remat and torch.is_grad_enabled():
        layer_body = cm.remat_wrap(layer_body, cfg)
    for i in range(cfg.num_layers):
        if i % cfg.attn_every == 0:
            h, _ = _shared_apply(cfg, params["shared"], h, positions)
        h = layer_body(h, cm.layer(params["mamba"], i))
    h = cm.apply_norm(params["ln_f"], h, "rmsnorm")
    return cm.unembed(params["embed"], h).float()


def init_cache(cfg, batch: int, max_len: int, device: torch.device) -> dict:
    """{"kv": {"k", "v"} [n_groups, B, max_len, Hkv, hd], "ssm": Mamba2
    state stacked [L, ...]}."""
    n_groups = cfg.num_layers // cfg.attn_every
    shape = (n_groups, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    kv = {k: torch.zeros(shape, dtype=cfg.dtype, device=device)
          for k in ("k", "v")}
    ssm = {k: v.expand((cfg.num_layers,) + v.shape).clone()
           for k, v in mamba2_state(cfg, batch, device).items()}
    return {"kv": kv, "ssm": ssm}


def decode_step(cfg, params, cache: dict, tokens: torch.Tensor, pos: int):
    """tokens: [B, 1] -> (float32 logits of the last position [B, vocab],
    cache), the cache updated in place."""
    x = cm.embed(params["embed"], tokens).to(cfg.dtype)       # [B, 1, D]
    x = cm.maybe_shard(x, cfg.dp_axes, None, None)
    positions = torch.full((1, 1), pos, dtype=torch.long, device=x.device)
    for i in range(cfg.num_layers):
        g, r = divmod(i, cfg.attn_every)
        if r == 0:
            x, _ = _shared_apply(cfg, params["shared"], x, positions,
                                 kv_cache=cm.layer(cache["kv"], g),
                                 cache_pos=pos)
        p = cm.layer(params["mamba"], i)
        st = cm.layer(cache["ssm"], i)
        new, out = _mamba2_step(p, st, cm.apply_norm(p["ln"], x[:, 0],
                                                     "rmsnorm"), cfg)
        for k, v in new.items():
            st[k].copy_(v)
        x = x + out[:, None]
    x = cm.apply_norm(params["ln_f"], x, "rmsnorm")
    return cm.unembed(params["embed"], x[:, -1]).float(), cache
