"""Multi-head Latent Attention (DeepSeek-V2).

Counterpart of ``repro.models.mla``.  K/V are compressed into a
``kv_lora_rank`` latent c_kv plus a single shared RoPE key k_rope; per-head
K/V are up-projections of the latent.  Prefill materializes K/V, in one
of three forms: the flash kernel (``attn_impl == "flash"`` and S >= 128),
whose q/k width is qk_nope + qk_rope (192 at full size) against a v width
of 128 -- in bf16 :func:`repro_torch.kernels.flash.kernel_variant` sends
(192, 128) to the tensor-core kernels (the forward, dq and dk/dv), in
float32 (and at smoke widths) to the CUDA-core kernels; query chunks
(``attn_chunk_q``); or the whole score matrix.  Decode uses the *absorbed*
form: queries are pulled into the latent space (q_eff = q_nope @ W_uk per
head) so attention runs against the cached latents -- the cache is
[B, T, kv_lora + rope_dim] whatever the head count.

As in the port's dense attention, decode writes the cache **in place**
and returns that same dict (the reference returns an updated copy).
"""
from __future__ import annotations

import math

import torch

from . import common as cm


def init_mla(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """Each weight drawn on the CPU and moved to ``device`` as it is drawn."""
    d, h = cfg.d_model, cfg.num_heads
    qk, qr, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    def put(x):
        return x.to(device)

    p = {
        "w_kv_a": put(cm.dense_init(gen, d, r + qr, cfg.dtype)),
        "kv_a_norm": cm.to_device(cm.init_norm(r, "rmsnorm", cfg.dtype),
                                  device),
        "w_uk": put(cm.truncated_normal(gen, (h, r, qk), cfg.dtype,
                                        1 / math.sqrt(r))),
        "w_uv": put(cm.truncated_normal(gen, (h, r, vd), cfg.dtype,
                                        1 / math.sqrt(r))),
        "wo": put(cm.dense_init(gen, h * vd, d, cfg.dtype)),
    }
    if cfg.q_lora_rank > 0:
        p["w_q_a"] = put(cm.dense_init(gen, d, cfg.q_lora_rank, cfg.dtype))
        p["q_a_norm"] = cm.to_device(cm.init_norm(cfg.q_lora_rank,
                                                  "rmsnorm", cfg.dtype),
                                      device)
        p["w_q_b"] = put(cm.dense_init(gen, cfg.q_lora_rank, h * (qk + qr),
                                       cfg.dtype))
    else:
        p["w_q"] = put(cm.dense_init(gen, d, h * (qk + qr), cfg.dtype))
    return p


def _queries(p, x, cfg):
    b, s, _ = x.shape
    h, qk, qr = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_q_a" in p:
        q = cm.apply_norm(p["q_a_norm"], x @ p["w_q_a"], "rmsnorm") \
            @ p["w_q_b"]
    else:
        q = x @ p["w_q"]
    q = q.reshape(b, s, h, qk + qr)
    return q[..., :qk], q[..., qk:]


def _latents(p, x, cfg):
    r = cfg.kv_lora_rank
    kv = x @ p["w_kv_a"]
    c_kv = cm.apply_norm(p["kv_a_norm"], kv[..., :r], "rmsnorm")
    return c_kv, kv[..., r:]                                  # k_rope [B,S,qr]


def _softmax_probs(scores, scale, mask, dtype):
    scores = torch.where(mask, scores.float() * scale, cm.NEG_INF)
    return torch.softmax(scores, dim=-1).to(dtype)


def write_latents(kv_cache: dict, c_kv: torch.Tensor, k_rope: torch.Tensor,
                  cache_pos: int) -> dict:
    """Write this step's latents [B, s, r] and rope keys [B, s, qr] at
    ``cache_pos`` of a layer's cache {'c_kv', 'k_rope'}, in place; raises
    unless they fit (the reference's ``dynamic_update_slice`` would clamp
    the start instead)."""
    s, t = c_kv.shape[1], kv_cache["c_kv"].shape[1]
    if not 0 <= cache_pos <= t - s:
        raise ValueError(f"cache position {cache_pos} + {s} new tokens "
                         f"exceeds the cache length {t}")
    kv_cache["c_kv"][:, cache_pos:cache_pos + s] = \
        c_kv.to(kv_cache["c_kv"].dtype)
    kv_cache["k_rope"][:, cache_pos:cache_pos + s] = \
        k_rope.to(kv_cache["k_rope"].dtype)
    return kv_cache


def mla_attention(p, x, positions, cfg, *, kv_cache=None, cache_pos=None):
    b, s, _ = x.shape
    h, qk, qr, vd = (cfg.num_heads, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    scale = 1.0 / math.sqrt(qk + qr)
    q_nope, q_rope = _queries(p, x, cfg)
    q_rope = cm.apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _latents(p, x, cfg)
    k_rope = cm.apply_rope(k_rope[:, :, None], positions,
                           cfg.rope_theta)[:, :, 0]

    if kv_cache is None:
        # -- materialized form (prefill)
        k_nope = torch.einsum("btr,hrk->bthk", c_kv, p["w_uk"])
        v = torch.einsum("btr,hrk->bthk", c_kv, p["w_uv"])
        chunk = cfg.attn_chunk_q
        if cfg.attn_impl == "flash" and s >= 128:
            # fold the shared rope key into a standard attention: per head
            # K_eff = [k_nope, k_rope], Q_eff = [q_nope, q_rope]
            k_eff = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, h, qr)],
                              -1)
            q_eff = torch.cat([q_nope, q_rope], -1)
            out = cm._flash_bshd(q_eff, k_eff, v, scale=scale)
        elif chunk > 0 and s % chunk == 0 and s > chunk:
            # query-chunked: live scores bounded to [B, H, chunk, S]
            kpos = torch.arange(s, device=x.device)[None, :]
            outs = []
            for i in range(s // chunk):
                rows = slice(i * chunk, (i + 1) * chunk)
                sc = torch.einsum("bshk,bthk->bhst", q_nope[:, rows], k_nope) \
                    + torch.einsum("bshk,btk->bhst", q_rope[:, rows], k_rope)
                qpos = i * chunk + torch.arange(chunk,
                                                device=x.device)[:, None]
                pr = _softmax_probs(sc, scale, (kpos <= qpos)[None, None],
                                    x.dtype)
                outs.append(torch.einsum("bhst,bthk->bshk", pr, v))
            out = torch.cat(outs, dim=1)
        else:
            # rope term: each head has its own q_rope but all share k_rope
            scores = torch.einsum("bshk,bthk->bhst", q_nope, k_nope) + \
                torch.einsum("bshk,btk->bhst", q_rope, k_rope)
            probs = _softmax_probs(scores, scale,
                                   cm.causal_mask(s, s, device=x.device),
                                   x.dtype)
            out = torch.einsum("bhst,bthk->bshk", probs, v)
        new_cache = None
    else:
        # -- absorbed form (decode): attend in latent space
        new_cache = write_latents(kv_cache, c_kv, k_rope, cache_pos)
        cc = new_cache["c_kv"].to(x.dtype)
        cr = new_cache["k_rope"].to(x.dtype)
        t = cc.shape[1]
        q_eff = torch.einsum("bshk,hrk->bshr", q_nope, p["w_uk"])  # [B,S,H,r]
        scores = torch.einsum("bshr,btr->bhst", q_eff, cc) + \
            torch.einsum("bshk,btk->bhst", q_rope, cr)
        valid = torch.arange(t, device=x.device)[None, :] <= cache_pos + s - 1
        probs = _softmax_probs(scores, scale, valid[None, None], x.dtype)
        lat = torch.einsum("bhst,btr->bshr", probs, cc)            # [B,S,H,r]
        out = torch.einsum("bshr,hrk->bshk", lat, p["w_uv"])
    return out.reshape(b, s, h * vd) @ p["wo"], new_cache


def init_mla_cache(cfg, batch: int, max_len: int,
                   device: torch.device) -> dict:
    """Stacked latent cache {'c_kv' [L, B, T, r], 'k_rope' [L, B, T, qr]}."""
    return {
        "c_kv": torch.zeros((cfg.num_layers, batch, max_len,
                             cfg.kv_lora_rank), dtype=cfg.dtype,
                            device=device),
        "k_rope": torch.zeros((cfg.num_layers, batch, max_len,
                               cfg.qk_rope_head_dim), dtype=cfg.dtype,
                              device=device),
    }
