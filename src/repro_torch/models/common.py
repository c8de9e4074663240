"""Shared neural-net building blocks on PyTorch tensors.

Counterpart of ``repro.models.common`` for one card.  Conventions kept
from the reference:

  * params are nested dicts of tensors; block params are stacked along a
    leading layer axis (``transformer`` loops over it);
  * activations default to bfloat16, norm and softmax math in float32;
  * layouts at every function are the reference's: activations
    ``[B, S, H, hd]``, weights ``[in, out]`` applied as ``x @ w``.

``remat_wrap`` is ``torch.utils.checkpoint`` for the ``"full"`` policy.
``maybe_shard`` and ``cross_attention`` have no counterpart yet (sharding
and the encoder-decoder family come in later slices), nor has the
``shard_map`` branch of ``_flash_bshd``: on one card the kernel always
runs on the whole ``[B*H, S, hd]`` block.  Nothing on the training path
writes in place into a tensor that autograd saved; ``write_kv``'s
in-place cache write serves decode only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops

NEG_INF = -1e30  # the reference's masked-score value


def remat_wrap(fn, cfg):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint`` in the reference), for
    ``cfg.remat_policy == "full"``: ``torch.utils.checkpoint`` without
    reentrance, so the recompute runs the same flash forward again.
    The ``"dots"`` policy, which no config uses, raises."""
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not ported (only 'full'); "
            "ROADMAP Queue 1 item 10")

    def wrapped(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return wrapped


def truncated_normal(gen: torch.Generator, shape, dtype: torch.dtype,
                     scale: float) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, drawn in
    float32 on the CPU from ``gen`` and cast to ``dtype``."""
    x = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, *, scale: float | None = None
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return truncated_normal(gen, (in_dim, out_dim), dtype, scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, dtype: torch.dtype) -> dict:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype)}
    if kind == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype),
                "b": torch.zeros((d,), dtype=dtype)}
    if kind == "nonparam_ln":  # OLMo: LayerNorm without affine params
        return {}
    raise ValueError(kind)


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * params["w"].float()).to(x.dtype)
    mean = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, -1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["w"].float() + params["b"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    ang = positions[..., :, None, None].float() * freqs       # [..., S,1,hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, dtype: torch.dtype) -> dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype,
                         scale=1.0 / math.sqrt(n_heads * head_dim)),
    }


def _sdpa(q, k, v, mask, *, grouped: bool = False) -> torch.Tensor:
    """q: [B,S,H,hd]; k/v: [B,T,Hkv,hd]; mask: [B?,1,S,T] bool.

    ``grouped=True`` contracts GQA with a grouped einsum instead of
    repeating K/V per head; the function is the same.
    """
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    if rep > 1 and grouped:
        qg = q.reshape(b, s, hkv, rep, hd)
        scores = torch.einsum("bsgrd,btgd->bgrst", qg, k).float()
        scores = scores.reshape(b, h, s, -1) / math.sqrt(hd)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        pg = probs.reshape(b, hkv, rep, s, -1)
        out = torch.einsum("bgrst,btgd->bsgrd", pg, v)
        return out.reshape(b, s, h, hd)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = torch.where(mask, scores / math.sqrt(hd), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _sdpa_chunked(q, k, v, *, window: int, chunk: int) -> torch.Tensor:
    """Query-chunked causal attention: the function of :func:`_sdpa` with a
    causal (optionally sliding-window) mask, with the live score tensor
    bounded to [B, H, chunk, T].  (The reference's ``unroll`` switch only
    chooses how XLA sees the loop; here it is always a Python loop.)"""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    if h // hkv > 1:
        k = torch.repeat_interleave(k, h // hkv, dim=2)
        v = torch.repeat_interleave(v, h // hkv, dim=2)
    kpos = torch.arange(s, device=q.device)[None, :]
    outs = []
    for i in range(s // chunk):
        qc = q[:, i * chunk:(i + 1) * chunk]
        qpos = i * chunk + torch.arange(chunk, device=q.device)[:, None]
        m = kpos <= qpos
        if window > 0:
            m &= kpos > qpos - window
        sc = torch.einsum("bshd,bthd->bhst", qc, k).float() / math.sqrt(hd)
        sc = torch.where(m[None, None], sc, NEG_INF)
        pr = torch.softmax(sc, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", pr, v))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: int, window: int = 0, device=None) -> torch.Tensor:
    """[1,1,S,T] causal (optionally sliding-window) mask; t >= s offsets."""
    qpos = torch.arange(s, device=device)[:, None] + (t - s)
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


def _flash_bshd(q, k, v) -> torch.Tensor:
    """[B,S,H,hd] -> the flash kernel on [B*H, S, hd] (GQA repeated here,
    outside the kernel, as the reference does)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)

    def to_bhsd(x):
        return x.movedim(2, 1).reshape(b * h, s, x.shape[-1]).contiguous()

    out = kops.flash_attention(to_bhsd(q), to_bhsd(k), to_bhsd(v),
                               scale=1.0 / math.sqrt(hd))
    return out.reshape(b, h, s, -1).movedim(1, 2)


def write_kv(kv_cache: dict, k: torch.Tensor, v: torch.Tensor,
             cache_pos: int) -> dict:
    """Write K/V [B, s, Hkv, hd] at ``cache_pos`` of a layer's cache
    {'k','v'} [B, T, Hkv, hd], **in place** (the reference returns an
    updated copy).  Raises unless ``cache_pos + s <= T``: the reference's
    ``dynamic_update_slice`` would silently clamp the start instead."""
    s, t = k.shape[1], kv_cache["k"].shape[1]
    if not 0 <= cache_pos <= t - s:
        raise ValueError(f"cache position {cache_pos} + {s} new tokens "
                         f"exceeds the cache length {t}")
    kv_cache["k"][:, cache_pos:cache_pos + s] = k.to(kv_cache["k"].dtype)
    kv_cache["v"][:, cache_pos:cache_pos + s] = v.to(kv_cache["v"].dtype)
    return kv_cache


def attention(params, x, positions, *, n_heads, n_kv, head_dim,
              rope_theta=1e4, window=0, kv_cache=None, cache_pos=None,
              chunk_q=0, attn_impl="xla", grouped=False):
    """Self-attention.  With ``kv_cache`` = {'k','v'} [B, T, n_kv, hd] it
    runs a decode step: writes K/V at ``cache_pos`` (in place, see
    :func:`write_kv`) and attends over positions <= cache_pos + s - 1."""
    b, s, d = x.shape
    q = (x @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, n_kv, head_dim)
    v = (x @ params["wv"]).reshape(b, s, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if kv_cache is None:
        if attn_impl == "flash" and window == 0 and s >= 128:
            out = _flash_bshd(q, k, v)
        elif chunk_q > 0 and s % chunk_q == 0 and s > chunk_q:
            out = _sdpa_chunked(q, k, v, window=window, chunk=chunk_q)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, window, x.device),
                        grouped=grouped)
        new_cache = None
    else:
        new_cache = write_kv(kv_cache, k, v, cache_pos)
        t = kv_cache["k"].shape[1]
        kpos = torch.arange(t, device=x.device)[None, :]
        valid = kpos <= (cache_pos + s - 1)     # decode chunks use s == 1
        if window > 0:
            valid &= kpos > (cache_pos + s - 1 - window)
        out = _sdpa(q, new_cache["k"].to(q.dtype), new_cache["v"].to(q.dtype),
                    valid[None, None], grouped=grouped)
    out = out.reshape(b, s, n_heads * head_dim) @ params["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    """SiLU-gated MLP (the reference's ``gated=True``, the only form the
    dense family uses)."""
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype,
                                 scale=1.0 / math.sqrt(d_ff)),
            "w_gate": dense_init(gen, d_model, d_ff, dtype)}


def mlp(params, x) -> torch.Tensor:
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d_model: int,
               dtype: torch.dtype, *, tie: bool = True) -> dict:
    p = {"tok": truncated_normal(gen, (vocab, d_model), dtype, 0.02)}
    if not tie:
        p["head"] = dense_init(gen, d_model, vocab, dtype)
    return p


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tok"].T


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple
