"""Recurrent families: xLSTM (sLSTM + mLSTM blocks) and Mamba2 (SSD).

Counterpart of ``repro.models.ssm``.  Every recurrence runs token by token
with explicit, exponentially stabilised gates (log-space max-stabiliser
m_t), so one step is also the decode step, with O(1) state.

State conventions (per layer, stacked [L, ...] like the transformer blocks):
  mLSTM: C [B,H,hd,hd] matrix memory, n [B,H,hd] normaliser, m [B,H]
         stabiliser (starts at -1e30, so the first forget term is
         exp(-1e30 - m_new) = 0, never NaN)
  sLSTM: c/n/m/h [B,H,hd]; n starts at 1
  mamba2: h [B,H,P,N] state, conv tail [B,d_conv-1,conv_dim]

Cast points are the reference's: projections in ``cfg.dtype``, gates and
state in float32.  ``F.softplus`` returns x itself above its threshold of
20, where the reference's softplus returns x + log1p(exp(-x)); in float32
those differ by under one ulp of x.

The reference computes both branches of an xLSTM block and keeps one with
``jnp.where``; here only the layer's own branch runs and the other state
passes through unchanged, which gives the same outputs and states.  The
sequence forms (:func:`xlstm_scan_tokens`, :func:`mamba2_sequence`) apply
the per-token input projections, and Mamba2's causal conv, to the whole
sequence at once -- the same function to rounding -- and keep only the
state update in the time loop.  The decode steps are the single-token
forms and write the new state into the state they are given.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import common as cm


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg, device: torch.device) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    p = {name: cm.dense_init(gen, d, width, cfg.dtype)
         for name, width in (("wq", d), ("wk", d), ("wv", d), ("w_i", h),
                             ("w_f", h), ("w_o", d), ("w_out", d))}
    p["ln"] = cm.init_norm(d, "rmsnorm", cfg.dtype)
    return cm.to_device(p, device)


def mlstm_state(cfg, batch: int, device: torch.device) -> dict:
    h = cfg.num_heads
    hd = cfg.d_model // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), -1e30, **f32)}


def _mlstm_gates(p, x, cfg):
    """The mLSTM's input projections of x [..., D] in float32: q and k
    scaled by 1/sqrt(hd), v, log_i, log_f [..., H] and o [..., D]."""
    h = cfg.num_heads
    hd = cfg.d_model // h
    heads = x.shape[:-1] + (h, hd)
    return {"q": (x @ p["wq"]).reshape(heads).float() / math.sqrt(hd),
            "k": (x @ p["wk"]).reshape(heads).float() / math.sqrt(hd),
            "v": (x @ p["wv"]).reshape(heads).float(),
            "log_i": (x @ p["w_i"]).float(),
            "log_f": F.logsigmoid((x @ p["w_f"]).float()),
            "o": torch.sigmoid((x @ p["w_o"]).float())}


def _mlstm_update(state, g):
    """One token's memory update from its gates (each [B, H, ...]);
    returns (new state, h_t [B, H, hd])."""
    m_new = torch.maximum(g["log_f"] + state["m"], g["log_i"])
    i_s = torch.exp(g["log_i"] - m_new)
    f_s = torch.exp(g["log_f"] + state["m"] - m_new)
    C = f_s[..., None, None] * state["C"] + i_s[..., None, None] * (
        g["v"][..., :, None] * g["k"][..., None, :])         # [B,H,hd,hd]
    n = f_s[..., None] * state["n"] + i_s[..., None] * g["k"]
    num = (C @ g["q"][..., None])[..., 0]                    # [B,H,hd]
    den = torch.clamp((n * g["q"]).sum(-1).abs(), min=1.0)
    return {"C": C, "n": n, "m": m_new}, num / den[..., None]


def _mlstm_step(p, state, x_t, cfg):
    """x_t: [B, D] -> (new_state, out [B, D])."""
    g = _mlstm_gates(p, x_t, cfg)
    state, h_t = _mlstm_update(state, g)
    out = (g["o"] * h_t.flatten(1)).to(cfg.dtype) @ p["w_out"]
    return state, out


def _mlstm_sequence(p, state, x, cfg):
    """x: [B, S, D] -> (final state, out [B, S, D])."""
    g = _mlstm_gates(p, x, cfg)
    hs = []
    for t in range(x.shape[1]):
        state, h_t = _mlstm_update(state, {k: v[:, t] for k, v in g.items()
                                           if k != "o"})
        hs.append(h_t)
    h_seq = torch.stack(hs, 1).flatten(2)
    return state, (g["o"] * h_seq).to(cfg.dtype) @ p["w_out"]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg, device: torch.device) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    p = {"w_in": cm.dense_init(gen, d, 4 * d, cfg.dtype),  # i, f, z, o
         "r": cm.truncated_normal(gen, (h, hd, 4 * hd), cfg.dtype,
                                  1.0 / math.sqrt(hd)),    # block-diagonal
         "w_out": cm.dense_init(gen, d, d, cfg.dtype),
         "ln": cm.init_norm(d, "rmsnorm", cfg.dtype)}
    return cm.to_device(p, device)


def slstm_state(cfg, batch: int, device: torch.device) -> dict:
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.ones(shape, **f32),
            "m": torch.zeros(shape, **f32), "h": torch.zeros(shape, **f32)}


def _slstm_pre(p, x, cfg):
    """The input pre-activations [..., H, 4 hd] in float32."""
    h = cfg.num_heads
    return (x @ p["w_in"]).reshape(
        x.shape[:-1] + (h, 4 * (cfg.d_model // h))).float()


def _slstm_update(state, pre, r):
    """One token: pre [B, H, 4 hd] plus the recurrent term through r
    [H, hd, 4 hd] (float32) -> new state (its "h" is h_t)."""
    pre = pre + torch.einsum("bhi,hij->bhj", state["h"], r)
    log_i, log_f_raw, z_raw, o_raw = torch.chunk(pre, 4, dim=-1)
    log_f = F.logsigmoid(log_f_raw)
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(z_raw)
    n = f_s * state["n"] + i_s
    h_t = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "m": m_new, "h": h_t}


def _slstm_step(p, state, x_t, cfg):
    state = _slstm_update(state, _slstm_pre(p, x_t, cfg), p["r"].float())
    return state, state["h"].flatten(1).to(cfg.dtype) @ p["w_out"]


def _slstm_sequence(p, state, x, cfg):
    pre = _slstm_pre(p, x, cfg)
    r = p["r"].float()
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_update(state, pre[:, t], r)
        hs.append(state["h"])
    h_seq = torch.stack(hs, 1).flatten(2)
    return state, h_seq.to(cfg.dtype) @ p["w_out"]


# ---------------------------------------------------------------------------
# xLSTM model (alternating mLSTM / sLSTM blocks)
# ---------------------------------------------------------------------------

def xlstm_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """Every block carries both parameter sets, as in the reference (one
    param structure across layers); even layers run the mLSTM, odd layers
    the sLSTM."""
    def block():
        return {"m": init_mlstm(gen, cfg, device),
                "s": init_slstm(gen, cfg, device),
                "ln": cm.to_device(cm.init_norm(cfg.d_model, "rmsnorm",
                                                cfg.dtype), device)}

    blocks = cm.stack_layers(cfg.num_layers, block)
    return {"blocks": blocks,
            "embed": cm.to_device(cm.init_embed(
                gen, cfg.padded_vocab, cfg.d_model, cfg.dtype), device),
            "ln_f": cm.to_device(cm.init_norm(cfg.d_model, "rmsnorm",
                                              cfg.dtype), device)}


def xlstm_state(cfg, batch: int, device: torch.device) -> dict:
    """{"m": mLSTM state, "s": sLSTM state}, each leaf stacked [L, ...]."""
    L = cfg.num_layers
    return {name: {k: v.expand((L,) + v.shape).clone()
                   for k, v in fn(cfg, batch, device).items()}
            for name, fn in (("m", mlstm_state), ("s", slstm_state))}


def _branch(i: int) -> str:
    return "m" if i % 2 == 0 else "s"                      # even = mLSTM


def xlstm_scan_tokens(cfg, params, h_seq):
    """h_seq: [B, S, D] embeddings -> ([B, S, D] outputs, final state
    stacked [L, ...]); layer-major, as the reference's scan-in-scan."""
    init = xlstm_state(cfg, h_seq.shape[0], h_seq.device)
    seq = {"m": _mlstm_sequence, "s": _slstm_sequence}
    finals = []
    for i in range(cfg.num_layers):
        p = cm.layer(params["blocks"], i)
        br = _branch(i)
        st = {name: cm.layer(init[name], i) for name in ("m", "s")}
        xn = cm.apply_norm(p["ln"], h_seq, "rmsnorm")
        st[br], out = seq[br](p[br], st[br], xn, cfg)
        finals.append(st)
        h_seq = h_seq + out
    return h_seq, {name: {k: torch.stack([f[name][k] for f in finals])
                          for k in init[name]} for name in init}


def xlstm_forward(cfg, params, tokens, *, remat=True):
    """tokens: [B, S] -> float32 logits [B, S, padded_vocab].  (The
    reference's ``remat`` flag is accepted and, as there, unused.)"""
    h = cm.embed(params["embed"], tokens).to(cfg.dtype)
    h = cm.maybe_shard(h, cfg.dp_axes, None, None)
    h, _ = xlstm_scan_tokens(cfg, params, h)
    h = cm.apply_norm(params["ln_f"], h, "rmsnorm")
    return cm.unembed(params["embed"], h).float()


def xlstm_decode_step(cfg, params, state, tokens, pos):
    """tokens: [B, 1] -> (float32 logits [B, vocab], state), the state
    updated in place."""
    x = cm.embed(params["embed"], tokens[:, 0]).to(cfg.dtype)
    x = cm.maybe_shard(x, cfg.dp_axes, None)
    step = {"m": _mlstm_step, "s": _slstm_step}
    for i in range(cfg.num_layers):
        p = cm.layer(params["blocks"], i)
        br = _branch(i)
        st_i = cm.layer(state[br], i)
        new, out = step[br](p[br], st_i,
                            cm.apply_norm(p["ln"], x, "rmsnorm"), cfg)
        for k, v in new.items():
            st_i[k].copy_(v)
        x = x + out
    x = cm.apply_norm(params["ln_f"], x, "rmsnorm")
    return cm.unembed(params["embed"], x).float(), state


# ---------------------------------------------------------------------------
# Mamba2 (SSD, scalar A per head)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg, device: torch.device) -> dict:
    """A, dt bias and the skip are float32 whatever ``cfg.dtype`` is, as in
    the reference."""
    d, h, n = cfg.d_model, cfg.num_heads, cfg.ssm_state
    inner = h * cfg.mamba_headdim
    f32 = dict(dtype=torch.float32)
    p = {"w_in": cm.dense_init(gen, d, 2 * inner + 2 * n + h, cfg.dtype),
         "conv_w": cm.truncated_normal(gen, (cfg.mamba_dconv, inner + 2 * n),
                                       cfg.dtype, 0.1),
         "a_log": torch.zeros((h,), **f32),
         "dt_bias": torch.zeros((h,), **f32),
         "d_skip": torch.ones((h,), **f32),
         "w_out": cm.dense_init(gen, inner, d, cfg.dtype),
         "ln": cm.init_norm(d, "rmsnorm", cfg.dtype)}
    return cm.to_device(p, device)


def mamba2_state(cfg, batch: int, device: torch.device) -> dict:
    h, n, p_dim = cfg.num_heads, cfg.ssm_state, cfg.mamba_headdim
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, h, p_dim, n), **f32),
            "conv": torch.zeros((batch, cfg.mamba_dconv - 1,
                                 h * p_dim + 2 * n), **f32)}


def _mamba2_split(p, x, cfg):
    """x [..., D] -> z, the pre-conv (x, B, C) in float32, dt_raw."""
    inner = cfg.num_heads * cfg.mamba_headdim
    zxbcdt = x @ p["w_in"]
    cut = 2 * inner + 2 * cfg.ssm_state
    return (zxbcdt[..., :inner], zxbcdt[..., inner:cut].float(),
            zxbcdt[..., cut:])


def _mamba2_inputs(p, xbc_c, dt_raw, cfg):
    """From the conv output [..., inner + 2N]: x_in [..., H, P], B_in and
    C_in [..., N], dt and the decay a = exp(-exp(a_log) dt) [..., H]."""
    h, n, p_dim = cfg.num_heads, cfg.ssm_state, cfg.mamba_headdim
    inner = h * p_dim
    x_in = xbc_c[..., :inner].unflatten(-1, (h, p_dim))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["a_log"]) * dt)
    return x_in, xbc_c[..., inner:inner + n], xbc_c[..., inner + n:], dt, a


def _mamba2_out(p, y, x_in, z, cfg):
    """y [..., H, P] -> the block's output [..., D]."""
    y = y + p["d_skip"][:, None] * x_in
    y = (y.flatten(-2) * F.silu(z.float())).to(cfg.dtype)
    return y @ p["w_out"]


def _mamba2_step(p, state, x_t, cfg):
    """Single-token SSD recurrence. x_t: [B, D] -> (new state, out)."""
    z, xbc, dt_raw = _mamba2_split(p, x_t, cfg)
    # causal depthwise conv over (x, B, C) with the carried tail
    conv_in = torch.cat([state["conv"], xbc[:, None, :]], 1)
    xbc_c = F.silu(torch.einsum("btc,tc->bc", conv_in, p["conv_w"].float()))
    x_in, B_in, C_in, dt, a = _mamba2_inputs(p, xbc_c, dt_raw, cfg)
    dx = dt[..., None] * x_in                                # [B, H, P]
    hs = a[..., None, None] * state["h"] + \
        dx[..., None] * B_in[:, None, None, :]
    y = (hs @ C_in[:, None, :, None])[..., 0]                # [B, H, P]
    return {"h": hs, "conv": conv_in[:, 1:]}, _mamba2_out(p, y, x_in, z, cfg)


def mamba2_sequence(p, x, cfg):
    """x: [B, S, D] from a zero state -> out [B, S, D] (the reference's
    scan of :func:`_mamba2_step` over the tokens)."""
    b, s, _ = x.shape
    z, xbc, dt_raw = _mamba2_split(p, x, cfg)
    k = cfg.mamba_dconv
    padded = F.pad(xbc, (0, 0, k - 1, 0))                    # zero tail
    windows = padded.unfold(1, k, 1)                         # [B,S,C,k]
    xbc_c = F.silu(torch.einsum("bsck,kc->bsc", windows,
                                p["conv_w"].float()))
    x_in, B_in, C_in, dt, a = _mamba2_inputs(p, xbc_c, dt_raw, cfg)
    dx = dt[..., None] * x_in                                # [B,S,H,P]
    hs = torch.zeros((b, cfg.num_heads, cfg.mamba_headdim, cfg.ssm_state),
                     dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        hs = a[:, t, :, None, None] * hs + \
            dx[:, t, ..., None] * B_in[:, t, None, None, :]
        ys.append((hs @ C_in[:, t, None, :, None])[..., 0])
    return _mamba2_out(p, torch.stack(ys, 1), x_in, z, cfg)
