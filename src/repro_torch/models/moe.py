"""Mixture-of-Experts block: token-choice top-k routing, static capacity.

Counterpart of ``repro.models.moe``.  Dispatch is sort-based (no [N, E]
one-hots): flatten the (token, choice) pairs, sort them by expert id
(stably), compute within-expert ranks from segment starts, copy into a
static [E, C, D] buffer (pairs ranked at or past the capacity C are
dropped), run one batched matmul per projection, and combine each token's
k weighted expert outputs.

The combine gathers the k outputs of every token into [N, k, D] through
the inverse of the sort and sums over k: no scatter-add, so no atomics and
a fixed summation order on every device.  Top-k breaks ties toward the
lower expert index, as ``jax.lax.top_k`` does (a stable descending sort).

Shared experts (deepseek-v2) run densely on every token.  The reference's
mesh paths (``moe_local_dispatch``: the dispatch per data shard under
``shard_map``; ``moe_ep_shard``: experts sharded over 'model') have no
one-card meaning: on one card both flags run this global dispatch, which
the reference's local dispatch equals on a one-device mesh.
``moe_ep_shard`` anchors the expert buffers to 'model' through
:func:`repro_torch.models.common.maybe_shard`, which only a ``DTensor``
notices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as cm


def _experts(gen: torch.Generator, n: int, in_dim: int, out_dim: int,
             dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[n, in, out] expert weights, each drawn on the CPU and copied to
    ``device`` as it is drawn (host memory holds one expert at a time)."""
    out = torch.empty((n, in_dim, out_dim), dtype=dtype, device=device)
    for e in range(n):
        out[e] = cm.dense_init(gen, in_dim, out_dim, dtype)
    return out


def init_moe(gen: torch.Generator, cfg, device: torch.device) -> dict:
    e, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    p = {
        "router": cm.dense_init(gen, d, e, torch.float32).to(device),
        "w_gate": _experts(gen, e, d, f, cfg.dtype, device),    # [E, D, F]
        "w_up": _experts(gen, e, d, f, cfg.dtype, device),      # [E, D, F]
        "w_down": _experts(gen, e, f, d, cfg.dtype, device),    # [E, F, D]
    }
    if cfg.moe_num_shared > 0:
        p["shared"] = cm.to_device(cm.init_mlp(
            gen, d, f * cfg.moe_num_shared, cfg.dtype), device)
    return p


def _ranks_in_expert(sorted_e: torch.Tensor) -> torch.Tensor:
    """Within-segment rank for a sorted id vector (segment = equal ids)."""
    idx = torch.arange(sorted_e.shape[0], device=sorted_e.device)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - seg_start


def capacity(cfg, n: int) -> int:
    """Slots per expert for ``n`` tokens: ``int(cf * n * k / E) + 1``, and
    ``n`` for decode-sized batches (n <= 64), where every token is
    guaranteed its slots so single-token routing matches prefill."""
    if n <= 64:
        return n
    return int(cfg.moe_capacity_factor * n * cfg.moe_top_k
               / cfg.moe_num_experts) + 1


def route(p, xf: torch.Tensor, cfg):
    """Router of [N, D] tokens: (top-k weights [N, k] float32, normalised;
    top-k expert ids [N, k]; router probabilities [N, E] float32)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)     # [N, E]
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.moe_top_k], top_e[:, :cfg.moe_top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e, probs


def dispatch(top_e: torch.Tensor, cfg, n: int):
    """The sort-based dispatch of the [N, k] choices: (order [N*k], the
    stable argsort of the flat expert ids; slot [N*k] in [0, E*C), the
    buffer row of each sorted pair; keep [N*k], whether it fits)."""
    e, cap = cfg.moe_num_experts, capacity(cfg, n)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ranks = _ranks_in_expert(sorted_e)
    keep = ranks < cap
    slot = torch.where(keep, sorted_e * cap + ranks, e * cap)  # overflow bin
    return order, slot, keep


def moe_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_num_experts, cfg.moe_top_k
    cap = capacity(cfg, n)
    xf = x.reshape(n, d)
    top_w, top_e, _ = route(p, xf, cfg)
    order, slot, keep = dispatch(top_e, cfg, n)
    tok = order // k                                   # token of each pair

    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = xf[tok[keep]]                    # rows are distinct
    buf = buf.reshape(e, cap, d)
    if cfg.moe_ep_shard:
        buf = cm.maybe_shard(buf, "model", None, None)   # EP over experts
    gate = F.silu(torch.bmm(buf, p["w_gate"]))
    up = torch.bmm(buf, p["w_up"])
    out = torch.bmm(gate * up, p["w_down"])            # [E, C, D]
    if cfg.moe_ep_shard:
        out = cm.maybe_shard(out, "model", None, None)
    out = out.reshape(e * cap, d)

    rows = torch.where(keep[:, None], out[torch.clamp(slot, max=e * cap - 1)],
                       0)
    w_sorted = top_w.reshape(-1)[order].to(x.dtype)
    contrib = rows * w_sorted[:, None]                 # [N*k, D], sorted
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=x.device)
    y = contrib[inv].reshape(n, k, d).sum(1)           # fixed order, no atomics
    if "shared" in p:
        y = y + cm.mlp(p["shared"], xf)
    return y.reshape(b, s, d)
