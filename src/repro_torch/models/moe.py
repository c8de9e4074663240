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

Shared experts (deepseek-v2) run densely on every token.  The port's own
settings (:class:`repro_torch.models.model.PortConfig`, read through
:func:`repro_torch.models.common.setting`) add DeepSeek-V2's published
layer: group-limited greedy routing, top-k weights left unnormalised and
scaled, and a layer told which experts it holds -- it routes over all of
them, keeps the choices of its own, and computes their part of the
result (a chip's share under expert parallelism; on one card there is no
exchange).  At their defaults the path launches the same kernels as a
plain ``ModelConfig``'s.  Spans (:mod:`repro_torch.tracing`):
``moe.route`` (router, group selection, dispatch into the buffer),
``moe.experts`` (the held experts' products and the combine),
``moe.shared``.  The reference's
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

from repro_torch import tracing

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
    """The router over all ``moe_num_experts``; the weights of the
    experts held ([held, ...])."""
    e, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    held = cm.experts_held(cfg)
    p = {
        "router": cm.dense_init(gen, d, e, torch.float32).to(device),
        "w_gate": _experts(gen, held, d, f, cfg.dtype, device),  # [E, D, F]
        "w_up": _experts(gen, held, d, f, cfg.dtype, device),    # [E, D, F]
        "w_down": _experts(gen, held, f, d, cfg.dtype, device),  # [E, F, D]
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
    """Slots per expert for ``n`` tokens: ``int(cf * n * k / E) + 1``, E
    the experts routed over (held or not: each held expert gets the slots
    it would get in the deployment), and
    ``n`` for decode-sized batches (n <= 64), where every token is
    guaranteed its slots so single-token routing matches prefill."""
    if n <= 64:
        return n
    return int(cfg.moe_capacity_factor * n * cfg.moe_top_k
               / cfg.moe_num_experts) + 1


def route(p, xf: torch.Tensor, cfg):
    """Router of [N, D] tokens: (top-k weights [N, k] float32; top-k
    expert ids [N, k]; router probabilities [N, E] float32).

    With ``moe_n_group`` > 1 the top-k is taken among the experts of the
    ``moe_topk_group`` groups whose best probability is highest (ties to
    the lower group, then the lower expert).  The weights are the
    probabilities, renormalised to sum 1 where ``moe_norm_topk``, else
    times ``moe_routed_scale``."""
    k = cfg.moe_top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)     # [N, E]
    groups = cm.setting(cfg, "moe_n_group")
    kept = cm.setting(cfg, "moe_topk_group")
    scores = probs
    if kept < groups:
        best = probs.reshape(probs.shape[0], groups, -1).amax(-1)
        top_g = torch.sort(best, dim=-1, descending=True,
                           stable=True)[1][:, :kept]
        mask = torch.zeros_like(best, dtype=torch.bool).scatter_(1, top_g,
                                                                 True)
        scores = probs.masked_fill(
            ~mask.repeat_interleave(probs.shape[1] // groups, dim=1), 0.0)
    top_w, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    if cm.setting(cfg, "moe_norm_topk"):
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    else:
        top_w = top_w * cm.setting(cfg, "moe_routed_scale")
    return top_w, top_e, probs


def dispatch(top_e: torch.Tensor, cfg, n: int):
    """The sort-based dispatch of the [N, k] choices: (order [N*k], the
    stable argsort of the flat expert ids; slot [N*k] in [0, held*C), the
    buffer row of each sorted pair; keep [N*k], whether it is an expert
    held here and fits)."""
    e, cap = cm.experts_held(cfg), capacity(cfg, n)
    flat_e = top_e.reshape(-1)
    if e < cfg.moe_num_experts:
        # local ids; every choice of an expert not held sorts last, as e
        first = cm.setting(cfg, "moe_expert_first")
        flat_e = flat_e - first
        flat_e = torch.where((flat_e >= 0) & (flat_e < e), flat_e, e)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ranks = _ranks_in_expert(sorted_e)
    keep = ranks < cap
    if e < cfg.moe_num_experts:
        keep &= sorted_e < e
    slot = torch.where(keep, sorted_e * cap + ranks, e * cap)  # overflow bin
    return order, slot, keep


def moe_block(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]."""
    b, s, d = x.shape
    n, e, k = b * s, cm.experts_held(cfg), cfg.moe_top_k
    cap = capacity(cfg, n)
    xf = x.reshape(n, d)
    with tracing.span("moe.route"):
        top_w, top_e, _ = route(p, xf, cfg)
        order, slot, keep = dispatch(top_e, cfg, n)
        tok = order // k                               # token of each pair

        buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
        buf[slot[keep]] = xf[tok[keep]]                # rows are distinct
        buf = buf.reshape(e, cap, d)
    with tracing.span("moe.experts"):
        if cfg.moe_ep_shard:
            buf = cm.maybe_shard(buf, "model", None, None)  # EP over experts
        gate = F.silu(torch.bmm(buf, p["w_gate"]))
        up = torch.bmm(buf, p["w_up"])
        out = torch.bmm(gate * up, p["w_down"])        # [E, C, D]
        if cfg.moe_ep_shard:
            out = cm.maybe_shard(out, "model", None, None)
        out = out.reshape(e * cap, d)

        rows = torch.where(keep[:, None],
                           out[torch.clamp(slot, max=e * cap - 1)], 0)
        w_sorted = top_w.reshape(-1)[order].to(x.dtype)
        contrib = rows * w_sorted[:, None]             # [N*k, D], sorted
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n * k, device=x.device)
        y = contrib[inv].reshape(n, k, d).sum(1)       # fixed order, no atomics
    if "shared" in p:
        with tracing.span("moe.shared"):
            y = y + cm.mlp(p["shared"], xf)
    return y.reshape(b, s, d)
