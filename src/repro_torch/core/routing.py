"""Single-job optimal routing on the layered graph (constructive Theorem 1).

Counterpart of ``repro.core.routing``.  The optimum of the single-job ILP
is one s_0 -> t_L path in the layered graph, found by a layer dynamic
program over the min-plus transfer closures:

    g_0[u]  = T_0[src, u] + nw[u]
    g_l[u]  = min( g_{l-1}[u],                       # continue the run at u
                   min_v g_{l-1}[v] + T_{l-1}[v, u]  # move, charge node wait
                       + nw[u] )
              + c_l * cinv[u]
    answer  = min_u g_L[u] + T_L[u, dst]

with ``nw[u] = Q_u / mu_u`` and ``cinv[u] = 1/mu_u``.

Where the work runs.  The forward DP is vectorised over jobs and runs on
the tensors' device: the reference's ``scan`` over layers is a Python loop
and its ``vmap`` over jobs a written-out batch dimension.  The backpointer
walk and the queue commits' bookkeeping are sequential chains of scalar
integer gathers; they run on the host, on copies of the small tables.

Numerics.  Every float operation rounds as the reference's does: the DP
line ``min(g, moved) + c_l * cinv`` and the fixed-assignment segments
``T + wait + c * cinv`` round once, as the fused multiply-add XLA:CPU
contracts them into (:func:`~repro_torch.core.numerics.fma_f32`); every
other operation rounds once per PyTorch op; the commits add in the
reference's order without atomics; the cost of a fixed assignment sums its
segments sequentially in float32.  So results equal the reference's bit
for bit, on the CPU and on the GPU alike.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .network import INF, ComputeNetwork, node_invrate, node_wait
from .numerics import fma_f32
from .jobs import JobBatch
from .shortest_path import (Closures, closures_for, layer_edge_weights,
                            reconstruct_path, transfer_closure)


@dataclasses.dataclass(frozen=True)
class Route:
    cost: torch.Tensor    # [J] (or scalar): bound on each job's completion
    assign: np.ndarray    # [J, Lmax] (or [Lmax]) int32 compute node per layer


def _dp_fwd(t: torch.Tensor, comp: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, num_layers: torch.Tensor, cinv: torch.Tensor,
            nw: torch.Tensor):
    """Forward half of the layer DP for J jobs: costs + backpointer tables.

    t: [J, Lmax+1, V, V]; comp: [J, Lmax]; src/dst/num_layers: [J];
    cinv/nw: [V].  Returns ``(cost [J], total [J, V], bps [J, Lmax, V])``
    with ``bps`` int32 (-1 = stay at the node).
    """
    n_jobs, lmax = comp.shape
    rows = torch.arange(n_jobs, device=t.device)
    nl = num_layers.long()
    g = t[rows, 0, src.long(), :] + nw
    bps = []
    for l in range(1, lmax + 1):
        active = (l <= nl)[:, None]
        move, move_bp = torch.min(g[:, :, None] + t[:, l - 1], dim=1)
        moved = move + nw
        stay_wins = g <= moved
        new_g = fma_f32(comp[:, l - 1:l], cinv, torch.minimum(g, moved))
        new_g = torch.clamp(new_g, max=INF)
        bp = torch.where(stay_wins, -1, move_bp)
        g = torch.where(active, new_g, g)
        bps.append(torch.where(active, bp, -1))
    total = g + t[rows, nl, :, dst.long()]
    cost = torch.clamp(torch.amin(total, dim=1), max=INF)
    return cost, total, torch.stack(bps, dim=1).to(torch.int32)


def _dp_back(total, bps) -> np.ndarray:
    """Walk backpointers Lmax..1 to recover the compute node of each layer.

    Integer gathers only (on the host): u* = argmin total (first index on
    ties), then each layer's node is the next one's backpointer, or the
    same node where the pointer is -1.  Padded layers keep u*.
    """
    total = _np(total)
    bps = _np(bps)
    cur = int(np.argmin(total))
    assign = np.empty((bps.shape[0],), np.int32)
    for l in range(bps.shape[0] - 1, -1, -1):
        assign[l] = cur
        prev = int(bps[l, cur])
        cur = cur if prev < 0 else prev
    return assign


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _as_job_tensors(net: ComputeNetwork, comp, data, src, dst, num_layers):
    """One job's fields as [1, ...] tensors on the network's device."""
    dev = net.device

    def vec(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).reshape(1, -1)

    return (vec(comp, torch.float32), vec(data, torch.float32),
            vec(src, torch.int32)[0], vec(dst, torch.int32)[0],
            vec(num_layers, torch.int32)[0])


def route_single(net: ComputeNetwork, comp, data, src, dst, num_layers,
                 *, closures: Closures | None = None) -> Route:
    """Optimally route one job (paper formulation (1)-(5)) given queues in ``net``.

    ``closures`` (if given) must have been built against this same
    (net, data).  Returns a scalar cost and an [Lmax] assignment.
    """
    comp_t, data_t, src_t, dst_t, nl_t = _as_job_tensors(
        net, comp, data, src, dst, num_layers)
    if closures is None:
        closures = closures_for(net, data_t[0])
    cost, total, bps = _dp_fwd(closures.t[None], comp_t, src_t, dst_t, nl_t,
                               node_invrate(net), node_wait(net))
    return Route(cost=cost[0], assign=_dp_back(total[0], bps[0]))


def route_batch_fwd(net: ComputeNetwork, batch: JobBatch,
                    *, closures: Closures):
    """Forward-only batch routing: ``(cost [J], total [J, V],
    bps [J, Lmax, V])``.  The per-job backpointer walk is deferred to
    :func:`assign_from_backpointers`, so a caller that commits one job per
    round walks one table instead of J."""
    return _dp_fwd(closures.t, batch.comp, batch.src, batch.dst,
                   batch.num_layers, node_invrate(net), node_wait(net))


def route_batch(net: ComputeNetwork, batch: JobBatch,
                *, closures: Closures | None = None) -> Route:
    """Route every job of a padded batch against the shared queues.

    ``closures``: optional [J, ...]-stacked artifact from
    ``shortest_path.build_closures_batch``; built here when absent.
    """
    if closures is None:
        closures = closures_for(net, batch.data)
    cost, total, bps = route_batch_fwd(net, batch, closures=closures)
    total_h, bps_h = total.cpu().numpy(), bps.cpu().numpy()
    assign = np.stack([_dp_back(total_h[j], bps_h[j])
                       for j in range(batch.num_jobs)])
    return Route(cost=cost, assign=assign)


def assign_from_backpointers(total, bps) -> np.ndarray:
    """One job's [Lmax] assignment from its :func:`route_batch_fwd` row —
    bit-identical to the corresponding ``route_batch(...).assign`` row."""
    return _dp_back(total, bps)


def cost_given_assignment(net: ComputeNetwork, comp, data, src, dst,
                          num_layers, assign,
                          *, closures: Closures | None = None) -> np.float32:
    """Objective (1) for a *fixed* compute-node assignment (paths free).

    Transfers between consecutive compute nodes take min-cost paths under
    the current queues; node waits are charged once per consecutive run.
    The one-row case of :func:`cost_given_assignments`.
    """
    return cost_given_assignments(
        net, comp, data, src, dst, num_layers,
        _np(assign)[None], closures=closures)[0]


def cost_given_assignments(net: ComputeNetwork, comp, data, src, dst,
                           num_layers, assigns,
                           *, closures: Closures | None = None) -> np.ndarray:
    """Objective (1) of one job under C fixed assignments at once.

    ``assigns`` is [C, >= L]: one compute node per real layer in each row.
    Each layer's segment ``T + wait + c * cinv`` is one [C, L] gather over
    the job's closure stack, computed on the device with the reference's
    rounding (one fused multiply-add); the segments are then summed in
    layer order in float32 on the host, as the reference's scan does, so
    every row equals the reference's single-assignment cost (and its
    ``vmap`` over rows) bit for bit.  Returns float32 [C].
    """
    L, s, d = int(num_layers), int(src), int(dst)
    a = torch.as_tensor(_np(assigns)[:, :L].astype(np.int64),
                        device=net.device)                      # [C, L]
    comp_t = torch.as_tensor(_np(comp)[:L], dtype=torch.float32,
                             device=net.device)
    t = (transfer_closure(net, torch.as_tensor(data, device=net.device))
         if closures is None else closures.t)
    cinv, nw = node_invrate(net), node_wait(net)
    prev = torch.cat([torch.full_like(a[:, :1], s), a[:, :-1]], dim=1)
    layer = torch.arange(L, device=a.device)
    t_in = t[layer, prev, a]                  # T_{l-1}[prev, cur], [C, L]
    wait = torch.where(a == prev, 0.0, nw[a])
    wait[:, 0] = nw[a[:, 0]]                 # layer 1 always charges its wait
    seg = fma_f32(comp_t, cinv[a], t_in + wait)
    tail = t[L, a[:, -1], d]
    seg_h, tail_h = seg.cpu().numpy(), tail.cpu().numpy()
    total = seg_h[:, 0]
    for l in range(1, L):
        total = total + seg_h[:, l]          # float32, in layer order
    return np.minimum(total + tail_h, np.float32(INF))


def _layer_hops(net: ComputeNetwork, data_t: torch.Tensor, src: int, dst: int,
                num_layers: int, assign: np.ndarray,
                closures: Closures | None) -> np.ndarray:
    """[L+1, V, 2] host hop lists of layers 0..L: layer l's output moves
    from node_l to node_{l+1}, with node_0 = src and node_{L+1} = dst."""
    if closures is None:
        closures = closures_for(net, data_t)
    L = num_layers
    w = (layer_edge_weights(net, data_t[:L + 1]) if closures.w is None
         else closures.w[:L + 1])
    nodes = np.concatenate([[src], assign[:L], [dst]]).astype(np.int64)
    nodes_t = torch.as_tensor(nodes, device=net.device)
    hops = reconstruct_path(w, closures.t[:L + 1], nodes_t[:-1], nodes_t[1:],
                            max_hops=net.num_nodes)
    return hops.cpu().numpy()


def _ordered_add(base: torch.Tensor, flat_idx: list[int],
                 vals: list[float]) -> torch.Tensor:
    """``base`` with ``base.flatten()[flat_idx[i]] += vals[i]`` applied in
    list order, one float32 rounding per add, without atomics.

    The i-th update of an element goes into round i; within a round every
    element is written once, so each round is a plain gather-add-store and
    the result does not depend on how the device orders a scatter.
    """
    out = base.clone()
    flat = out.view(-1)
    seen: collections.Counter = collections.Counter()
    rounds: list[tuple[list[int], list[float]]] = []
    for i, v in zip(flat_idx, vals):
        r = seen[i]
        seen[i] += 1
        if r == len(rounds):
            rounds.append(([], []))
        rounds[r][0].append(i)
        rounds[r][1].append(v)
    for idx, v in rounds:
        it = torch.tensor(idx, dtype=torch.long, device=out.device)
        flat[it] = flat[it] + torch.tensor(v, dtype=out.dtype,
                                           device=out.device)
    return out


def commit_with_hops(net: ComputeNetwork, comp, data, src, dst, num_layers,
                     assign, *, closures: Closures | None = None,
                     ) -> tuple[ComputeNetwork, np.ndarray]:
    """Algorithm 1 line 3: add the routed job's load to the queues.

    q_node[a_l] += c_l for each real layer l, in layer order, one rounding
    per add straight onto q_node; q_link[u, v] += d_l for every hop of the
    min-cost path carrying layer-l output, layer by layer and hop by hop.

    The reference writes the node charge as ``q_node + zeros.at[assign]
    .add(comp)``, but XLA:CPU folds that into one scatter-add onto
    ``q_node`` (adds applied in layer order), and that folded order is what
    its results hold; summing per node from zero first differs in the last
    ulp whenever two layers share a node.

    Returns the new network and the [L+1, V, 2] hop lists it charged
    (padded with -1).
    """
    v = net.num_nodes
    L, s, d = int(num_layers), int(src), int(dst)
    a = _np(assign).astype(np.int32)
    comp_h = _np(comp).astype(np.float32)
    data_t = torch.as_tensor(data, dtype=torch.float32, device=net.device)
    data_h = data_t.cpu().numpy()
    hops = _layer_hops(net, data_t, s, d, L, a, closures)

    q_node = _ordered_add(net.q_node, a[:L].tolist(), comp_h[:L].tolist())
    us, vs = hops[..., 0], hops[..., 1]
    charge = (us >= 0) & (us != vs)
    layer = np.broadcast_to(np.arange(L + 1)[:, None], us.shape)[charge]
    q_link = _ordered_add(net.q_link, (us[charge] * v + vs[charge]).tolist(),
                          data_h[layer].tolist())
    return net.with_queues(q_node, q_link), hops


def commit_assignment(net: ComputeNetwork, comp, data, src, dst, num_layers,
                      assign, *, closures: Closures | None = None
                      ) -> ComputeNetwork:
    """:func:`commit_with_hops` without the hop lists."""
    return commit_with_hops(net, comp, data, src, dst, num_layers, assign,
                            closures=closures)[0]


def hops_to_paths(hops, num_layers: int) -> list:
    """Format an [Lmax+1, V, 2] hop array as ``plan.paths`` lists: one list
    of (u, v) int tuples per real layer 0..num_layers, truncated at the
    first (-1, -1) padding row."""
    live = _np(hops)[:int(num_layers) + 1]
    n_real = (live[:, :, 0] >= 0).sum(1).tolist()
    return [list(map(tuple, live[l, :n].tolist()))
            for l, n in enumerate(n_real)]


def extract_paths(net: ComputeNetwork, comp, data, src, dst, num_layers,
                  assign, *, closures: Closures | None = None) -> list:
    """Explicit per-layer hop lists for the event simulator."""
    data_t = torch.as_tensor(data, dtype=torch.float32, device=net.device)
    hops = _layer_hops(net, data_t, int(src), int(dst), int(num_layers),
                       _np(assign).astype(np.int32), closures)
    return hops_to_paths(hops, int(num_layers))


def extract_paths_ref(net: ComputeNetwork, comp, data, src, dst, num_layers,
                      assign):
    """Reference per-hop host loop (seed implementation) for parity tests."""
    v = net.num_nodes
    data_t = torch.as_tensor(data, dtype=torch.float32, device=net.device)
    w = _np(layer_edge_weights(net, data_t))
    t = _np(transfer_closure(net, data_t))
    assign = _np(assign)
    L = int(num_layers)
    nodes = [int(src)] + [int(assign[l]) for l in range(L)] + [int(dst)]
    paths = []
    for l in range(L + 1):
        a, b = nodes[l], nodes[l + 1]
        hops = []
        cur = a
        for _ in range(v):
            if cur == b:
                break
            cand = w[l][cur] + t[l][:, b]
            cand[cur] = np.inf  # never take the zero-cost self-loop
            nxt = int(np.argmin(cand))
            hops.append((cur, nxt))
            cur = nxt
        paths.append(hops)
    return paths
