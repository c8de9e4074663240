"""Exact oracles (host-side numpy) used to validate the routing DP.

Counterpart of ``repro.core.exact``.  ``exact_route_bitmask`` solves the
single-job ILP (1)-(5) *exactly*, including the once-per-node z_u
semantics, by dynamic programming over (layer, node, set-of-wait-charged
nodes).  Exponential in |V_p| but exact -- the oracle for small randomized
instances (V <= ~14).  It runs in float64 numpy, as the reference's does.

``exact_plan`` lifts the single-job oracle to the multi-job problem (every
priority order x exact sequential routing) and returns a canonical
:class:`~repro_torch.core.plan.Plan` -- registered as
``solve(..., method="exact")``.  Each routed job is committed to the
queues through ``routing.commit_assignment`` with its closure stack from
``shortest_path.build_closures``: on the card one launch of the closure
kernel per job routed (``meta["n_routings"]`` of them).

``brute_force_makespan`` enumerates (assignments x priorities) on tiny
instances and simulates the actual system, giving the true optimum T* for
approximation-ratio tests (Theorem 2 / Corollary 1).
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from .network import ComputeNetwork
from .jobs import JobBatch
from .plan import Plan

_INF = 1e30


def _np_closure(w: np.ndarray) -> np.ndarray:
    n = w.shape[-1]
    d = w.copy()
    idx = np.arange(n)
    d[..., idx, idx] = np.minimum(d[..., idx, idx], 0.0)
    for _ in range(max(1, int(np.ceil(np.log2(max(n - 1, 2)))))):
        d = np.min(d[..., :, :, None] + d[..., None, :, :], axis=-2)
    return d


def _net_np(net: ComputeNetwork):
    mu_n, mu_l, q_n, q_l = (x.cpu().numpy().astype(np.float64) for x in (
        net.mu_node, net.mu_link, net.q_node, net.q_link))
    v = mu_n.shape[0]
    inv_l = np.where(mu_l > 0, 1.0 / np.maximum(mu_l, 1e-30), _INF)
    inv_l[np.arange(v), np.arange(v)] = 0.0
    wait_l = np.where(mu_l > 0, q_l / np.maximum(mu_l, 1e-30), 0.0)
    wait_l[np.arange(v), np.arange(v)] = 0.0
    inv_n = np.where(mu_n > 0, 1.0 / np.maximum(mu_n, 1e-30), _INF)
    wait_n = np.where(mu_n > 0, q_n / np.maximum(mu_n, 1e-30), 0.0)
    return inv_l, wait_l, inv_n, wait_n


def layer_weights_np(net: ComputeNetwork, data: np.ndarray) -> np.ndarray:
    inv_l, wait_l, _, _ = _net_np(net)
    w = data[:, None, None] * inv_l[None] + wait_l[None]
    return np.minimum(w, _INF)


def exact_route_bitmask(net: ComputeNetwork, comp: np.ndarray,
                        data: np.ndarray, src: int, dst: int
                        ) -> tuple[float, list[int]]:
    """Exact optimum of ILP (1)-(5): min over paths of service + once-per-node waits."""
    inv_l, wait_l, inv_n, wait_n = _net_np(net)
    v = inv_n.shape[0]
    if v > 16:
        raise ValueError("bitmask oracle is for small graphs")
    comp = np.asarray(comp)
    L = len(comp)
    t = _np_closure(layer_weights_np(net, np.asarray(data, np.float64)))

    full = 1 << v
    f = np.full((v, full), _INF)
    bp: dict[tuple[int, int, int], tuple[int, int]] = {}
    for u in range(v):
        s = 1 << u
        f[u, s] = t[0, src, u] + wait_n[u] + comp[0] * inv_n[u]
    for l in range(2, L + 1):
        g = np.full((v, full), _INF)
        for mask in range(full):
            row = f[:, mask]
            if np.all(row >= _INF):
                continue
            for u in range(v):
                if row[u] >= _INF:
                    continue
                for w_ in range(v):
                    nm = mask | (1 << w_)
                    extra = 0.0 if (mask >> w_) & 1 else wait_n[w_]
                    c = row[u] + t[l - 1, u, w_] + extra \
                        + comp[l - 1] * inv_n[w_]
                    if c < g[w_, nm] - 1e-15:
                        g[w_, nm] = c
                        bp[(l, w_, nm)] = (u, mask)
        f = g
    best = _INF
    arg = None
    for mask in range(full):
        for u in range(v):
            c = f[u, mask] + t[L, u, dst]
            if c < best - 1e-15:
                best, arg = c, (u, mask)
    assign = []
    if arg is not None:
        u, mask = arg
        assign = [u]
        for l in range(L, 1, -1):
            u, mask = bp[(l, u, mask)]
            assign.append(u)
        assign.reverse()
    return float(best), assign


def exact_plan(net: ComputeNetwork, batch: JobBatch, *,
               max_jobs: int = 7) -> Plan:
    """Exact solver for the multi-job fictitious-system objective.

    Enumerates every priority order (J! of them) and, within each order,
    routes each job *exactly* with the bitmask oracle against the queue
    state left by its higher-priority predecessors -- i.e. the exact
    version of the sequential commit process that both Alg. 1 and Alg. 2
    bound.  Exponential in both J and |V_p|; intended for oracle checks on
    tiny instances (J <= ~6, V <= ~14).
    """
    from . import routing, shortest_path as SP

    J = batch.num_jobs
    if J > max_jobs:
        raise ValueError(f"exact solver is for <= {max_jobs} jobs, got {J}")
    if net.num_nodes > 16:
        raise ValueError("exact solver is for small graphs (V <= 16)")
    host = batch.to_numpy()
    comp = host["comp"].astype(np.float64)
    data = host["data"].astype(np.float64)
    nl, src, dst = host["num_layers"], host["src"], host["dst"]
    lmax = batch.max_layers

    best_mk = np.inf
    best: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
    n_routings = 0
    for perm in itertools.permutations(range(J)):
        cur = net
        assign = np.zeros((J, lmax), np.int32)
        bounds = np.zeros((J,), np.float64)
        for j in perm:
            L = int(nl[j])
            n_routings += 1
            cost, a = exact_route_bitmask(
                cur, comp[j, :L], data[j, : L + 1], int(src[j]), int(dst[j]))
            bounds[j] = cost
            assign[j, :L] = a
            if L:  # pad with the last compute node (masked out of all costs)
                assign[j, L:] = a[-1]
            cur = routing.commit_assignment(
                cur, host["comp"][j], batch.data[j], src[j], dst[j], nl[j],
                assign[j], closures=SP.build_closures(cur, batch.data[j]))
            if bounds[j] >= best_mk:
                break  # this order can't beat the incumbent
        else:
            if bounds.max() < best_mk:
                best_mk = float(bounds.max())
                best = (assign, np.asarray(perm, np.int32), bounds)
    assert best is not None
    assign, order, bounds = best
    return Plan.from_order(assign, order, bounds, solver="exact",
                           meta={"orders_tried": math.factorial(J),
                                 "n_routings": n_routings})


def brute_force_makespan(net: ComputeNetwork, batch: JobBatch) -> float:
    """True optimum T*: enumerate (assignments x priorities), simulate.

    The oracle for approximation-ratio tests (Theorem 2 / Corollary 1).
    Doubly exponential -- tiny instances only.
    """
    from . import schedule

    mu = net.mu_node.cpu().numpy()
    comp_nodes = np.nonzero(mu > 0)[0]
    J = batch.num_jobs
    Ls = batch.num_layers.cpu().numpy().tolist()
    best = np.inf
    for assigns in itertools.product(
            *[itertools.product(comp_nodes, repeat=Ls[j]) for j in range(J)]):
        a = np.zeros((J, batch.max_layers), np.int32)
        for j in range(J):
            a[j, :Ls[j]] = assigns[j]
            a[j, Ls[j]:] = assigns[j][-1] if Ls[j] else 0
        for perm in itertools.permutations(range(J)):
            sim = schedule.simulate(net, batch, a, np.asarray(perm))
            best = min(best, sim.makespan)
    return float(best)
