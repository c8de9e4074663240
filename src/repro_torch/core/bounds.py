"""Theorem 2 approximation-ratio machinery.

Counterpart of ``repro.core.bounds``.  ``alpha(net, jobs)`` evaluates the
paper's bound

    alpha = max{ 2*a_tx, 2(L+1)(|V_p|+|E_p|)*a_tx / k, (1+|E_p|/|V_p|)*a_cp }
            * (2 - 1/(|V_p|+|E_p|))

with |V_p| = #nodes with positive compute, |E_p| = #links with finite
capacity, k = edge connectivity, a_tx / a_cp the heterogeneity ratios, and
h_L / h_S the longest/shortest s-t hop counts (longest simple path is
exact for small graphs, else upper-bounded by |V|-1 -- an upper bound on
h_L only ever loosens alpha, so the bound stays valid).

``service_lower_bounds`` gives Lemma 8's two lower bounds on T*.

The reference reads the graph quantities from ``networkx``; this module
computes them itself, on the host, with the same values: the undirected
edge set of ``mu_link > 0``, breadth-first hop counts, depth-first
enumeration of simple paths, and edge connectivity as the least
unit-capacity max-flow from node 0 to any other node (0 for a
disconnected graph).
"""
from __future__ import annotations

import collections

import numpy as np

from .network import ComputeNetwork
from .jobs import InferenceJob
from . import routing


def _graph(net: ComputeNetwork) -> tuple[list[set[int]], int]:
    """(neighbour sets, edge count) of the undirected graph with an edge
    {u, w} wherever ``mu_link[u, w] > 0`` (a self-loop counts as an edge,
    as ``networkx`` counts it, and never shortens or lengthens a path)."""
    mu = net.mu_link.cpu().numpy()
    v = net.num_nodes
    adj: list[set[int]] = [set() for _ in range(v)]
    edges = set()
    for u, w in zip(*np.nonzero(mu > 0)):
        u, w = int(u), int(w)
        edges.add((min(u, w), max(u, w)))
        if u != w:
            adj[u].add(w)
            adj[w].add(u)
    return adj, len(edges)


def _longest_simple_path_len(adj: list[set[int]], s: int, t: int,
                             exact_max_nodes: int = 10) -> int:
    """Hops of the longest simple s-t path (0 when there is none), by
    depth-first enumeration up to ``exact_max_nodes`` nodes; above that
    the safe upper bound |V| - 1."""
    v = len(adj)
    if v > exact_max_nodes:
        return v - 1
    if s == t:
        return 0
    best = 0
    on_path = [False] * v
    on_path[s] = True
    stack = [(s, iter(sorted(adj[s])), 0)]
    while stack:
        node, it, depth = stack[-1]
        nxt = next(it, None)
        if nxt is None:
            on_path[node] = False
            stack.pop()
        elif nxt == t:
            best = max(best, depth + 1)
        elif not on_path[nxt]:
            on_path[nxt] = True
            stack.append((nxt, iter(sorted(adj[nxt])), depth + 1))
    return best


def _shortest_path_len(adj: list[set[int]], s: int, t: int) -> int:
    """Breadth-first hop count; raises ``ValueError`` without a path."""
    dist = {s: 0}
    queue = collections.deque([s])
    while queue:
        u = queue.popleft()
        if u == t:
            return dist[u]
        for w in adj[u]:
            if w not in dist:
                dist[w] = dist[u] + 1
                queue.append(w)
    raise ValueError(f"No path between {s} and {t}.")


def _max_flow_unit(adj: list[set[int]], s: int, t: int) -> int:
    """s-t max-flow with capacity 1 on each undirected edge (each way),
    by breadth-first augmenting paths."""
    flow: collections.Counter = collections.Counter()  # (u, w) -> net flow
    total = 0
    while True:
        parent = {s: s}
        queue = collections.deque([s])
        while queue and t not in parent:
            u = queue.popleft()
            for w in adj[u]:
                if w not in parent and flow[(u, w)] < 1:
                    parent[w] = u
                    queue.append(w)
        if t not in parent:
            return total
        w = t
        while w != s:
            u = parent[w]
            flow[(u, w)] += 1
            flow[(w, u)] -= 1
            w = u
        total += 1


def edge_connectivity(adj: list[set[int]]) -> int:
    """Global edge connectivity of an undirected graph: the least number of
    edges whose removal disconnects it (0 if it is disconnected or has one
    node).  A minimum cut separates node 0 from some other node, so it is
    the least max-flow from node 0."""
    return min((_max_flow_unit(adj, 0, w) for w in range(1, len(adj))),
               default=0)


def alpha(net: ComputeNetwork, jobs: list[InferenceJob]) -> float:
    adj, n_e = _graph(net)
    mu_n = net.mu_node.cpu().numpy().astype(np.float64)
    mu_l = net.mu_link.cpu().numpy().astype(np.float64)
    comp_nodes = mu_n[mu_n > 0]
    n_v = int((mu_n > 0).sum())
    k = edge_connectivity(adj)
    L = max(j.num_layers for j in jobs)

    h_long = max(_longest_simple_path_len(adj, j.src, j.dst) for j in jobs)
    h_short = min(_shortest_path_len(adj, j.src, j.dst) for j in jobs)
    h_short = max(h_short, 1)

    d_all = np.concatenate([j.data for j in jobs])
    d_all = d_all[d_all > 0]
    links = mu_l[mu_l > 0]
    a_tx = (h_long * d_all.max() * links.max()) / (h_short * d_all.min()
                                                   * links.min())
    a_cp = comp_nodes.max() / comp_nodes.min()

    core = max(2 * a_tx,
               2 * (L + 1) * (n_v + n_e) * a_tx / max(k, 1),
               (1 + n_e / n_v) * a_cp)
    return float(core * (2 - 1.0 / (n_v + n_e)))


def corollary1_factor(net: ComputeNetwork) -> float:
    """2 - 1/|V_p| (zero network delay, identical compute capacities)."""
    n_v = int((net.mu_node.cpu().numpy() > 0).sum())
    return 2 - 1.0 / n_v


def service_lower_bounds(net: ComputeNetwork, batch) -> tuple[np.ndarray,
                                                               float]:
    """Lemma 8: per-job S^SS (a lower bound on T*) and the averaged bound.

    S_j^SS is the fastest possible service time of job j = its optimal
    route in the empty-queue network (waiting terms vanish, objective =
    service).  The routing builds the batch's closure stack: on the card
    one launch of the closure kernel (V <= 32).
    """
    empty = net.reset_queues()
    r = routing.route_batch(empty, batch)
    s_ss = r.cost.cpu().numpy().astype(np.float64)
    n_v = int((net.mu_node.cpu().numpy() > 0).sum())
    denom = n_v + _graph(net)[1]
    return s_ss, float(s_ss.sum() / denom)
