"""Parameterized topology generators: the scenario catalog's network side.

Counterpart of ``repro.scenarios.topologies``: the same numpy draws in the
same order, so the float32 capacity tensors equal the reference's bit for
bit.  Every generator returns ``(net, names, ingress, egress)`` where
``net`` is a fresh :class:`~repro_torch.core.network.ComputeNetwork` (empty
queues) on ``device`` (default ``"cuda"``), and ingress/egress are the node
sets traffic enters/leaves through.  All generators are deterministic in
``seed``.

Families:
  * ``paper_small``      — the paper's 5-node Fig. 2 topology.
  * ``us_backbone``      — the paper's 24-node USNET backbone (Fig. 4).
  * ``edge_cloud``       — k edge sites -> aggregation tier -> cloud; edge
                           nodes have thin compute and thin uplinks, the
                           cloud is fat on both (split-computing setting).
  * ``random_geometric`` — nodes in the unit square, links within a radius
                           (capacity falls with distance), chained into one
                           component; heterogeneous compute.
  * ``star``             — cellular: one hub with fat compute, leaves with
                           thin local compute and mixed-rate uplinks.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.core import network as N

G = 1e9
MB = 1e6


def paper_small(seed: int = 0, *, capacity_scale: float = 1e-3,
                device: str | torch.device = "cuda"):
    net, names = N.small_topology(capacity_scale=capacity_scale,
                                  device=device)
    return net, names, [0], [4]


def us_backbone(seed: int = 0, *, capacity_scale: float = 1e-3,
                device: str | torch.device = "cuda"):
    net, names = N.us_backbone(capacity_scale=capacity_scale, seed=seed,
                               device=device)
    # coastal ingress, interior egress (fixed, documented choice)
    return net, names, [0, 5, 10, 20], [4, 9, 15, 23]


def edge_cloud(seed: int = 0, *, n_edge: int = 6, n_agg: int = 2,
               capacity_scale: float = 1e-3,
               device: str | torch.device = "cuda"):
    """Edge sites -> aggregation -> cloud hierarchy.

    Node order: [edge_0..edge_{k-1}, agg_0..agg_{m-1}, cloud].  Edge nodes
    carry thin compute (they *can* run early layers locally), aggregation
    nodes are pure forwarders, the cloud node is fat.
    """
    rng = np.random.default_rng(seed)
    v = n_edge + n_agg + 1
    cloud = v - 1
    caps = [float(rng.uniform(5, 15)) * G for _ in range(n_edge)] \
        + [0.0] * n_agg + [300 * G]
    edges = []
    for e in range(n_edge):
        agg = n_edge + (e % n_agg)
        edges.append((e, agg, float(rng.choice([125, 375])) * MB))
    for a in range(n_agg):
        edges.append((n_edge + a, cloud, 1000 * MB))
    if n_agg > 1:  # ring over the aggregation tier for cross-site paths
        for a in range(n_agg):
            edges.append((n_edge + a, n_edge + (a + 1) % n_agg, 375 * MB))
    edges = [(u, w, c * capacity_scale) for u, w, c in edges]
    names = [f"edge{i}" for i in range(n_edge)] \
        + [f"agg{i}" for i in range(n_agg)] + ["cloud"]
    net = N.make_network(v, edges, caps, device=device)
    return net, names, list(range(n_edge)), list(range(n_edge))


def random_geometric(seed: int = 0, *, num_nodes: int = 12,
                     radius: float = 0.45, capacity_scale: float = 1e-3,
                     device: str | torch.device = "cuda"):
    """Random geometric mesh: connect nodes within ``radius``; capacity
    decays with distance.  Components are chained by nearest cross-links so
    the graph is always connected."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, size=(num_nodes, 2))
    caps_cycle = [30, 50, 200, 100, 70]
    caps = [caps_cycle[int(rng.integers(0, 5))] * G for _ in range(num_nodes)]
    edges = []
    dist = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    for u in range(num_nodes):
        for w in range(u + 1, num_nodes):
            if dist[u, w] <= radius:
                cap = (375 if dist[u, w] < radius / 2 else 125) * MB
                edges.append((u, w, cap))
    # Union-find to chain components with their closest cross pair.
    parent = list(range(num_nodes))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, w, _ in edges:
        parent[find(u)] = find(w)
    while len({find(i) for i in range(num_nodes)}) > 1:
        roots = {}
        for i in range(num_nodes):
            roots.setdefault(find(i), []).append(i)
        comps = list(roots.values())
        best = None
        for a in comps[0]:
            for comp in comps[1:]:
                for b in comp:
                    if best is None or dist[a, b] < dist[best[0], best[1]]:
                        best = (a, b)
        edges.append((best[0], best[1], 125 * MB))
        parent[find(best[0])] = find(best[1])
    edges = [(u, w, c * capacity_scale) for u, w, c in edges]
    names = [f"g{i}" for i in range(num_nodes)]
    net = N.make_network(num_nodes, edges, caps, device=device)
    ingress = sorted(int(i) for i in rng.choice(num_nodes, 3, replace=False))
    egress = sorted(int(i) for i in rng.choice(num_nodes, 3, replace=False))
    return net, names, ingress, egress


def star(seed: int = 0, *, num_leaves: int = 8, capacity_scale: float = 1e-3,
         device: str | torch.device = "cuda"):
    """Cellular star: hub node 0 (fat compute), leaves with thin compute."""
    rng = np.random.default_rng(seed)
    v = num_leaves + 1
    caps = [200 * G] + [float(rng.uniform(10, 40)) * G
                        for _ in range(num_leaves)]
    edges = [(0, 1 + i, float(rng.choice([125, 375])) * MB * capacity_scale)
             for i in range(num_leaves)]
    names = ["hub"] + [f"leaf{i}" for i in range(num_leaves)]
    net = N.make_network(v, edges, caps, device=device)
    leaves = list(range(1, v))
    return net, names, leaves, leaves


FAMILIES = {
    "paper-small": paper_small,
    "us-backbone": us_backbone,
    "edge-cloud": edge_cloud,
    "random-geometric": random_geometric,
    "star": star,
}
