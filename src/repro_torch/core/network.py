"""Physical computing network model G_p = (V_p, E_p).

Counterpart of ``repro.core.network``.  :class:`ComputeNetwork` composes a
:class:`~repro_torch.core.state.Topology` with a
:class:`~repro_torch.core.state.QueueState`; its flat accessors
(``net.mu_node`` ...) delegate to the parts.

Absent links have ``mu_link == 0`` and cost ``INF``.  ``INF`` is a large
*finite* sentinel (``float32(1e30)``, not ``inf``) so that min-plus
arithmetic never produces NaNs and argmins stay well-defined; it is kept as
the Python float holding exactly that float32 value, so it converts to a
float32 tensor element without rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .state import QueueState, Topology, advance as _advance
from .validation import check_finite_nonneg as _check_finite_nonneg

INF = float(np.float32(1e30))


@dataclasses.dataclass(frozen=True)
class ComputeNetwork:
    """View composing a :class:`Topology` with a :class:`QueueState`."""

    topology: Topology
    state: QueueState

    @property
    def mu_node(self) -> torch.Tensor:
        return self.topology.mu_node

    @property
    def mu_link(self) -> torch.Tensor:
        return self.topology.mu_link

    @property
    def q_node(self) -> torch.Tensor:
        return self.state.q_node

    @property
    def q_link(self) -> torch.Tensor:
        return self.state.q_link

    @property
    def clock(self) -> torch.Tensor:
        return self.state.clock

    @property
    def num_nodes(self) -> int:
        return self.topology.num_nodes

    @property
    def device(self) -> torch.device:
        return self.topology.device

    @classmethod
    def of(cls, mu_node: torch.Tensor, mu_link: torch.Tensor,
           q_node: torch.Tensor, q_link: torch.Tensor,
           clock: float = 0.0) -> "ComputeNetwork":
        """Build a view from flat float32 tensors on one device."""
        return cls(topology=Topology(mu_node=mu_node, mu_link=mu_link),
                   state=QueueState(q_node=q_node, q_link=q_link,
                                    clock=torch.tensor(
                                        clock, dtype=torch.float32,
                                        device=mu_node.device)))

    def with_queues(self, q_node: torch.Tensor,
                    q_link: torch.Tensor) -> "ComputeNetwork":
        """New backlogs, same topology and clock."""
        return dataclasses.replace(
            self, state=self.state.with_queues(q_node, q_link))

    def reset_queues(self) -> "ComputeNetwork":
        return self.with_queues(torch.zeros_like(self.q_node),
                                torch.zeros_like(self.q_link))

    def advance(self, dt) -> "ComputeNetwork":
        """Fluid drain: every resource works off backlog at rate mu for dt s."""
        return dataclasses.replace(
            self, state=_advance(self.topology, self.state, dt))


def make_network(
    num_nodes: int,
    edges: Iterable[tuple[int, int, float]],
    node_caps: Sequence[float],
    *,
    bidirectional: bool = True,
    device: str | torch.device = "cuda",
) -> ComputeNetwork:
    """Build a :class:`ComputeNetwork` on ``device`` from an edge list.

    Args:
      num_nodes: |V_p|.
      edges: (u, v, capacity bytes/s) triples.
      node_caps: [V] compute capacities in FLOP/s.
      bidirectional: mirror every edge (the paper assumes bidirectional links).
      device: ``"cuda"`` (default; raises ``RuntimeError`` without a card)
        or ``"cpu"``.

    Raises ``ValueError`` naming the offending field for negative/NaN
    capacities, out-of-range endpoints, or a mis-shaped ``node_caps``.
    """
    dev = resolve_device(device)
    if num_nodes <= 0:
        raise ValueError(f"num_nodes must be positive, got {num_nodes}")
    mu_link = np.zeros((num_nodes, num_nodes), np.float32)
    for i, (u, v, cap) in enumerate(edges):
        if not (0 <= u < num_nodes and 0 <= v < num_nodes):
            raise ValueError(
                f"edges[{i}]=({u}, {v}): endpoint out of range [0, {num_nodes})")
        if u == v:
            raise ValueError(f"edges[{i}]: self-loop ({u}, {v}) not allowed")
        if not np.isfinite(cap) or cap < 0:
            raise ValueError(
                f"edges[{i}]=({u}, {v}): capacity {cap!r} must be finite and >= 0")
        mu_link[u, v] = cap
        if bidirectional:
            mu_link[v, u] = cap
    mu_node = np.asarray(node_caps, np.float32)
    if mu_node.shape != (num_nodes,):
        raise ValueError(
            f"node_caps must have shape ({num_nodes},), got {mu_node.shape}")
    _check_finite_nonneg("node_caps", mu_node)
    return ComputeNetwork.of(
        mu_node=torch.from_numpy(mu_node).to(dev),
        mu_link=torch.from_numpy(mu_link).to(dev),
        q_node=torch.zeros((num_nodes,), dtype=torch.float32, device=dev),
        q_link=torch.zeros((num_nodes, num_nodes), dtype=torch.float32,
                           device=dev),
    )


def _set_diagonal_zero(x: torch.Tensor) -> torch.Tensor:
    x.diagonal().zero_()
    return x


def link_invrate(net: ComputeNetwork) -> torch.Tensor:
    """[V,V] reciprocal link capacity; INF where there is no link.

    The diagonal is 0: staying at a node costs nothing to "transfer".
    """
    mu = net.mu_link
    inv = torch.where(mu > 0, torch.reciprocal(torch.clamp(mu, min=1e-30)),
                      INF)
    return _set_diagonal_zero(inv)


def link_wait(net: ComputeNetwork) -> torch.Tensor:
    """[V,V] per-traversal waiting time Q_uv / mu_uv; 0 on the diagonal."""
    mu = net.mu_link
    w = torch.where(mu > 0, net.q_link / torch.clamp(mu, min=1e-30), 0.0)
    return _set_diagonal_zero(w)


def node_invrate(net: ComputeNetwork) -> torch.Tensor:
    """[V] reciprocal compute capacity; INF where the node has no compute."""
    mu = net.mu_node
    return torch.where(mu > 0, torch.reciprocal(torch.clamp(mu, min=1e-30)),
                       INF)


def node_wait(net: ComputeNetwork) -> torch.Tensor:
    """[V] compute waiting time Q_u / mu_u; 0 for compute-less nodes."""
    mu = net.mu_node
    return torch.where(mu > 0, net.q_node / torch.clamp(mu, min=1e-30), 0.0)


# ---------------------------------------------------------------------------
# The paper's two evaluation topologies.
# ---------------------------------------------------------------------------

def small_topology(*, capacity_scale: float = 1.0,
                   device: str | torch.device = "cuda",
                   ) -> tuple[ComputeNetwork, list[str]]:
    """The 5-node topology of Fig. 2 / §V.

    Nodes: s, u, w, v, t with compute capacities 200/70/50/50/30 GFLOP/s.
    Links: s-u, s-w, u-w, u-v, w-v, w-t, v-t with capacities 125 or 375 MB/s.
    ``capacity_scale`` multiplies the *link* capacities (the paper scans a
    universal scale factor, e.g. 1e-4).
    """
    names = ["s", "u", "w", "v", "t"]
    G = 1e9
    MB = 1e6
    node_caps = [200 * G, 70 * G, 50 * G, 50 * G, 30 * G]
    edges = [
        (0, 1, 375 * MB), (0, 2, 125 * MB), (1, 2, 125 * MB),
        (1, 3, 375 * MB), (2, 3, 125 * MB), (2, 4, 375 * MB),
        (3, 4, 125 * MB),
    ]
    edges = [(u, v, c * capacity_scale) for u, v, c in edges]
    return make_network(5, edges, node_caps, device=device), names


# 24-node US backbone (USNET-style, 43 bidirectional links), the same
# connectivity as the reference's documented approximation of Fig. 4.
_US_BACKBONE_EDGES = [
    (0, 1), (0, 5), (1, 2), (1, 5), (2, 3), (2, 4), (3, 4), (3, 6),
    (4, 7), (5, 8), (5, 10), (6, 7), (6, 9), (7, 9), (8, 9), (8, 10),
    (9, 12), (10, 11), (10, 13), (11, 12), (11, 14), (12, 15), (13, 14),
    (13, 16), (14, 15), (14, 18), (15, 19), (16, 17), (16, 20), (17, 18),
    (17, 21), (18, 19), (18, 22), (19, 23), (20, 21), (21, 22), (22, 23),
    (2, 6), (9, 13), (12, 14), (20, 22), (4, 6), (11, 15),
]


def us_backbone(*, capacity_scale: float = 1.0, seed: int = 0,
                device: str | torch.device = "cuda",
                ) -> tuple[ComputeNetwork, list[str]]:
    """The 24-node US backbone of Fig. 4.

    Node compute capacities follow the paper: [30, 50, 200, 100, 70] repeating
    in increasing node order. Link capacities use the same {125, 375} MB/s mix
    as the small topology (deterministic per-edge choice by parity of u+v).
    ``seed`` is accepted and ignored, as in the reference: the topology is
    fixed.
    """
    G = 1e9
    MB = 1e6
    caps_cycle = [30, 50, 200, 100, 70]
    node_caps = [caps_cycle[i % 5] * G for i in range(24)]
    edges = []
    for (u, v) in _US_BACKBONE_EDGES:
        cap = (375 if (u + v) % 2 == 0 else 125) * MB
        edges.append((u, v, cap * capacity_scale))
    names = [f"n{i}" for i in range(24)]
    return make_network(24, edges, node_caps, device=device), names
