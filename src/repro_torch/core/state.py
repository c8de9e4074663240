"""Time-aware network state: immutable :class:`Topology` + fluid :class:`QueueState`.

Counterpart of ``repro.core.state``.  :class:`Topology` is what the network
*is* (compute capacities ``mu_node`` [V], link capacities ``mu_link``
[V, V]); :class:`QueueState` is what it is *doing* (backlogs ``q_node`` [V],
``q_link`` [V, V] and a float32 ``clock``).  :func:`advance` is the fluid
drain  q <- max(q - mu * dt, 0),  clock <- clock + dt.

All fields are float32 tensors on one device; a
:class:`~repro_torch.core.network.ComputeNetwork` is the composed view
``topology.view(state)``, built without copying a tensor.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .numerics import fma_f32


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable capacities of the physical network."""

    mu_node: torch.Tensor  # [V] FLOP/s (0 = no compute resources at node)
    mu_link: torch.Tensor  # [V, V] bytes/s (0 = no link)

    @property
    def num_nodes(self) -> int:
        return self.mu_node.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mu_node.device

    def empty_state(self, clock: float = 0.0) -> "QueueState":
        """All-zero backlogs at the given clock."""
        return QueueState(
            q_node=torch.zeros_like(self.mu_node),
            q_link=torch.zeros_like(self.mu_link),
            clock=torch.tensor(clock, dtype=torch.float32, device=self.device),
        )

    def view(self, state: "QueueState | None" = None):
        """Compose with a queue state into a :class:`ComputeNetwork` view."""
        from .network import ComputeNetwork
        return ComputeNetwork(topology=self,
                              state=self.empty_state() if state is None
                              else state)

    def scale_nodes(self, factor) -> "Topology":
        """Topology with ``mu_node * factor`` (elementwise; straggler views)."""
        return Topology(mu_node=self.mu_node * _f32(factor, self.device),
                        mu_link=self.mu_link)


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def effective_topology(topo: Topology, slowdown,
                       avail_node=None, link_up=None) -> Topology:
    """Health-scaled *view* of a topology (see ``repro.core.state``).

    ``slowdown`` [V] follows the "factor=2 means half speed" convention.
    ``avail_node`` [V] bool zeroes failed nodes' compute and every incident
    link; ``link_up`` [V, V] bool zeroes individually failed directed
    links.  With both masks omitted this is exactly
    ``scale_nodes(1/slowdown)``.
    """
    inv = torch.reciprocal(_f32(slowdown, topo.device))
    if avail_node is None and link_up is None:
        return topo.scale_nodes(inv)
    avail = (np.ones((topo.num_nodes,), bool) if avail_node is None
             else np.asarray(avail_node, bool))
    scale = torch.where(torch.as_tensor(avail, device=topo.device), inv, 0.0)
    mask = avail[:, None] & avail[None, :]
    if link_up is not None:
        mask = mask & np.asarray(link_up, bool)
    return Topology(mu_node=topo.mu_node * scale,
                    mu_link=topo.mu_link * _f32(mask, topo.device))


@dataclasses.dataclass(frozen=True)
class QueueState:
    """Backlogs + clock: the only mutable part of the network."""

    q_node: torch.Tensor  # [V] FLOPs queued
    q_link: torch.Tensor  # [V, V] bytes queued
    clock: torch.Tensor   # 0-d float32 seconds

    def advance(self, topo: Topology, dt) -> "QueueState":
        """Fluid drain for ``dt`` seconds (see :func:`advance`)."""
        return advance(topo, self, dt)

    def with_queues(self, q_node: torch.Tensor,
                    q_link: torch.Tensor) -> "QueueState":
        """Same clock, new backlogs."""
        return dataclasses.replace(self, q_node=q_node, q_link=q_link)


def advance(topo: Topology, state: QueueState, dt) -> QueueState:
    """Drain every resource at its service rate for ``dt`` seconds.

    q <- max(q - mu * dt, 0) on nodes and links, with ``q - mu * dt``
    rounded once as the reference's contracted form is
    (:func:`~repro_torch.core.numerics.fma_f32`); clock <- clock + dt.
    ``clock`` is float32 as in the reference, so accumulating it here loses
    sub-second ticks once it exceeds ~2^24 s; long-lived drivers keep an
    authoritative float64 clock on the host and stamp ``state.clock``.
    """
    dt = _f32(dt, state.clock.device)
    return QueueState(
        q_node=torch.clamp(fma_f32(-topo.mu_node, dt, state.q_node), min=0.0),
        q_link=torch.clamp(fma_f32(-topo.mu_link, dt, state.q_link), min=0.0),
        # repro-lint: disable=RL005 -- single-step add, as the reference's;
        clock=state.clock + dt,  # long-lived drivers re-stamp it from f64
    )


def backlog_seconds(topo: Topology, state: QueueState) -> float:
    """Worst-resource residual wait: max over nodes/links of Q / mu (host)."""
    mu_n = topo.mu_node.cpu().numpy().astype(np.float64)
    mu_l = topo.mu_link.cpu().numpy().astype(np.float64)
    q_n = state.q_node.cpu().numpy().astype(np.float64)
    q_l = state.q_link.cpu().numpy().astype(np.float64)
    node_wait = np.where(mu_n > 0, q_n / np.maximum(mu_n, 1e-30), 0.0)
    link_wait = np.where(mu_l > 0, q_l / np.maximum(mu_l, 1e-30), 0.0)
    return float(max(node_wait.max(initial=0.0), link_wait.max(initial=0.0)))


def total_backlog(state: QueueState) -> tuple[float, float]:
    """(sum of node backlogs in FLOPs, sum of link backlogs in bytes)."""
    return (float(state.q_node.cpu().numpy().astype(np.float64).sum()),
            float(state.q_link.cpu().numpy().astype(np.float64).sum()))
