"""The canonical solver result: one :class:`Plan` for every algorithm.

Counterpart of ``repro.core.plan``; the JSON form is the same, so a plan
written by either package loads in the other.

The paper's point is that node selection and path selection collapse into a
single routing problem on the layered graph; accordingly every solver —
greedy (Alg. 1), lazy greedy, simulated annealing (Alg. 2), the exact
oracles — returns the *same* artifact.  A ``Plan`` pins down a full
multi-job solution:

  * ``assign  [J, Lmax]`` — compute node of each (real) layer of each job,
  * ``priority [J]``      — priority slot of each job (0 = highest),
  * ``bounds  [J]``       — per-job fictitious-system completion bounds
                            C_j(Q_p) evaluated at that job's priority level,
  * ``paths``             — optional explicit per-layer transfer hop lists
                            (filled by :meth:`replay`; consumed by the
                            event-driven simulator),
  * ``net``               — optional final queue state after committing all
                            jobs (what a scheduler carries forward),
  * ``solver`` / ``meta`` — provenance: which algorithm produced it and any
                            solver-specific metadata (iteration history,
                            routing counts, ...).

``to_dict()``/``from_dict()`` round-trip losslessly through JSON so plans
can be shipped over the serving control plane, cached, or diffed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..device import resolve_device
from .network import ComputeNetwork

# Explicit hop lists: paths[j][l] = ((u, v), ...) for layer-l output of job j.
PathTable = dict[int, list[list[tuple[int, int]]]]

_PLAN_VERSION = 1


def _jsonable(x: Any) -> Any:
    """Best-effort conversion of metadata values to JSON-native types."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """A complete multi-job routing solution (any solver)."""

    assign: np.ndarray                 # [J, Lmax] int32
    priority: np.ndarray               # [J] int32, slot of each job
    bounds: np.ndarray                 # [J] float64 fictitious bounds
    solver: str = "unknown"
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    paths: PathTable | None = None
    net: ComputeNetwork | None = None  # final queue state after commit

    def __post_init__(self):
        object.__setattr__(self, "assign",
                           np.asarray(self.assign, np.int32))
        object.__setattr__(self, "priority",
                           np.asarray(self.priority, np.int32))
        object.__setattr__(self, "bounds",
                           np.asarray(self.bounds, np.float64))
        J = self.priority.shape[0]
        if self.assign.shape[0] != J or self.bounds.shape[0] != J:
            raise ValueError("assign/priority/bounds disagree on J")
        if sorted(self.priority.tolist()) != list(range(J)):
            raise ValueError("priority must be a permutation of 0..J-1")

    # -- structure ----------------------------------------------------------
    @property
    def num_jobs(self) -> int:
        return self.priority.shape[0]

    @property
    def order(self) -> np.ndarray:
        """[J] job index per priority slot (slot 0 = highest)."""
        order = np.empty_like(self.priority)
        order[self.priority] = np.arange(self.num_jobs, dtype=np.int32)
        return order

    @property
    def makespan_bound(self) -> float:
        return float(np.max(self.bounds))

    def bound(self) -> float:
        """Fictitious-system makespan bound max_j C_j(Q_p)."""
        return self.makespan_bound

    def job_assign(self, j: int, num_layers: int) -> np.ndarray:
        """Unpadded per-layer assignment of job ``j``."""
        return self.assign[j, :num_layers]

    # -- evaluation ---------------------------------------------------------
    def simulate(self, net: ComputeNetwork, batch):
        """Event-driven actual-system simulation of this plan.

        Stored transfer paths (filled by :meth:`replay` or a replaying
        solver) are used as-is — they must have been derived against this
        same ``net``; for a different network, re-derive first
        (``plan.replay(net, batch).simulate(net, batch)``).  With no stored
        paths they are recomputed by replaying against ``net`` with queues
        reset.
        """
        from . import schedule
        return schedule.simulate(net, batch, self.assign, self.order,
                                 paths=self.paths)

    def commit(self, net: ComputeNetwork, batch) -> ComputeNetwork:
        """Queue state after committing every job in priority order."""
        from . import schedule
        _, _, final = schedule.replay_solution(net, batch, self.assign,
                                               self.order)
        return final

    def replay(self, net: ComputeNetwork, batch) -> "Plan":
        """Re-derive bounds, explicit paths, and final queues against ``net``.

        Returns a new Plan with the same (assign, priority) but with
        ``bounds``/``paths``/``net`` recomputed — the way both Alg. 1 and
        Alg. 2 score a solution, so a deserialized or hand-edited plan can
        be re-validated before deployment.
        """
        from . import schedule
        bounds, paths, final = schedule.replay_solution(
            net, batch, self.assign, self.order)
        return dataclasses.replace(self, bounds=bounds, paths=paths,
                                   net=final)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        """Lossless JSON-native representation.

        assign/priority are exact (ints); bounds are float64 and JSON
        numbers are IEEE doubles, so the round-trip is bit-exact.  Queue
        state (float32) survives exactly for the same reason.
        """
        d: dict[str, Any] = {
            "version": _PLAN_VERSION,
            "solver": self.solver,
            "assign": self.assign.tolist(),
            "priority": self.priority.tolist(),
            "bounds": self.bounds.tolist(),
            "meta": _jsonable(self.meta),
        }
        if self.paths is not None:
            d["paths"] = {str(j): [[list(h) for h in layer] for layer in p]
                          for j, p in self.paths.items()}
        if self.net is not None:
            d["net"] = {
                "mu_node": self.net.mu_node.cpu().tolist(),
                "mu_link": self.net.mu_link.cpu().tolist(),
                "q_node": self.net.q_node.cpu().tolist(),
                "q_link": self.net.q_link.cpu().tolist(),
                "clock": float(self.net.clock),
            }
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], *,
                  device: str | torch.device = "cuda") -> "Plan":
        """Inverse of :meth:`to_dict`; the queue state, if any, is placed
        on ``device`` (``"cuda"`` by default; raises ``RuntimeError``
        without a card)."""
        dev = resolve_device(device)
        if int(d.get("version", 1)) != _PLAN_VERSION:
            raise ValueError(f"unsupported plan version {d.get('version')}")
        paths: PathTable | None = None
        if "paths" in d:
            paths = {int(j): [[tuple(h) for h in layer] for layer in p]
                     for j, p in d["paths"].items()}
        net = None
        if "net" in d:
            nd = d["net"]
            f32 = dict(dtype=torch.float32, device=dev)
            net = ComputeNetwork.of(
                mu_node=torch.tensor(nd["mu_node"], **f32),
                mu_link=torch.tensor(nd["mu_link"], **f32),
                q_node=torch.tensor(nd["q_node"], **f32),
                q_link=torch.tensor(nd["q_link"], **f32),
                clock=float(nd.get("clock", 0.0)),
            )
        return cls(
            assign=np.asarray(d["assign"], np.int32),
            priority=np.asarray(d["priority"], np.int32),
            bounds=np.asarray(d["bounds"], np.float64),
            solver=str(d.get("solver", "unknown")),
            meta=dict(d.get("meta", {})),
            paths=paths,
            net=net,
        )

    @classmethod
    def from_order(cls, assign, order, bounds, **kw) -> "Plan":
        """Build a Plan from slot->job ``order`` (inverts it to priority)."""
        order = np.asarray(order, np.int32)
        priority = np.empty_like(order)
        priority[order] = np.arange(order.shape[0], dtype=np.int32)
        return cls(assign=assign, priority=priority, bounds=bounds, **kw)
