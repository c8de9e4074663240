"""Routing-integrated serving scheduler: the paper's technique, deployed.

Counterpart of ``repro.serving.scheduler`` with the fluid drain.  A
serving cluster (accelerator slices + edge ingress points + interconnect)
is the paper's computing network: slice i is node i with ``mu_u`` =
achievable FLOP/s, interconnect hops are links with ``mu_uv`` bytes/s, and
the per-slice backlog of scheduled work is the queue vector Q that the
formulation charges waiting time against.

The scheduler holds one immutable :class:`~repro_torch.core.state.Topology`
and a :class:`~repro_torch.core.state.QueueState` that evolves: a commit
grows it, :meth:`RoutedScheduler.advance` drains it at effective rates
(``q <- max(q - mu dt, 0)``) while the clock runs.  Every batch of
requests becomes :class:`InferenceJob`s through the architectures' cost
profiles and is placed by ``solvers.solve`` (greedy by default): each
request gets the nodes computing each layer range and a priority.  The
solver's :class:`~repro_torch.core.plan.Plan` is stored whole;
:class:`Placement` objects are per-job views of it.

Not ported yet (ROADMAP Queue 1 item 8): the exact drain and its ledger
(``drain="exact"``), the commit log (``track_commits=True``), the event
engine choice (``sim_engine``), cross-window fused solves
(``schedule_windows``), ``warmup``, ``replan_last`` and ``stats``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import jobs as J, network as N, solvers
from repro_torch.core.plan import Plan
from repro_torch.core.state import Topology, effective_topology

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 8)"


def check_slowdown_factor(factor: float) -> float:
    """Validate a straggler slowdown factor (the "factor=2 means half
    speed" convention): must be finite and > 0, since the effective
    topology divides by it."""
    factor = float(factor)
    if not np.isfinite(factor) or factor <= 0:
        raise ValueError(
            f"slowdown factor must be finite and > 0 (factor=2 means half "
            f"speed, factor=1 restores full health), got {factor}")
    return factor


@dataclasses.dataclass(frozen=True)
class Placement:
    """View over one job of a stored :class:`Plan`."""

    plan: Plan
    job: int                    # row in the plan
    job_name: str
    num_layers: int

    @property
    def priority(self) -> int:
        return int(self.plan.priority[self.job])

    @property
    def assign(self) -> np.ndarray:
        """[L] node per (real) layer."""
        return self.plan.job_assign(self.job, self.num_layers)

    @property
    def bound_s(self) -> float:
        """Completion-time upper bound."""
        return float(self.plan.bounds[self.job])

    @property
    def nodes_used(self) -> list[int]:
        seen = []
        for n in self.assign:
            if not seen or seen[-1] != n:
                seen.append(int(n))
        return seen


@dataclasses.dataclass
class Request:
    arch: str
    src: int
    dst: int
    seq_len: int = 2048
    batch: int = 1
    name: str = ""


def requests_to_jobs(requests: list[Request]) -> list[J.InferenceJob]:
    """Cost-profile each request into an :class:`InferenceJob`."""
    infer_jobs = []
    for i, r in enumerate(requests):
        comp, data = registry.cost_profile(r.arch, seq_len=r.seq_len,
                                           batch=r.batch)
        infer_jobs.append(J.InferenceJob(
            r.name or f"req{i}", r.src, r.dst,
            comp.astype(np.float32), data.astype(np.float32)))
    return infer_jobs


class RoutedScheduler:
    def __init__(self, net: N.ComputeNetwork | Topology, *,
                 method: str = "greedy", drain: str = "fluid",
                 track_commits: bool = False, sim_engine: str | None = None,
                 **solver_opts):
        if drain == "exact":
            raise NotImplementedError(f"drain='exact' {_NOT_PORTED}")
        if drain != "fluid":
            raise ValueError(f"drain must be 'fluid' or 'exact', got "
                             f"{drain!r}")
        if track_commits:
            raise NotImplementedError(f"track_commits=True {_NOT_PORTED}")
        if sim_engine is not None:
            raise NotImplementedError(f"sim_engine {_NOT_PORTED}")
        if isinstance(net, Topology):
            self.topology = net
            self.state = net.empty_state()
        else:
            self.topology = net.topology
            self.state = net.state
        self.method = method
        self.solver_opts = solver_opts
        # Authoritative clock, host-side float64: ``state.clock`` (float32)
        # is only ever stamped from it, never summed.
        self._now = float(self.state.clock.item())
        self._slowdown = np.ones((self.topology.num_nodes,), np.float32)
        # Availability masks: failed nodes lose compute and every incident
        # link; links can also fail alone.
        self._avail_node = np.ones((self.topology.num_nodes,), bool)
        self._link_up = np.ones((self.topology.num_nodes,) * 2, bool)
        self.last_plan: Plan | None = None
        # Solver wall time: of the last call and summed over all calls.
        self.last_solve_s: float = 0.0
        self.total_solve_s: float = 0.0

    @property
    def net(self) -> N.ComputeNetwork:
        """Current composed view (base topology + live queue state)."""
        return self.topology.view(self.state)

    # -- cluster health / time ---------------------------------------------
    def _check_node(self, node: int) -> int:
        node = int(node)
        if not (0 <= node < self.topology.num_nodes):
            raise ValueError(f"node {node} out of range "
                             f"[0, {self.topology.num_nodes})")
        return node

    def report_slowdown(self, node: int, factor: float) -> None:
        """Straggling slice: effective mu_u /= factor from now on
        ("factor=2 means half speed"; ``factor=1`` restores full health).
        Raises ``ValueError`` for a non-finite or non-positive factor and
        for a node outside the topology."""
        factor = check_slowdown_factor(factor)
        self._slowdown[self._check_node(node)] = factor

    def report_recovery(self, node: int) -> None:
        """Straggler cleared: the node's factor goes back to 1.0."""
        self.report_slowdown(self._check_node(node), 1.0)

    @property
    def degraded(self) -> bool:
        """Any node or link currently failed?"""
        return not (self._avail_node.all() and self._link_up.all())

    def set_node_availability(self, node: int, up: bool) -> None:
        """The node (and every incident link) fails or recovers from now
        on; recovery restores full health (slowdown factor 1.0)."""
        node = self._check_node(node)
        self._avail_node[node] = bool(up)
        if up:
            self._slowdown[node] = 1.0

    def set_link_availability(self, u: int, v: int, up: bool) -> None:
        """One *directed* link (u -> v) fails or recovers; callers modeling
        a bidirectional cut flip both directions.  Raises for a link that
        does not exist in the base topology."""
        u, v = self._check_node(u), self._check_node(v)
        if float(self.topology.mu_link[u, v]) <= 0:
            raise ValueError(
                f"link ({u}, {v}) does not exist in the topology "
                f"(mu_link[{u}, {v}] == 0); availability events apply "
                f"to real links only")
        self._link_up[u, v] = bool(up)

    def _effective_topology(self) -> Topology:
        if not self.degraded:
            return effective_topology(self.topology, self._slowdown)
        return effective_topology(self.topology, self._slowdown,
                                  self._avail_node, self._link_up)

    def advance(self, dt: float) -> None:
        """Let ``dt`` seconds pass: the backlog drains at effective rates
        and the clock moves forward."""
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self.state = self.state.advance(self._effective_topology(), dt)
        self._now += float(dt)
        self._stamp_clock()

    def _stamp_clock(self) -> None:
        self.state = dataclasses.replace(
            self.state, clock=torch.tensor(self._now, dtype=torch.float32,
                                           device=self.topology.device))

    @property
    def clock(self) -> float:
        return self._now

    def drain(self) -> None:
        """All scheduled work finished: reset queues (clock preserved)."""
        self.state = self.state.with_queues(
            torch.zeros_like(self.state.q_node),
            torch.zeros_like(self.state.q_link))
        self.last_plan = None

    # -- placement ----------------------------------------------------------
    def _placements(self, plan: Plan,
                    infer_jobs: list[J.InferenceJob]) -> list[Placement]:
        # Walk priority slots directly, so the list is born sorted.
        return [Placement(plan=plan, job=int(j), job_name=infer_jobs[j].name,
                          num_layers=infer_jobs[j].num_layers)
                for j in plan.order]

    def presolve(self, infer_jobs: list[J.InferenceJob], *,
                 pad_to: int | None = None, method: str | None = None
                 ) -> tuple[J.JobBatch, Plan]:
        """Pure candidate solve against the current state: no commit, no
        queue or telemetry mutation."""
        batch = J.batch_jobs(infer_jobs, pad_to=pad_to,
                             device=self.topology.device)
        method = self.method if method is None else method
        plan = solvers.solve(self._effective_topology(), batch,
                             method=method, state=self.state,
                             **self.solver_opts)
        return batch, plan

    def commit_presolved(self, infer_jobs: list[J.InferenceJob],
                         batch: J.JobBatch, plan: Plan) -> list[Placement]:
        """Commit a plan solved by :meth:`presolve` against the unchanged
        current state: the second half of :meth:`schedule_jobs`.  (Every
        ported solver returns its committed queues in ``plan.net``.)"""
        # Committed backlogs come from the plan; the clock is ours to keep.
        self.state = self.state.with_queues(plan.net.q_node, plan.net.q_link)
        self.last_plan = plan
        self.last_solve_s = float(plan.meta.get("solve_s", 0.0))
        self.total_solve_s += self.last_solve_s
        return self._placements(plan, infer_jobs)

    def schedule_jobs(self, infer_jobs: list[J.InferenceJob], *,
                      pad_to: int | None = None, method: str | None = None
                      ) -> list[Placement]:
        """Place pre-built :class:`InferenceJob`s; ``method`` overrides
        the configured solver for this batch only."""
        batch, plan = self.presolve(infer_jobs, pad_to=pad_to, method=method)
        return self.commit_presolved(infer_jobs, batch, plan)

    def schedule(self, requests: list[Request]) -> list[Placement]:
        return self.schedule_jobs(requests_to_jobs(requests))

    def schedule_windows(self, *args, **kwargs):
        raise NotImplementedError(f"schedule_windows {_NOT_PORTED}")

    def warmup(self, *args, **kwargs):
        raise NotImplementedError(f"warmup {_NOT_PORTED}")

    def replan_last(self, *args, **kwargs):
        raise NotImplementedError(f"replan_last {_NOT_PORTED}")

    def stats(self):
        raise NotImplementedError(f"stats {_NOT_PORTED}")
