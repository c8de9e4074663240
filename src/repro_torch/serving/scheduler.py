"""Routing-integrated serving scheduler: the paper's technique, deployed.

Counterpart of ``repro.serving.scheduler``.  A serving cluster
(accelerator slices + edge ingress points + interconnect) is the paper's
computing network: slice i is node i with ``mu_u`` =
achievable FLOP/s, interconnect hops are links with ``mu_uv`` bytes/s, and
the per-slice backlog of scheduled work is the queue vector Q that the
formulation charges waiting time against.

The scheduler holds one immutable :class:`~repro_torch.core.state.Topology`
and a :class:`~repro_torch.core.state.QueueState` that evolves: a commit
grows it, :meth:`RoutedScheduler.advance` drains it while the clock runs.
Two drain models (``drain="fluid" | "exact"``):

  * ``"fluid"`` (default): every resource drains independently at full
    rate, ``q <- max(q - mu dt, 0)``.
  * ``"exact"``: a :class:`~repro_torch.core.completions.CommittedWork`
    ledger records every committed plan's work items (priority and
    precedence), and time passing drains exactly those jobs through the
    preempt-resume event engine (``sim_engine="indexed" | "ref"``).  The
    solver-visible ``QueueState`` is materialised from the ledger's
    residual work, as float32 tensors on the topology's device.

``track_commits=True`` also keeps a never-drained commit log (a second
ledger), the ground-truth record a full-horizon replay reads.

Every batch of requests becomes :class:`InferenceJob`s through the
architectures' cost profiles and is placed by ``solvers.solve`` (greedy by
default): each request gets the nodes computing each layer range and a
priority.  The solver's :class:`~repro_torch.core.plan.Plan` is stored
whole; :class:`Placement` objects are per-job views of it.
:meth:`RoutedScheduler.schedule_windows` places several queued windows
through ``solvers.solve_fused``; ``replan_last`` re-places the most recent
batch against updated cluster health.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import (completions as C, jobs as J, network as N,
                              schedule, solvers)
from repro_torch.core.plan import Plan
from repro_torch.core.state import QueueState, Topology, effective_topology


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
    drain_queues: bool = True  # OnlineScheduler's no-drain baseline flips this

    def __init__(self, net: N.ComputeNetwork | Topology, *,
                 method: str = "greedy", drain: str = "fluid",
                 track_commits: bool = False, sim_engine: str = "indexed",
                 **solver_opts):
        if isinstance(net, Topology):
            self.topology = net
            self.state = net.empty_state()
        else:
            self.topology = net.topology
            self.state = net.state
        if drain not in ("fluid", "exact"):
            raise ValueError(
                f"drain must be 'fluid' or 'exact', got {drain!r}")
        if sim_engine not in ("indexed", "ref"):
            raise ValueError(
                f"sim_engine must be 'indexed' or 'ref', got {sim_engine!r}")
        self.method = method
        # Exact-drain event engine: "indexed" (persistent index threaded
        # through drains, commits and replans) or "ref" (the linear scan).
        self.sim_engine = sim_engine
        self.solver_opts = solver_opts
        # Authoritative clock, host-side float64: ``state.clock`` (float32)
        # is only ever stamped from it, never summed.
        self._now = float(self.state.clock.item())
        self._slowdown = np.ones((self.topology.num_nodes,), np.float32)
        # Availability masks: failed nodes lose compute and every incident
        # link; links can also fail alone.
        self._avail_node = np.ones((self.topology.num_nodes,), bool)
        self._link_up = np.ones((self.topology.num_nodes,) * 2, bool)
        self.drain_mode = drain
        # Live registry of committed InferenceJobs (exact mode): the fault
        # policies rebuild residual jobs from it when a resource fails.
        self.inflight_jobs: dict[str, J.InferenceJob] = {}
        # Exact mode: the ledger is the source of truth for backlogs.
        self.ledger: C.CommittedWork | None = (
            C.CommittedWork.empty(self.topology.num_nodes, clock=self._now)
            if drain == "exact" else None)
        # Optional never-drained commit log (ground-truth replay record).
        self.commit_log: C.CommittedWork | None = (
            C.CommittedWork.empty(self.topology.num_nodes, clock=self._now)
            if track_commits else None)
        # (batch, jobs, pre-batch state, health + clock + ledgers at snapshot)
        self._last: tuple[J.JobBatch, list[J.InferenceJob], QueueState,
                          Topology, float, C.CommittedWork | None,
                          C.CommittedWork | None] | None = None
        self.last_plan: Plan | None = None
        # Why the most recent replan_last() call did / did not commit:
        # None (never called) | "replanned" | "no_batch" | "no_improvement".
        self.last_replan_reason: str | None = None
        # Solver wall time of the last call; the streaming pipeline's
        # "measured" latency model reads it.
        self.last_solve_s: float = 0.0

    @property
    def net(self) -> N.ComputeNetwork:
        """Current composed view (base topology + live queue state)."""
        return self.topology.view(self.state)

    @property
    def base_net(self) -> N.ComputeNetwork:
        """Healthy-capacity view with empty queues."""
        return self.topology.view()

    # -- cluster health / time ---------------------------------------------
    def _check_node(self, node: int) -> int:
        node = int(node)
        if not (0 <= node < self.topology.num_nodes):
            raise ValueError(f"node {node} out of range "
                             f"[0, {self.topology.num_nodes})")
        return node

    def _check_slowdown(self, node: int, factor: float) -> float:
        """Validate a slowdown event's arguments (raises ``ValueError``)."""
        factor = check_slowdown_factor(factor)
        self._check_node(node)
        return factor

    def report_slowdown(self, node: int, factor: float) -> None:
        """Straggling slice: effective mu_u /= factor from now on
        ("factor=2 means half speed"; ``factor=1`` restores full health).
        Raises ``ValueError`` for a non-finite or non-positive factor and
        for a node outside the topology.  Recorded in the commit log's
        health history when one is kept."""
        self._slowdown[node] = self._check_slowdown(node, factor)
        if self.commit_log is not None:
            self.commit_log = self.commit_log.record_slowdown(
                self._now, node, self._slowdown[node])

    def report_recovery(self, node: int) -> None:
        """Straggler cleared: the node's factor goes back to 1.0."""
        self.report_slowdown(self._check_node(node), 1.0)

    @property
    def degraded(self) -> bool:
        """Any node or link currently failed?"""
        return not (self._avail_node.all() and self._link_up.all())

    def set_node_availability(self, node: int, up: bool) -> None:
        """The node (and every incident link) fails or recovers from now
        on; recovery restores full health (slowdown factor 1.0).  Recorded
        in the commit log's health history as ``factor=inf`` (down) /
        ``1.0`` (up)."""
        node = self._check_node(node)
        self._avail_node[node] = bool(up)
        if up:
            self._slowdown[node] = 1.0
        if self.commit_log is not None:
            self.commit_log = self.commit_log.record_health(
                self._now, node, 1.0 if up else np.inf)

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
        if self.commit_log is not None:
            self.commit_log = self.commit_log.record_health(
                self._now, ("link", u, v), 1.0 if up else np.inf)

    def _down_keys(self) -> tuple:
        """Engine-facing resource keys currently failed (() when healthy)."""
        if not self.degraded:
            return ()
        return C.down_keys(self.topology, self._avail_node, self._link_up)

    def _effective_topology(self) -> Topology:
        if not self.degraded:
            return effective_topology(self.topology, self._slowdown)
        return effective_topology(self.topology, self._slowdown,
                                  self._avail_node, self._link_up)

    def _drain_state(self, dt: float) -> None:
        """Advance backlogs ``dt`` seconds at effective (health-aware) rates
        under the configured drain model.  Does not move the clock."""
        if self.drain_mode == "exact":
            self.ledger = C.drain_exact(self._effective_topology(),
                                        self.ledger, dt,
                                        engine=self.sim_engine,
                                        down=self._down_keys())
            self._sync_ledger_queues()
        else:
            self.state = self.state.advance(self._effective_topology(), dt)

    def _queues_of(self, ledger: C.CommittedWork):
        """The ledger's residual work as float32 tensors on the device."""
        dev = self.topology.device
        return tuple(torch.from_numpy(q).to(dev)
                     for q in ledger.queue_arrays())

    def _sync_ledger_queues(self) -> None:
        """Materialise the ledger's residual work into the QueueState."""
        self.state = self.state.with_queues(*self._queues_of(self.ledger))

    def advance(self, dt: float) -> None:
        """Let ``dt`` seconds pass: the backlog drains at effective rates
        (fluid or exact per ``drain_mode``) and the clock moves forward."""
        if dt < 0:
            raise ValueError(f"dt must be >= 0, got {dt}")
        self._drain_state(dt)
        self._now += float(dt)
        self._stamp_clock()

    def _clock_tensor(self) -> torch.Tensor:
        return torch.tensor(self._now, dtype=torch.float32,
                            device=self.topology.device)

    def _stamp_clock(self) -> None:
        self.state = dataclasses.replace(self.state,
                                         clock=self._clock_tensor())

    @property
    def clock(self) -> float:
        return self._now

    def drain(self) -> None:
        """All scheduled work finished: reset queues (clock preserved).
        In exact mode the ledger's live jobs are dropped without recording
        completions; the commit log is left untouched."""
        self.state = self.state.with_queues(
            torch.zeros_like(self.state.q_node),
            torch.zeros_like(self.state.q_link))
        if self.ledger is not None:
            self.ledger = self.ledger.cleared()
        self._last = None
        self.last_plan = None

    def stats(self) -> dict:
        """Solve-time telemetry of the most recent placement: the keys of
        ``plan.meta`` among the reference's (``method``, ``solve_s``,
        ``solve_share_s``, ``closure_builds``, ``n_routings``, ...), plus
        the port's ``rounds`` and ``kernel_launches``.  The port has no
        jit, so it reports no ``jit_compiled``."""
        if self.last_plan is None:
            return {}
        m = self.last_plan.meta
        return {k: m[k] for k in ("method", "solve_s", "solve_share_s",
                                  "closure_builds", "n_routings", "rounds",
                                  "kernel_launches", "jit_compiled")
                if k in m}

    # -- placement ----------------------------------------------------------
    def _placements(self, plan: Plan,
                    infer_jobs: list[J.InferenceJob]) -> list[Placement]:
        # Walk priority slots directly, so the list is born sorted.
        return [Placement(plan=plan, job=int(j), job_name=infer_jobs[j].name,
                          num_layers=infer_jobs[j].num_layers)
                for j in plan.order]

    # Solvers that fill plan.paths during the solve from each round's
    # closures; for any other method _ledger_commit replays the solution.
    _PATH_SOLVERS = ("greedy", "greedy_ref", "lazy")

    def _solve_opts(self, method: str) -> dict:
        if ((self.ledger is not None or self.commit_log is not None)
                and method in self._PATH_SOLVERS):
            return {"extract_paths": True, **self.solver_opts}
        return self.solver_opts

    def _commit_plan(self, topo: Topology, batch: J.JobBatch, plan: Plan,
                     pre_state: QueueState,
                     names: list[str] | None) -> Plan:
        """Commit one solved plan: queue state, ledger and commit log,
        telemetry.  Shared by :meth:`commit_presolved` and
        :meth:`schedule_windows` (``pre_state`` = the queue state the
        window was solved against)."""
        if plan.net is None:
            plan = dataclasses.replace(
                plan, net=plan.commit(topo.view(pre_state), batch))
        if self.ledger is None:
            # Committed backlogs come from the plan; the clock is ours.
            self.state = self.state.with_queues(plan.net.q_node,
                                                plan.net.q_link)
        if self.ledger is not None or self.commit_log is not None:
            plan = self._ledger_commit(topo, batch, plan, pre_state, names)
        self.last_plan = plan
        # Multi-window plans carry the call's wall in solve_s and their
        # share in solve_share_s; keep the share.
        self.last_solve_s = float(plan.meta.get(
            "solve_share_s", plan.meta.get("solve_s", 0.0)))
        return plan

    def _ledger_commit(self, topo: Topology, batch: J.JobBatch, plan: Plan,
                       pre_state: QueueState,
                       names: list[str] | None) -> Plan:
        """Record the committed plan's work items (exact ledger and/or the
        ground-truth commit log)."""
        if plan.paths is None:
            # Paths against the solve-time queue state: exactly the hops
            # the plan's bounds charged.
            _, paths, _ = schedule.replay_solution(
                topo.view(pre_state), batch, plan.assign, plan.order)
            plan = dataclasses.replace(plan, paths=paths)
        if self.ledger is not None:
            self.ledger = self.ledger.commit(batch, plan, names=names,
                                             at=self._now)
            if self.sim_engine == "indexed":
                # The first commit births the persistent index; later
                # commits extend it in place.
                self.ledger = C.warm_engine(topo, self.ledger)
            self._sync_ledger_queues()
        if self.commit_log is not None:
            self.commit_log = self.commit_log.commit(batch, plan,
                                                     names=names,
                                                     at=self._now)
        return plan

    def _register_inflight(self, infer_jobs: list[J.InferenceJob]) -> None:
        """Exact mode: keep the committed jobs for the fault policies,
        pruning dead entries once they dominate (amortised O(1) a job)."""
        if self.ledger is None:
            return
        for j in infer_jobs:
            self.inflight_jobs[j.name] = j
        if (len(self.inflight_jobs) >= 2048
                and len(self.inflight_jobs) > 2 * len(self.ledger.jobs)):
            live = {j.name for j in self.ledger.jobs}
            self.inflight_jobs = {n: j for n, j in
                                  self.inflight_jobs.items() if n in live}

    def presolve(self, infer_jobs: list[J.InferenceJob], *,
                 pad_to: int | None = None, method: str | None = None
                 ) -> tuple[J.JobBatch, Plan]:
        """Pure candidate solve against the current state: no commit, no
        queue, ledger or telemetry mutation."""
        batch = J.batch_jobs(infer_jobs, pad_to=pad_to,
                             device=self.topology.device)
        method = self.method if method is None else method
        plan = solvers.solve(self._effective_topology(), batch,
                             method=method, state=self.state,
                             **self._solve_opts(method))
        return batch, plan

    def commit_presolved(self, infer_jobs: list[J.InferenceJob],
                         batch: J.JobBatch, plan: Plan) -> list[Placement]:
        """Commit a plan solved by :meth:`presolve` against the unchanged
        current state: the second half of :meth:`schedule_jobs`."""
        pre_state = self.state
        pre_ledger, pre_log = self.ledger, self.commit_log
        plan = self._commit_plan(self._effective_topology(), batch, plan,
                                 pre_state, [j.name for j in infer_jobs])
        # Recorded only after the commit succeeds, so a raising solver
        # cannot poison replan_last() with a batch never scheduled.
        self._last = (batch, infer_jobs, pre_state,
                      self._effective_topology(), self._now,
                      pre_ledger, pre_log)
        self._register_inflight(infer_jobs)
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

    def schedule_windows(self, windows: list[list[J.InferenceJob]], *,
                         pad_to: int | None = None,
                         method: str | None = None) -> list[list[Placement]]:
        """Place several queued arrival windows in one solver call.

        Windows are solved in order, each against the previous window's
        committed queues (``solvers.solve_fused``), then committed one at
        a time so the ledger and commit log match W sequential
        :meth:`schedule_jobs` calls.  Methods other than greedy fall back
        to sequential scheduling (the same results).
        """
        method = self.method if method is None else method
        self._window_states = []
        if not windows:
            return []
        if method != "greedy" or len(windows) == 1:
            out = []
            for jobs in windows:
                out.append(self.schedule_jobs(jobs, pad_to=pad_to,
                                              method=method))
                self._window_states.append(self.state)
            return out
        topo = self._effective_topology()
        dev = self.topology.device
        batches = [J.batch_jobs(jobs, pad_to=pad_to, device=dev)
                   for jobs in windows]
        plans = solvers.solve_fused(topo, batches, state=self.state,
                                    pad_to=pad_to,
                                    **self._solve_opts(method))
        out = []
        # Per-window post-commit queue snapshots: after _commit_plan the
        # state is authoritative (ledger-synced in exact mode), so
        # telemetry reading these matches W schedule_jobs calls.
        for jobs, batch, plan in zip(windows, batches, plans):
            pre_state = self.state
            plan = self._commit_plan(topo, batch, plan, pre_state,
                                     [j.name for j in jobs])
            self._last = (batch, jobs, pre_state, topo, self._now,
                          self.ledger, self.commit_log)
            self._register_inflight(jobs)
            out.append(self._placements(plan, jobs))
            self._window_states.append(self.state)
        return out

    def warmup(self, sample_jobs: list[J.InferenceJob], *,
               pad_to: int | None = None, max_jobs: int | None = None,
               window_counts: tuple[int, ...] = ()) -> dict:
        """Throwaway solves at this deployment's serving shapes (pure: no
        queue state, ledger, clock or telemetry mutation): one per
        power-of-two job count up to ``max_jobs`` (default
        ``len(sample_jobs)``), plus one multi-window solve per entry of
        ``window_counts``.  The port has no jit, so nothing compiles
        (``compiles`` is 0); the solves build the kernels and warm the
        allocator.  Returns ``{"compiles", "wall_s", "warm_solve_s"}``:
        ``warm_solve_s`` times one more solve at the largest size, the
        seed of the streaming pipeline's "measured" latency model."""
        if self.method != "greedy" or not sample_jobs:
            return {"compiles": 0, "wall_s": 0.0, "warm_solve_s": 0.0}
        t0 = time.perf_counter()
        topo = self._effective_topology()
        dev = self.topology.device
        opts = self._solve_opts(self.method)
        top = max_jobs if max_jobs is not None else len(sample_jobs)
        sizes, s = [], 1
        while s < top:
            sizes.append(s)
            s *= 2
        sizes.append(s)
        cyc = list(itertools.islice(itertools.cycle(sample_jobs), sizes[-1]))

        def batch(jobs):
            return J.batch_jobs(jobs, pad_to=pad_to, device=dev)

        compiles = 0
        for size in sizes:
            plan = solvers.solve(topo, batch(cyc[:size]), method=self.method,
                                 state=self.state, **opts)
            compiles += int(plan.meta.get("jit_compiled", False))
        for w in window_counts:
            if w >= 2:
                plans = solvers.solve_fused(
                    topo, [batch(cyc) for _ in range(w)], state=self.state,
                    pad_to=pad_to, **opts)
                compiles += int(plans[0].meta.get("jit_compiled", False))
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        solvers.solve(topo, batch(cyc), method=self.method, state=self.state,
                      **opts)
        warm = time.perf_counter() - t1
        return {"compiles": compiles, "wall_s": wall + warm,
                "warm_solve_s": warm}

    def replan_last(self, *, min_improvement: float | None = None
                    ) -> list[Placement] | None:
        """Re-place the most recent batch against updated cluster health.

        Rolls the queue state back to just before that batch was committed
        (drained over the time elapsed since, at the snapshot's health),
        re-solves with the current health, and commits the new plan.
        Returns None if there is nothing to re-plan; ``last_replan_reason``
        records why (``no_batch`` or ``no_improvement``).

        ``min_improvement`` (default None = always commit) gates the
        commit: the old assignment is re-scored under current health and
        the rolled-back queues, and the new plan commits only if its worst
        bound beats that by the given relative margin.  A declined replan
        mutates nothing.
        """
        self.last_replan_reason = "no_batch"
        if self._last is None:
            return None
        (batch, infer_jobs, pre_state, pre_topo, pre_now,
         pre_ledger, pre_log) = self._last
        elapsed = self._now - pre_now
        ledger = None
        if self.drain_mode == "exact":
            ledger = pre_ledger
            if elapsed > 0 and self.drain_queues:
                # The snapshot's engine slot is stale, so this drain
                # rebuilds the index from the snapshot's job records.
                ledger = C.drain_exact(pre_topo, ledger, elapsed,
                                       engine=self.sim_engine)
            state = pre_state.with_queues(*self._queues_of(ledger))
        else:
            state = pre_state
            if elapsed > 0 and self.drain_queues:
                state = state.advance(pre_topo, elapsed)
        state = dataclasses.replace(state, clock=self._clock_tensor())
        topo = self._effective_topology()
        plan = solvers.solve(topo, batch, method=self.method, state=state,
                             **self._solve_opts(self.method))
        if min_improvement is not None:
            old = self.last_plan
            new_cost = float(np.asarray(plan.bounds, np.float64).max())
            if old is None:
                improved = True
            else:
                old_bounds, _, _ = schedule.replay_solution(
                    topo.view(state), batch, old.assign, old.order)
                old_cost = float(old_bounds.max())
                improved = (new_cost < old_cost * (1.0 - min_improvement)
                            - schedule.time_eps(old_cost))
            if not improved:
                self.last_replan_reason = "no_improvement"
                return None
        # Committing: apply the rollback, then the new plan.
        if self.drain_mode == "exact":
            self.ledger = ledger
        self.state = state
        # The superseded batch never ran to completion: drop it from the
        # commit log too, but keep the full health history.
        if pre_log is not None and self.commit_log is not None:
            pre_log = dataclasses.replace(pre_log,
                                          health=self.commit_log.health)
        self.commit_log = pre_log
        plan = self._commit_plan(topo, batch, plan, self.state,
                                 [j.name for j in infer_jobs])
        self.last_replan_reason = "replanned"
        return self._placements(plan, infer_jobs)
