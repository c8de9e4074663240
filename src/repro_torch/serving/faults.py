"""Fault-injected dynamic infrastructure: typed events on the serving clock.

Counterpart of ``repro.serving.faults``.  The fault layer is host-side
bookkeeping; the topology's rates come to the host once per entry point
(:func:`pick_victims`, :func:`migrate_solve`) or once per injector, never
per arrival.  ``migrate`` scores every candidate node of a job in one
batched gather over the job's closure stack (one closure build a job: one
launch of the min-plus closure kernel on the card).

A topology that only ever *slows down* (``report_slowdown``) is not the
whole story.  The target setting — 6G edge networks serving ubiquitous
AI — is defined by churn: nodes leave and rejoin, links cut, capacity
rescales with a lag.  This module is the event layer and the recovery
policies on top of the exact-drain machinery:

  * :class:`FaultEvent` / :class:`FaultSchedule` — typed infrastructure
    events on the authoritative clock: ``node_fail`` / ``node_recover``,
    ``node_join`` (standby capacity appearing mid-horizon), ``link_fail``
    / ``link_recover`` (bidirectional at this layer), and ``rescale``
    (elastic capacity change, with an actuation ``lag``).
  * :class:`FaultInjector` — applies events to an
    :class:`~repro_torch.serving.online.OnlineScheduler`, draining to the event
    instant first so everything before it is served at pre-event rates.
    A failure strands the in-flight and queued work of every committed
    plan that still needs the dead resource; the injector withdraws those
    jobs from the ledger and handles their residual work per policy:

      ``requeue``   re-plan the remaining layers onto the surviving
                    topology with the regular solver, paying re-transfer
                    from the node holding the last completed layer's
                    output (layer-0 progress restarts from the source).
      ``migrate``   operator migration: the remaining layers move to one
                    chosen node (the ``"migrate"`` solver registered
                    here — argmin of the fictitious bound over surviving
                    compute nodes), paying the transfer — the
                    sparse-framework orchestrator's policy.
      ``lost``      shed the work and account it.

    Re-placement is *bounded*: each job carries a ``#r<n>`` retry suffix,
    and a job whose residual has been re-placed ``max_retries`` times —
    e.g. because a second failure hit its requeue target mid-recovery —
    is shed with ``retries_exhausted`` instead of looping.  Jobs whose
    progress (or source/destination) sits on the failed node are shed as
    ``data_lost`` / ``unreachable``; a solver exception during
    re-placement is retried once, then shed as ``solver_error``.

  * A scenario-catalog family (:data:`FAULT_FAMILIES` /
    :func:`make_fault_schedule`): transient-node, node-join, link-flap,
    elastic, cascade — each parameterized by the scenario and horizon,
    with :func:`pick_victim` choosing the highest-capacity compute node
    that is not an ingress/egress point.

Ground truth stays exact through all of this: availability events land in
the commit log's ``health`` history (``factor=inf`` = down) and
withdrawals in its ``removed`` records, so
:func:`repro_torch.core.completions.replay_piecewise` replays the run segment
by segment — outages, blocked work, requeues and all — and must agree
with the incremental drain (``tests/test_torch_faults.py`` holds it).

Training-side fault *tolerance* (checkpoint/rollback across data-parallel
replicas) lives in :mod:`repro_torch.distributed.fault`; this module is the
serving-side counterpart where work is rerouted rather than recomputed
from a checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core import jobs as J, routing, shortest_path as SP, solvers
from repro_torch.core.completions import LedgerJob
from repro_torch.core.plan import Plan

KINDS = ("node_fail", "node_recover", "node_join", "link_fail",
         "link_recover", "rescale")
POLICIES = ("requeue", "migrate", "lost")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One typed infrastructure event at an absolute instant.

    ``node`` is the subject of node events and ``rescale``; ``link`` the
    (u, v) pair of link events — link failures are bidirectional here
    (the injector flips both directed links); ``factor`` is the
    ``rescale`` capacity multiple (2.0 = doubled, 0.5 = halved, absolute
    w.r.t. nominal — not cumulative).
    """

    time: float
    kind: str
    node: int = -1
    link: tuple[int, int] | None = None
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"valid: {', '.join(KINDS)}")
        if self.kind.startswith("link"):
            if self.link is None:
                raise ValueError(f"{self.kind} needs link=(u, v)")
        elif self.node < 0:
            raise ValueError(f"{self.kind} needs node=")
        if self.kind == "rescale" and not (np.isfinite(self.factor)
                                           and self.factor > 0):
            raise ValueError(
                f"rescale factor must be finite and > 0, got {self.factor}")
        if not np.isfinite(self.time):
            raise ValueError(f"event time must be finite, got {self.time}")


def node_fail(t: float, node: int) -> FaultEvent:
    return FaultEvent(float(t), "node_fail", node=int(node))


def node_recover(t: float, node: int) -> FaultEvent:
    return FaultEvent(float(t), "node_recover", node=int(node))


def node_join(t: float, node: int) -> FaultEvent:
    """Standby capacity joins at ``t`` (pair with a ``node_fail`` at the
    horizon start to model a node that wasn't there yet — keeps every
    array shape static/jit-stable)."""
    return FaultEvent(float(t), "node_join", node=int(node))


def link_fail(t: float, u: int, v: int) -> FaultEvent:
    return FaultEvent(float(t), "link_fail", link=(int(u), int(v)))


def link_recover(t: float, u: int, v: int) -> FaultEvent:
    return FaultEvent(float(t), "link_recover", link=(int(u), int(v)))


def capacity_rescale(t: float, node: int, scale: float,
                     *, lag: float = 0.0) -> FaultEvent:
    """Elastic capacity change: the node runs at ``scale`` x nominal from
    ``t + lag`` on (``lag`` models actuation delay — autoscalers don't
    take effect the instant they decide)."""
    return FaultEvent(float(t) + float(lag), "rescale", node=int(node),
                      factor=float(scale))


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A time-sorted sequence of fault events (construction sorts)."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events,
                                        key=lambda ev: ev.time)))

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def validate(self, num_nodes: int) -> "FaultSchedule":
        for ev in self.events:
            nodes = ev.link if ev.link is not None else (ev.node,)
            for u in nodes:
                if not (0 <= int(u) < num_nodes):
                    raise ValueError(
                        f"fault event {ev} references node {u} outside "
                        f"[0, {num_nodes})")
        return self


# -- scenario catalog ---------------------------------------------------------

def pick_victims(scenario, n: int = 1) -> list[int]:
    """The ``n`` highest-capacity compute nodes that are not ingress/egress
    points (falling back to ingress/egress compute nodes when the family
    has no interior compute) — the nodes whose failure actually strands
    committed work without severing the traffic endpoints."""
    mu = scenario.topology.mu_node.cpu().numpy().astype(np.float64)
    endpoints = set(scenario.ingress) | set(scenario.egress)
    ranked = [int(u) for u in np.argsort(-mu) if mu[u] > 0]
    cand = [u for u in ranked if u not in endpoints]
    cand += [u for u in ranked if u in endpoints]   # fallback pool
    if len(cand) < n:
        raise ValueError(
            f"scenario {scenario.name!r} has only {len(cand)} "
            f"compute-capable node(s); cannot pick {n} victims")
    return cand[:n]


def pick_victim(scenario) -> int:
    return pick_victims(scenario, 1)[0]


def pick_victim_link(scenario) -> tuple[int, int]:
    """The victim node's highest-capacity outgoing link."""
    v = pick_victim(scenario)
    mu_l = scenario.topology.mu_link.cpu().numpy().astype(np.float64)
    w = int(np.argmax(mu_l[v]))
    if mu_l[v, w] <= 0:
        raise ValueError(f"victim node {v} of scenario {scenario.name!r} "
                         f"has no outgoing links")
    return v, w


def _transient_node(scenario, horizon: float) -> list[FaultEvent]:
    v = pick_victim(scenario)
    return [node_fail(0.35 * horizon, v), node_recover(0.65 * horizon, v)]


def _node_join(scenario, horizon: float) -> list[FaultEvent]:
    v = pick_victim(scenario)
    return [node_fail(0.0, v), node_join(0.45 * horizon, v)]


def _link_flap(scenario, horizon: float) -> list[FaultEvent]:
    u, v = pick_victim_link(scenario)
    out = []
    for a, b in ((0.30, 0.40), (0.50, 0.60)):
        out += [link_fail(a * horizon, u, v), link_recover(b * horizon, u, v)]
    return out


def _elastic(scenario, horizon: float) -> list[FaultEvent]:
    v = pick_victim(scenario)
    lag = 0.05 * horizon
    return [capacity_rescale(0.30 * horizon, v, 0.5, lag=lag),
            capacity_rescale(0.65 * horizon, v, 1.0, lag=lag)]


def _cascade(scenario, horizon: float) -> list[FaultEvent]:
    """A second failure lands mid-recovery of the first: requeued work can
    be hit again, exercising the bounded-retry path."""
    v1, v2 = pick_victims(scenario, 2)
    return [node_fail(0.30 * horizon, v1), node_fail(0.45 * horizon, v2),
            node_recover(0.70 * horizon, v1),
            node_recover(0.80 * horizon, v2)]


FAULT_FAMILIES = {
    "transient-node": _transient_node,
    "node-join": _node_join,
    "link-flap": _link_flap,
    "elastic": _elastic,
    "cascade": _cascade,
}


def make_fault_schedule(family: str, scenario, horizon: float,
                        *, seed: int = 0) -> FaultSchedule:
    """Build a named fault schedule against a scenario and horizon.

    ``seed`` jitters each event time by up to ±2% of the horizon (event
    order is preserved by construction — the nominal instants are spaced
    wider than the jitter), so repeated benchmark runs don't all fault at
    the same phase of the arrival process.
    """
    try:
        gen = FAULT_FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown fault family {family!r}; available: "
            f"{', '.join(sorted(FAULT_FAMILIES))}") from None
    rng = np.random.default_rng(seed)
    events = []
    for ev in gen(scenario, float(horizon)):
        jitter = float((rng.random() - 0.5) * 0.04 * horizon)
        events.append(dataclasses.replace(
            ev, time=float(np.clip(ev.time + jitter, 0.0, horizon))))
    return FaultSchedule(tuple(events)).validate(scenario.num_nodes)


# -- the migrate solver -------------------------------------------------------

@solvers.register("migrate")
def migrate_solve(net, batch, **opts) -> Plan:
    """Operator migration: each job's (remaining) layers on ONE node.

    For every job, the fictitious completion bound of the all-layers-on-w
    assignment is evaluated for every surviving compute node w (one
    batched call over the candidates, closures built once per job) and the
    argmin is committed — transfers in (from wherever the job's data sits)
    and out (to its destination) are paid through the same min-cost paths
    as any other plan.  Jobs are placed in batch order (= priority order),
    each against the queues its predecessors built, exactly like the
    greedy solver — so migrated work keeps spreading over nodes instead of
    piling onto one.
    """
    mu = net.mu_node.cpu().numpy().astype(np.float64)
    cand = np.flatnonzero(mu > 0)
    if cand.size == 0:
        raise ValueError("migrate: no compute-capable node is available")
    Jn, Lmax = batch.num_jobs, batch.max_layers
    host = batch.to_numpy()
    assign = np.zeros((Jn, Lmax), np.int32)
    bounds = np.zeros((Jn,), np.float64)
    cand_assign = np.repeat(cand[:, None], Lmax, axis=1)     # [C, Lmax]
    cur = net
    for j in range(Jn):
        args = (host["comp"][j], batch.data[j], host["src"][j],
                host["dst"][j], host["num_layers"][j])
        cl = SP.build_closures(cur, batch.data[j])
        costs = routing.cost_given_assignments(cur, *args, cand_assign,
                                               closures=cl)
        best = int(np.argmin(costs))
        bounds[j] = float(costs[best])
        assign[j, :] = cand[best]
        cur = routing.commit_assignment(cur, *args, assign[j], closures=cl)
    return Plan.from_order(assign, np.arange(Jn, dtype=np.int32), bounds,
                           solver="migrate", net=cur,
                           meta={"n_routings": int(Jn) * int(cand.size)})


# -- the injector -------------------------------------------------------------

def _parse_retry(name: str) -> tuple[str, int]:
    """``"x#r2" -> ("x", 2)``; names without a retry suffix are attempt 0."""
    base, sep, n = name.rpartition("#r")
    if sep and n.isdigit():
        return base, int(n)
    return name, 0


class FaultInjector:
    """Applies :class:`FaultEvent`s to an online scheduler, handling the
    stranded work of failed resources per recovery ``policy``.

    Requires ``drain="exact"``: the recovery policies reconstruct each
    affected job's residual (remaining layers + the node holding its last
    completed layer's output) from the committed-work ledger — the fluid
    model has no per-job progress to recover from.
    """

    def __init__(self, sched, *, policy: str = "requeue",
                 max_retries: int = 3, pad_to: int | None = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if getattr(sched, "ledger", None) is None:
            raise ValueError(
                "fault injection requires drain='exact': recovery policies "
                "reconstruct residual jobs from the committed-work ledger")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.sched = sched
        self.policy = policy
        self.max_retries = int(max_retries)
        self.pad_to = pad_to
        self.log: list[dict] = []
        # Host copies of the base topology's rates, for routable(), which
        # runs on every arrival while the cluster is degraded.
        self._has_link = sched.topology.mu_link.cpu().numpy() > 0
        self._has_compute = sched.topology.mu_node.cpu().numpy() > 0

    def apply(self, ev: FaultEvent) -> dict:
        """Drain to the event instant (pre-event rates), apply it, and —
        for failures — withdraw and re-place/shed stranded work.  Returns
        (and logs) a record of what happened."""
        sched = self.sched
        sched.advance_to(ev.time)
        rec: dict = {"time": float(ev.time), "event": ev.kind,
                     "policy": self.policy}
        if ev.kind == "rescale":
            rec["node"], rec["factor"] = ev.node, ev.factor
            sched.report_slowdown(ev.node, 1.0 / ev.factor)
        elif ev.kind in ("node_recover", "node_join"):
            rec["node"] = ev.node
            sched.set_node_availability(ev.node, True)
        elif ev.kind == "link_recover":
            u, v = ev.link
            rec["link"] = (u, v)
            sched.set_link_availability(u, v, True)
            sched.set_link_availability(v, u, True)
        elif ev.kind == "node_fail":
            rec["node"] = ev.node
            sched.set_node_availability(ev.node, False)
            self._handle_outage(rec)
        else:  # link_fail
            u, v = ev.link
            rec["link"] = (u, v)
            sched.set_link_availability(u, v, False)
            sched.set_link_availability(v, u, False)
            self._handle_outage(rec)
        self.log.append(rec)
        return rec

    # -- outage handling -----------------------------------------------------
    def _handle_outage(self, rec: dict) -> None:
        sched = self.sched
        now = sched.now
        downs = set(sched._down_keys())
        affected = [job for job in sched.ledger.jobs
                    if any(job.stages[k][0] in downs
                           for k in range(job.ptr, len(job.stages)))]
        rec["affected"] = [j.name for j in affected]
        rec["requeued"], rec["lost"] = [], []
        if not affected:
            return
        residuals = [self._residual(job) for job in affected]
        names = [job.name for job in affected]
        sched.ledger = sched.ledger.remove_jobs(names, at=now)
        if sched.commit_log is not None:
            sched.commit_log = sched.commit_log.record_removal(now, names)
        sched._sync_ledger_queues()
        # The pre-batch snapshot may straddle the outage; a replan_last
        # rollback would resurrect the withdrawn jobs.
        sched._last = None
        viable: list[tuple[J.InferenceJob, float]] = []
        for orig, new_job, arrival, reason in residuals:
            if self.policy == "lost":
                self._lose(now, rec, orig, "failed_resource")
            elif new_job is None:
                self._lose(now, rec, orig, reason)
            else:
                viable.append((new_job, arrival))
        if viable:
            self._resubmit(now, rec, viable)

    def _resubmit(self, now: float, rec: dict,
                  viable: list[tuple[J.InferenceJob, float]]) -> None:
        sched = self.sched
        jobs = [j for j, _ in viable]
        arrs = [a for _, a in viable]
        method = "migrate" if self.policy == "migrate" else None
        for attempt in (0, 1):
            try:
                sched.submit_window(now, jobs, arrivals=arrs,
                                    pad_to=self.pad_to, method=method)
                rec["requeued"].extend(j.name for j in jobs)
                return
            except Exception as e:  # noqa: BLE001 — serving must survive
                err = e
        for j in jobs:
            self._lose(now, rec, j.name, "solver_error", error=repr(err))

    def _lose(self, t: float, rec: dict | None, name: str, reason: str,
              **extra) -> None:
        self.sched.trace.lost.append((name, reason))
        self.sched.trace.events.append(
            {"time": float(t), "event": "lost", "name": name,
             "reason": reason, **extra})
        if rec is not None:
            rec["lost"].append((name, reason))

    # -- residual reconstruction ---------------------------------------------
    def _residual(self, job: LedgerJob):
        """(orig name, residual InferenceJob | None, original arrival,
        shed reason) for one stranded ledger job.

        Completed layers stay completed: the residual restarts from the
        node holding the last finished layer's output (its transfer hops
        re-pay from there — partial hop progress of the *current* layer
        is forfeit, the re-transfer cost the tentpole prices in).  A job
        whose remaining work is only the final delivery becomes a
        1-FLOP, 2-transfer job (the formulation has no compute-free
        jobs; one FLOP is noise at 1e9-FLOP/s scales).
        """
        sched = self.sched
        base, retry = _parse_retry(job.name)
        arrival = sched.trace.arrivals_by_name.get(job.name, job.release)
        src_job = sched.inflight_jobs.get(job.name)
        if src_job is None:
            return job.name, None, arrival, "no_registry_entry"
        if retry + 1 > self.max_retries:
            return job.name, None, arrival, "retries_exhausted"
        k = sum(1 for res, _ in job.stages[:job.ptr] if res[0] == "node")
        if k == 0:
            loc = int(src_job.src)
        else:
            loc = next(int(res[1]) for res, _ in
                       reversed(job.stages[:job.ptr]) if res[0] == "node")
        if not sched._avail_node[loc]:
            return job.name, None, arrival, "data_lost"
        dst = int(src_job.dst)
        if not self.routable(loc, dst):
            return job.name, None, arrival, "unreachable"
        L = src_job.num_layers
        if k >= L:
            comp = np.array([1.0], np.float32)
            data = np.array([src_job.data[L], src_job.data[L]], np.float32)
        else:
            comp = np.asarray(src_job.comp[k:], np.float32)
            data = np.asarray(src_job.data[k:], np.float32)
        name = f"{base}#r{retry + 1}"
        return job.name, J.InferenceJob(name, loc, dst, comp, data), \
            arrival, ""

    # -- routability ---------------------------------------------------------
    def routable(self, src: int, dst: int) -> bool:
        """True iff a job from ``src`` to ``dst`` is serveable on the
        surviving topology: both endpoints up, and some available compute
        node lies on a surviving directed path src -> w -> dst (every plan
        needs at least one compute stage, so src -> dst connectivity alone
        is not enough when the only live route bypasses all compute)."""
        sched = self.sched
        avail = sched._avail_node
        if not (avail[src] and avail[dst]):
            return False
        adj = (self._has_link & sched._link_up
               & avail[:, None] & avail[None, :])
        fwd = _bfs(src, adj)
        if not fwd[dst]:
            return False
        bwd = _bfs(dst, adj.T)
        compute = self._has_compute & avail
        return bool((compute & fwd & bwd).any())

    def filter_arrivals(self, t: float,
                        jobs: list[J.InferenceJob]) -> list[J.InferenceJob]:
        """Drop (and account as lost) arrivals that cannot be served on the
        current surviving topology — a request entering at a dead or
        partitioned ingress has nowhere to go; committing it anyway would
        seat work on dead resources.  Drivers call this only while the
        scheduler is degraded, so the healthy path is untouched."""
        kept = []
        for job in jobs:
            if self.routable(int(job.src), int(job.dst)):
                kept.append(job)
            else:
                self._lose(t, None, job.name, "arrival_unroutable")
        return kept


def _bfs(start: int, adj: np.ndarray) -> np.ndarray:
    """[V] bool reachability (including ``start``) over a directed
    adjacency matrix."""
    seen = np.zeros(adj.shape[0], bool)
    seen[start] = True
    frontier = [int(start)]
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.flatnonzero(adj[u] & ~seen):
                seen[v] = True
                nxt.append(int(v))
        frontier = nxt
    return seen


def schedule_from(events: Iterable[FaultEvent]) -> FaultSchedule:
    """Convenience: a :class:`FaultSchedule` from any event iterable."""
    return FaultSchedule(tuple(events))
