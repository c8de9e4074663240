"""Per-plan committed-work ledger + exact (event-accurate) queue drain.

Counterpart of ``repro.core.completions``.  The ledger and both event
engines are host-side float64 numpy, as in the reference, and equal it bit
for bit; only :meth:`CommittedWork.queue_state` touches the device, where
it builds the float32 queue tensors the solvers read.  Each entry point
copies the topology's rates to the host once (:func:`_host_rates`).

The fluid drain (:meth:`repro_torch.core.state.QueueState.advance`) serves every
resource independently at full rate: ``q <- max(q - mu * dt, 0)``.  That is
the *most optimistic* work-conserving service model — it drains link bytes
for layers whose producing compute hasn't finished, and node FLOPs out of
priority order.  The paper's queues Q charge waiting time against
*committed work* served by a preempt-resume priority system (the model
``core.schedule.simulate`` implements exactly), so fluid-drained backlogs —
and every latency bound evaluated against them — are systematically
optimistic.

:class:`CommittedWork` closes that gap.  It is the host-side companion to
the :class:`~repro_torch.core.state.QueueState`: a ledger recording, per
committed plan, each job's per-resource work items with its global priority
and precedence (layer k's transfer cannot drain before layer k's compute
completes — the stage order of :func:`repro_torch.core.schedule.job_stages`).
:func:`drain_exact` advances the ledger with the same preempt-resume
semantics as the one-shot simulator, a ``dt`` window at a time,
incrementally between online arrivals.  The ledger lives on the host: the
event loop is data-dependent control flow; only the residual per-resource
work it implies (:meth:`CommittedWork.queue_arrays`) is materialized back
into the device ``QueueState`` the solvers consume.

All ledger operations are functional (they return new ledgers and never
mutate tasks in place), so a scheduler can snapshot a ledger by reference —
``replan_last``'s rollback does exactly that.

Two engines drive the drain (``engine="indexed" | "ref"`` on every entry
point).  The default is the persistent indexed engine
(:mod:`repro_torch.core.eventsim`): each drained/committed ledger carries a
*cache slot* pointing at the live engine, so consecutive windows reuse the
indexes instead of rebuilding every ``TaskRun`` per arrival.  The slot is
stamp-guarded and strictly linear — draining a ledger hands the engine to
the *result* ledger and invalidates the input's slot, so an old snapshot
(``replan_last``'s rollback, a branched what-if drain) simply rebuilds
lazily from its immutable job records.  ``engine="ref"`` runs the seed
linear-scan loop (:func:`repro_torch.core.schedule.run_event_loop_ref`) — the
parity reference the indexed engine is held to.

``health`` records infrastructure events ``(time, key, factor)`` on the
same log — ``report_slowdown`` factors on node keys, and (since the fault
layer) full *availability*: ``factor=inf`` marks the keyed node or
directed link down, any finite factor marks it up again at that slowdown
(recovery records ``1.0``).  ``removed`` records fault-policy withdrawals
``(time, name)``.  :func:`replay_piecewise` merges both histories and
replays the ground truth segment by segment at the effective topology
(and resource availability) actually in force — not a single end-state
topology for the whole horizon.

Priorities are ledger-global: plans committed earlier hold strictly higher
priority than later ones (each batch was solved against the queue state its
predecessors built), and within a plan jobs keep their solver-assigned
order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from . import eventsim, schedule
from .state import QueueState, Topology, effective_topology


def _host_rates(topo: Topology) -> tuple[np.ndarray, np.ndarray]:
    """float64 host copies of ``topo``'s rates, one transfer per tensor."""
    return (topo.mu_node.cpu().numpy().astype(np.float64),
            topo.mu_link.cpu().numpy().astype(np.float64))


@dataclasses.dataclass(frozen=True)
class LedgerJob:
    """One committed job's work items and drain progress."""

    name: str
    prio: int                  # ledger-global priority (0 = served first)
    release: float             # absolute commit/arrival time (s)
    stages: tuple[schedule.Stage, ...]  # (resource, work) in precedence order
    ptr: int = 0               # completed-stage count
    remaining: float | None = None      # residual work of the current stage
    arrived: float = 0.0       # instant the job became ready at this stage

    @property
    def finished(self) -> bool:
        return self.ptr >= len(self.stages)


@dataclasses.dataclass(frozen=True)
class CommittedWork:
    """Ledger of committed-but-unfinished work across all committed plans.

    ``jobs`` holds live (unfinished) jobs; ``completed`` accumulates
    ``(name, absolute completion time)`` pairs as drains finish jobs.
    ``clock`` is the absolute time the ledger has been drained to — a
    never-drained ledger (a pure commit *log*) keeps its initial clock, and
    its jobs' ``release`` times drive the full-horizon replay instead.
    """

    num_nodes: int
    clock: float = 0.0
    jobs: tuple[LedgerJob, ...] = ()
    completed: tuple[tuple[str, float], ...] = ()
    next_prio: int = 0
    # Completion records are keyed by job name, so names must be unique for
    # the lifetime of the ledger; commit() enforces it against this set.
    names_seen: frozenset[str] = frozenset()
    # Health history: (absolute time, key, factor) events in record order,
    # where key is a node index or a ("link", u, v) tuple.  A finite factor
    # is a slowdown (the node/link is up at mu/factor; 1.0 = full health);
    # factor=inf marks the resource *unavailable* — a node failure takes
    # its incident links down implicitly.  A pure annotation — drains
    # ignore it (the caller picks the effective topology per window);
    # replay_piecewise() consumes it.
    health: tuple[tuple[float, object, float], ...] = ()
    # Fault-policy withdrawals: (absolute time, job name).  Jobs stay in a
    # pure commit *log* until the replay reaches the removal instant; a
    # live ledger drops them immediately (remove_jobs) and records here.
    removed: tuple[tuple[float, str], ...] = ()

    @classmethod
    def empty(cls, num_nodes: int, clock: float = 0.0) -> "CommittedWork":
        return cls(num_nodes=int(num_nodes), clock=float(clock))

    def record_health(self, at: float, key, factor: float) -> "CommittedWork":
        """Annotate the log with a health event on ``key`` (a node index or
        ``("link", u, v)``).  ``factor`` follows the scheduler's "factor=2
        = half speed" convention; ``inf`` marks the resource down, any
        finite factor marks it up again at that slowdown."""
        if isinstance(key, tuple):
            if len(key) != 3 or key[0] != "link":
                raise ValueError(
                    f"health key must be a node index or ('link', u, v), "
                    f"got {key!r}")
            key = ("link", int(key[1]), int(key[2]))
        else:
            key = int(key)
        return dataclasses.replace(
            self, health=self.health + ((float(at), key, float(factor)),))

    def record_slowdown(self, at: float, node: int,
                        factor: float) -> "CommittedWork":
        """Annotate the log with a node health event (``factor=2`` = half
        speed, the scheduler's convention); replay_piecewise() replays
        segment by segment at the recorded factors."""
        return self.record_health(at, int(node), factor)

    def record_removal(self, at: float, names) -> "CommittedWork":
        """Annotate a commit *log* with fault-policy withdrawals: the named
        jobs were requeued/migrated/lost at ``at``.  The job records stay
        (the replay serves them up to the removal instant, then drops the
        residual); a *live* ledger removes jobs via :meth:`remove_jobs`."""
        return dataclasses.replace(
            self, removed=self.removed + tuple(
                (float(at), str(n)) for n in names))

    def remove_jobs(self, names, *, at: float | None = None,
                    missing_ok: bool = False,
                    record: bool = True) -> "CommittedWork":
        """Withdraw live jobs by name (a fault policy re-placing or
        shedding their residual work).  Served work stays served; no
        completion is recorded.  Unknown or already-completed names raise
        unless ``missing_ok`` (the replay path tolerates jobs that finished
        marginally before their recorded removal).  ``record=False`` skips
        the ``removed`` annotation (used by the replay itself, whose event
        list is already fixed)."""
        at = self.clock if at is None else float(at)
        want = set(map(str, names))
        live = {j.name for j in self.jobs}
        if not missing_ok and not want <= live:
            raise ValueError(
                f"cannot remove unknown/completed job(s) "
                f"{sorted(want - live)}: only live committed jobs can be "
                f"withdrawn (pass missing_ok=True to skip them)")
        hit = want & live
        new = dataclasses.replace(
            self,
            jobs=tuple(j for j in self.jobs if j.name not in hit),
            removed=self.removed + tuple(sorted((at, n) for n in hit))
            if record else self.removed)
        eng = _engine_of(self)
        if eng is not None:
            try:
                eng.remove(hit)
            except Exception:
                eng.stamp += 1     # poison the half-mutated index
                raise
            _attach(new, eng)
        return new

    # -- committing plans -----------------------------------------------------
    def commit(self, batch, plan, *, names=None,
               at: float | None = None) -> "CommittedWork":
        """Append one work item per job of a solved plan, released at ``at``.

        The plan must carry explicit transfer paths (``plan.paths``, filled
        by ``Plan.replay`` or ``schedule.replay_solution`` against the queue
        state the plan was solved for); the ledger charges each layer's
        bytes to exactly the hops the plan routed them over.  ``names`` (one
        per job, batch order) key the completion records, so they must be
        unique over the ledger's lifetime (a duplicate would silently
        overwrite an earlier job's completion time) — a repeat raises
        ``ValueError``; defaults to ``p<prio>``, unique by construction.
        The ledger clock is *not* moved — commits are events, drains move
        time.
        """
        at = self.clock if at is None else float(at)
        if at < self.clock - 1e-9:
            raise ValueError(
                f"cannot commit at t={at} behind the ledger clock {self.clock}")
        jobs = list(self.jobs)
        seen = set(self.names_seen)
        added = _plan_jobs(batch, plan, names=names, next_prio=self.next_prio,
                           at=at, seen=seen)
        jobs.extend(added)
        new = dataclasses.replace(
            self, jobs=tuple(jobs), next_prio=self.next_prio + plan.num_jobs,
            names_seen=frozenset(seen))
        eng = _engine_of(self)
        if eng is not None:
            try:
                eng.commit(added)  # extend the live index in place
            except Exception:
                eng.stamp += 1     # poison the half-extended index
                raise
            _attach(new, eng)
        return new

    def cleared(self) -> "CommittedWork":
        """Drop all live jobs without recording completions (a scheduler's
        hard reset — see ``RoutedScheduler.drain``)."""
        return dataclasses.replace(self, jobs=())

    # -- materializing state --------------------------------------------------
    def queue_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Residual committed work per resource: (q_node [V], q_link [V, V]).

        The exact-model counterpart of the fluid backlogs: the current
        stage's residual plus every not-yet-started stage of every live
        job, charged to its resource.  float32, ready for
        ``QueueState.with_queues``.  A ledger carrying a live engine reads
        the incrementally maintained arrays (O(V^2), no job rescan).
        """
        eng = _engine_of(self)
        if eng is not None:
            qn, ql = eng.eng.queue_arrays()
            return qn.astype(np.float32), ql.astype(np.float32)
        qn = np.zeros((self.num_nodes,), np.float64)
        ql = np.zeros((self.num_nodes, self.num_nodes), np.float64)
        for job in self.jobs:
            for k in range(job.ptr, len(job.stages)):
                res, work = job.stages[k]
                w = (job.remaining
                     if k == job.ptr and job.remaining is not None else work)
                if res[0] == "node":
                    qn[res[1]] += w
                else:
                    ql[res[1], res[2]] += w
        return qn.astype(np.float32), ql.astype(np.float32)

    def queue_state(self, clock: float | None = None, *,
                    device: str | torch.device = "cuda") -> QueueState:
        """Residual work as a float32 :class:`QueueState` on ``device``
        (clock defaults to the ledger clock).  Callers pass the topology's
        device (``topo.device``)."""
        dev = resolve_device(device)
        qn, ql = self.queue_arrays()
        clock = np.float32(self.clock if clock is None else clock)
        return QueueState(q_node=torch.from_numpy(qn).to(dev),
                          q_link=torch.from_numpy(ql).to(dev),
                          clock=torch.tensor(clock, device=dev))

    def backlog_seconds(self, topo: Topology) -> float:
        """Worst-resource residual wait under the exact model (see
        :func:`repro_torch.core.state.backlog_seconds`)."""
        from .state import backlog_seconds as _bs
        return _bs(topo, self.queue_state(device=topo.device))


def _plan_jobs(batch, plan, *, names, next_prio: int, at: float,
               seen: set) -> list[LedgerJob]:
    """Ledger records for one solved plan (shared by :meth:`CommittedWork.
    commit` and :func:`predict_completions`'s uncommitted candidates).

    ``seen`` is mutated in place so successive plans in one call share the
    uniqueness check.
    """
    if plan.paths is None:
        raise ValueError(
            "plan must carry explicit paths to be committed to the "
            "ledger; derive them with plan.replay(net, batch) or "
            "schedule.replay_solution against the solve-time queue state")
    stages = schedule.job_stages(batch, plan.assign, plan.paths)
    order = plan.order
    added: list[LedgerJob] = []
    for slot in range(plan.num_jobs):
        j = int(order[slot])
        prio = next_prio + slot
        name = names[j] if names is not None else f"p{prio}"
        if name in seen:
            raise ValueError(
                f"duplicate job name {name!r}: completion tracking keys "
                f"on job names, which must be unique per ledger — give "
                f"requests/jobs distinct names")
        seen.add(name)
        added.append(LedgerJob(name=name, prio=prio, release=at,
                               stages=tuple(stages[j]), arrived=at))
    return added


def _task_of(job: LedgerJob) -> schedule.TaskRun:
    return schedule.TaskRun(stages=list(job.stages), prio=job.prio,
                            ptr=job.ptr, remaining=job.remaining,
                            arrived=job.arrived)


def _tasks_of(ledger: CommittedWork) -> list[schedule.TaskRun]:
    return [_task_of(job) for job in ledger.jobs]


def _fold(ledger: CommittedWork, tasks: list[schedule.TaskRun],
          clock: float) -> CommittedWork:
    """New ledger from post-loop task states (completions recorded)."""
    live: list[LedgerJob] = []
    done = list(ledger.completed)
    for job, task in zip(ledger.jobs, tasks):
        if task.done:
            done.append((job.name, float(task.completion)))
        else:
            live.append(dataclasses.replace(job, ptr=task.ptr,
                                            remaining=task.remaining,
                                            arrived=task.arrived))
    return dataclasses.replace(ledger, clock=float(clock), jobs=tuple(live),
                               completed=tuple(done))


# -- the persistent engine cache ----------------------------------------------
#
# A drained/committed ledger may carry a live indexed engine in a slot set
# with object.__setattr__ (not a dataclass field: dataclasses.replace()
# must NOT copy it onto unrelated successors, and it never serializes).
# The slot is stamp-guarded: using the engine (drain, commit) hands it to
# the result ledger and bumps the stamp, so every stale snapshot — a
# replan rollback, a branched what-if drain — fails the stamp check and
# lazily rebuilds from its own immutable job records instead.

_ENGINE_SLOT = "_sim_engine"


class _LedgerEngine:
    """A persistent :class:`~repro_torch.core.eventsim.EventEngine` plus the
    ledger-side bookkeeping (names, fold cursors) to turn its state back
    into :class:`CommittedWork` records."""

    def __init__(self, ledger: CommittedWork, mu_node: np.ndarray,
                 mu_link: np.ndarray, down: tuple = ()):
        self.eng = eventsim.EventEngine(mu_node, mu_link, clock=ledger.clock)
        self.jobs: list[LedgerJob] = list(ledger.jobs)
        self.names: list[str] = [j.name for j in self.jobs]
        self._live: list[int] = list(range(len(self.jobs)))
        self._folded = 0   # completions already folded into the chain
        self.stamp = 0
        # Failed resources must be marked before indexing: a ready task on
        # one would otherwise be seated at its (zeroed) effective rate.
        for res in down:
            self.eng.remove_resource(res)
        self.eng.add_tasks([_task_of(j) for j in ledger.jobs])

    def commit(self, added: list[LedgerJob]) -> None:
        base = len(self.jobs)
        self.jobs.extend(added)
        self.names.extend(j.name for j in added)
        self._live.extend(range(base, len(self.jobs)))
        self.eng.add_tasks([_task_of(j) for j in added])

    def remove(self, names) -> None:
        """Withdraw live tasks by name (see ``CommittedWork.remove_jobs``)."""
        self.eng.remove_tasks(
            [i for i in self._live
             if self.names[i] in names and not self.eng.tasks[i].done])

    def bloated(self) -> bool:
        """Completed-task shells now outweigh the live set: retaining the
        cache costs more memory than a lazy re-index of the live jobs, so
        the caller should drop it (amortized O(1) work per job — the
        engine would otherwise grow with every job ever served)."""
        dead = len(self.jobs) - len(self._live)
        return dead >= 2048 and dead > len(self._live)

    def fold(self, ledger: CommittedWork, clock: float) -> CommittedWork:
        """New ledger from the engine state — touches only live jobs, and
        reuses each untouched job's record by reference."""
        self.eng.materialize()
        new_done = [(self.names[i], float(t))
                    for i, t in self.eng.completions[self._folded:]]
        self.eng.completions.clear()   # folded into the ledger chain
        self._folded = 0
        live_idx: list[int] = []
        live_jobs: list[LedgerJob] = []
        for i in self._live:
            task = self.eng.tasks[i]
            if task.done:
                continue
            job = self.jobs[i]
            if (task.ptr != job.ptr or task.remaining != job.remaining
                    or task.arrived != job.arrived):
                job = dataclasses.replace(
                    job, ptr=task.ptr,
                    remaining=None if task.remaining is None
                    else float(task.remaining),
                    arrived=float(task.arrived))
                self.jobs[i] = job
            live_idx.append(i)
            live_jobs.append(job)
        self._live = live_idx
        return dataclasses.replace(ledger, clock=float(clock),
                                   jobs=tuple(live_jobs),
                                   completed=ledger.completed
                                   + tuple(new_done))


def _attach(ledger: CommittedWork, eng: _LedgerEngine) -> CommittedWork:
    eng.stamp += 1
    # The blessed stamp-guarded engine cache slot ("the persistent engine
    # cache" above): not a field, never a pytree leaf, and deliberately
    # dropped by dataclasses.replace.
    # repro-lint: disable=RL004 -- stamp-guarded cache slot, not a field
    object.__setattr__(ledger, _ENGINE_SLOT, (eng, eng.stamp))
    return ledger


def _engine_of(ledger: CommittedWork) -> _LedgerEngine | None:
    slot = getattr(ledger, _ENGINE_SLOT, None)
    if slot is None:
        return None
    eng, stamp = slot
    return eng if eng.stamp == stamp else None


def _check_engine(engine: str) -> None:
    if engine not in ("indexed", "ref"):
        raise ValueError(
            f"engine must be 'indexed' or 'ref', got {engine!r}")


def _live_engine(ledger: CommittedWork, mu_node: np.ndarray,
                 mu_link: np.ndarray, down: tuple = ()) -> _LedgerEngine:
    eng = _engine_of(ledger)
    if eng is None:
        eng = _LedgerEngine(ledger, mu_node, mu_link, down)
    return eng


def warm_engine(topo: Topology, ledger: CommittedWork) -> CommittedWork:
    """Attach a live indexed engine to ``ledger`` if it lacks one.

    The engine is otherwise born lazily at the first drain; the exact-mode
    scheduler warms it at commit time instead, so the very first arrival's
    queue materialization already reads the incremental index and every
    later commit extends it in place.
    """
    if _engine_of(ledger) is None:
        _attach(ledger, _LedgerEngine(ledger, *_host_rates(topo)))
    return ledger


def down_keys(topo: Topology, avail_node, link_up=None) -> tuple:
    """Resource keys the event engines must treat as failed.

    Failed nodes, every *existing* link (base mu > 0) incident to one — a
    dead node cannot relay — and explicitly failed links.  The engine-side
    companion of :func:`repro_torch.core.state.effective_topology`'s rate masks.
    """
    avail = np.asarray(avail_node, bool)
    mu_link = topo.mu_link.cpu().numpy()
    keys: list[tuple] = [("node", int(u)) for u in np.flatnonzero(~avail)]
    bad = ~avail[:, None] | ~avail[None, :]
    if link_up is not None:
        bad |= ~np.asarray(link_up, bool)
    for u, v in zip(*np.nonzero(bad & (mu_link > 0))):
        keys.append(("link", int(u), int(v)))
    return tuple(keys)


def drain_exact(topo: Topology, ledger: CommittedWork, dt, *,
                engine: str = "indexed", down: tuple = ()) -> CommittedWork:
    """Advance the ledger ``dt`` seconds with preempt-resume priority service.

    The exact counterpart of the fluid ``QueueState.advance``: every
    resource serves the highest-priority *ready* work item (precedence
    respected, preempting on arrival, work-conserving), with the same
    semantics as :func:`repro_torch.core.schedule.simulate`.  Draining in chunks
    composes exactly: ``drain_exact(ledger, a)`` then ``b`` equals
    ``drain_exact(ledger, a + b)`` — the property tests assert it.

    ``topo`` is the *effective* topology (straggler-scaled rates apply for
    the whole window, the same piecewise-constant-health approximation the
    fluid drain makes).  Jobs finishing inside the window move to
    ``ledger.completed`` with their completion instants.

    ``engine="indexed"`` (default) runs on the persistent indexed engine —
    the returned ledger carries the live index, so the next drain/commit
    in the chain is incremental.  ``engine="ref"`` rebuilds ``TaskRun``
    records and runs the seed linear-scan loop (the parity reference).

    ``down`` is the authoritative set of resource keys failed *throughout
    this window* (work targeting them waits; served work stays served) —
    typically :func:`down_keys` of the scheduler's availability masks.
    Resources absent from it are restored on the persistent engine.
    """
    _check_engine(engine)
    dt = float(dt)
    if dt < 0:
        raise ValueError(f"dt must be >= 0, got {dt}")
    t_end = ledger.clock + dt
    if dt == 0.0 or not ledger.jobs:
        new = dataclasses.replace(ledger, clock=t_end)
        eng = _engine_of(ledger)
        if eng is not None:     # keep the index in step with the clock
            eng.eng.now = t_end
            _attach(new, eng)
        return new
    mu_node, mu_link = _host_rates(topo)
    if engine == "ref":
        tasks = _tasks_of(ledger)
        schedule.run_event_loop_ref(tasks, mu_node, mu_link, t=ledger.clock,
                                    t_end=t_end, down=down)
        return _fold(ledger, tasks, t_end)
    eng = _live_engine(ledger, mu_node, mu_link, down)
    try:
        eng.eng.sync(mu_node, mu_link, down)
        eng.eng.advance(t_end)
    except Exception:
        eng.stamp += 1   # poison the cache: rebuilds are always safe
        raise
    new = eng.fold(ledger, t_end)
    return new if eng.bloated() else _attach(new, eng)


def run_to_completion(topo: Topology, ledger: CommittedWork, *,
                      engine: str = "indexed",
                      down: tuple = ()) -> tuple[dict[str, float],
                                                 "CommittedWork"]:
    """Serve every committed job to completion; the ground-truth replay.

    Returns ``({name: absolute completion time} — including jobs already
    completed by earlier drains — , the fully drained ledger)``.  On a
    never-drained commit log this is the full-horizon event simulation of
    the whole arrival history (jobs start at their ``release`` times); on a
    live exact ledger it finishes the residual work — the two must agree.

    ``down`` resources stay failed for the whole run: a job still needing
    one can never complete, so stuck work raises — clear it first
    (recovery policies requeue, migrate, or shed it).
    """
    _check_engine(engine)
    completions = dict(ledger.completed)
    if not ledger.jobs:
        return completions, ledger
    mu_node, mu_link = _host_rates(topo)
    if engine == "ref":
        tasks = _tasks_of(ledger)
        t = schedule.run_event_loop_ref(tasks, mu_node, mu_link,
                                        t=ledger.clock, down=down)
        out = _fold(ledger, tasks, max(ledger.clock, t))
    else:
        eng = _live_engine(ledger, mu_node, mu_link, down)
        try:
            eng.eng.sync(mu_node, mu_link, down)
            t = eng.eng.advance(np.inf)
        except Exception:
            eng.stamp += 1
            raise
        out = eng.fold(ledger, max(ledger.clock, float(t)))
        if not eng.bloated():
            _attach(out, eng)
    completions.update({name: when for name, when in out.completed})
    return completions, out


def predict_completions(topo: Topology, ledger: CommittedWork, *,
                        extra_plans=(), at: float | None = None,
                        down: tuple = (), horizon: float = np.inf,
                        engine: str = "indexed") -> dict[str, float]:
    """What-if forecast: per-job completion times if no further work arrives.

    Forks the ledger's live simulation (:meth:`~repro_torch.core.eventsim.
    EventEngine.fork` — no ledger re-fold, no index rebuild) and serves the
    fork to quiescence *without committing anything*.  Returns ``{name:
    absolute completion time}`` for every job that finishes by ``horizon``,
    including jobs already completed — exactly what
    :func:`run_to_completion` would report, but leaving the ledger, its
    engine, and the committed state untouched.

    ``extra_plans`` scores uncommitted candidates: an iterable of
    ``(batch, plan)`` or ``(batch, plan, names)`` tuples (the same
    arguments :meth:`CommittedWork.commit` takes), released into the fork
    at ``at`` (default: the ledger clock) at the priorities they *would*
    receive if committed in order.  This is the admission controller's
    scoring primitive: predict a window's completions before deciding to
    commit it.

    Exactness: the fork replays the exact float operations of the live
    chain, so when nothing else arrives the predictions match the realized
    completions bit-for-bit.  ``down`` resources stay failed throughout; with work blocked on
    them an infinite ``horizon`` raises (as :func:`run_to_completion`
    does) — pass a finite horizon to forecast through an outage segment.
    """
    _check_engine(engine)
    at = ledger.clock if at is None else float(at)
    if at < ledger.clock - 1e-9:
        raise ValueError(
            f"cannot score candidates at t={at} behind the ledger clock "
            f"{ledger.clock}")
    mu_node, mu_link = _host_rates(topo)
    seen = set(ledger.names_seen)
    next_prio = ledger.next_prio
    extras: list[LedgerJob] = []
    for entry in extra_plans:
        batch, plan, names = entry if len(entry) == 3 else (*entry, None)
        extras.extend(_plan_jobs(batch, plan, names=names,
                                 next_prio=next_prio, at=at, seen=seen))
        next_prio += plan.num_jobs
    out = dict(ledger.completed)
    if engine == "ref":
        tasks = _tasks_of(ledger) + [_task_of(j) for j in extras]
        names_all = [j.name for j in ledger.jobs] + [j.name for j in extras]
        if tasks:
            schedule.run_event_loop_ref(tasks, mu_node, mu_link,
                                        t=ledger.clock, t_end=horizon,
                                        down=down)
        for name, task in zip(names_all, tasks):
            if task.done:
                out[name] = float(task.completion)
        return out
    base = _live_engine(ledger, mu_node, mu_link, down)
    if _engine_of(ledger) is None:
        _attach(ledger, base)   # warm the live chain; semantics-neutral
    fork = base.eng.fork()
    fork.sync(mu_node, mu_link, down)
    if at > fork.now:
        fork.advance(at)
    if extras:
        fork.add_tasks([_task_of(j) for j in extras])
    fork.advance(horizon)
    names_all = list(base.names) + [j.name for j in extras]
    for i, t in fork.completions:
        out[names_all[i]] = float(t)
    return out


def replay_piecewise(topo: Topology, log: CommittedWork, *,
                     engine: str = "indexed") -> tuple[dict[str, float],
                                                       "CommittedWork"]:
    """Ground-truth replay honouring the log's recorded health history.

    Drains the log segment by segment between its ``health`` and
    ``removed`` events — each window at the effective topology (and
    resource availability) actually in force — then serves the final
    segment to completion.  With an empty event history this is exactly
    :func:`run_to_completion` on the base topology.  Returns the same
    ``(completions, drained ledger)`` pair.

    Event semantics per key: a node's finite factor is a slowdown (and
    marks it up — recovery records ``1.0``), ``inf`` marks it down along
    with every incident link; a ``("link", u, v)`` key toggles that
    directed link (finite = up, ``inf`` = down).  A removal withdraws the
    named job's residual work at its recorded instant (the fault policy
    requeued/migrated/shed it; a requeue reappears as its own later
    commit).  At equal times health events apply before removals — the
    order the scheduler emits them in.

    The slowdown vector is maintained float32 and applied through
    :func:`repro_torch.core.state.effective_topology` — bit-for-bit the
    scheduler's ``_effective_topology``, so the replay sees the same rates
    the online drains did.
    """
    V = log.num_nodes
    slow = np.ones((V,), np.float32)
    avail = np.ones((V,), bool)
    link_up = np.ones((V, V), bool)

    def _eff_down():
        if avail.all() and link_up.all():
            # pre-fault fast path: bit-identical to the health-only replay
            return effective_topology(topo, slow), ()
        return (effective_topology(topo, slow, avail, link_up),
                down_keys(topo, avail, link_up))

    events = [(float(at), 0, key, factor) for at, key, factor in log.health]
    events += [(float(at), 1, name, 0.0) for at, name in log.removed]
    cur = log
    for at, kind, key, factor in sorted(events, key=lambda e: (e[0], e[1])):
        eff, down = _eff_down()
        cur = drain_exact(eff, cur, max(at - cur.clock, 0.0),
                          engine=engine, down=down)
        if kind == 1:
            # tolerate a job that completed marginally before its removal
            cur = cur.remove_jobs([key], at=at, missing_ok=True,
                                  record=False)
        elif isinstance(key, tuple):
            link_up[key[1], key[2]] = np.isfinite(factor)
        elif np.isfinite(factor):
            slow[int(key)] = factor
            avail[int(key)] = True
        else:
            avail[int(key)] = False
    eff, down = _eff_down()
    return run_to_completion(eff, cur, engine=engine, down=down)


def _backlog_arrays(mu_node: np.ndarray, mu_link: np.ndarray,
                    qn: np.ndarray, ql: np.ndarray) -> float:
    """Worst-resource residual wait from raw numpy arrays (the host-side
    counterpart of :func:`repro_torch.core.state.backlog_seconds`)."""
    node_wait = np.where(mu_node > 0, qn / np.maximum(mu_node, 1e-30), 0.0)
    link_wait = np.where(mu_link > 0, ql / np.maximum(mu_link, 1e-30), 0.0)
    return float(max(node_wait.max(initial=0.0), link_wait.max(initial=0.0)))


def exact_backlog_trace(topo: Topology, log: CommittedWork, times, *,
                        engine: str = "indexed") -> np.ndarray:
    """Exact-model backlog (s) just before each epoch of a commit log.

    Replays the *same plans* the log records — released at their commit
    times — under exact drain semantics, measuring the worst-resource
    residual wait immediately before each ``times[i]`` (jobs committed at
    exactly ``times[i]`` are excluded, matching the online trace's
    ``backlog_before``).  Comparing against the fluid run's backlogs
    isolates the drain semantics: policy decisions are held fixed.

    ``log`` must be an undrained ledger (``track_commits=True`` keeps one).
    The default engine makes this a *single forward pass*: one persistent
    index over the whole horizon, jobs fed in as their releases pass, the
    backlog read from the incrementally maintained queue arrays — the seed
    rebuilt and rescanned the full ledger at every sample time
    (``engine="ref"`` keeps that behaviour as the parity reference).
    """
    _check_engine(engine)
    jobs = sorted(log.jobs, key=lambda j: j.prio)
    if any(j.ptr or j.remaining is not None for j in jobs):
        raise ValueError("exact_backlog_trace needs an undrained commit log")
    if engine == "ref":
        cur = dataclasses.replace(log, jobs=(), completed=())
        out = []
        k = 0
        for t in np.asarray(times, np.float64):
            t = float(t)
            add = []
            while (k < len(jobs)
                   and jobs[k].release < t - schedule.time_eps(t)):
                add.append(jobs[k])
                k += 1
            if add:
                cur = dataclasses.replace(cur, jobs=cur.jobs + tuple(add))
            cur = drain_exact(topo, cur, max(t - cur.clock, 0.0),
                              engine="ref")
            out.append(cur.backlog_seconds(topo))
        return np.asarray(out, np.float64)
    mu_node, mu_link = _host_rates(topo)
    eng = eventsim.EventEngine(mu_node, mu_link, clock=log.clock)
    out = []
    k = 0
    for t in np.asarray(times, np.float64):
        t = float(t)
        add = []
        while k < len(jobs) and jobs[k].release < t - schedule.time_eps(t):
            add.append(jobs[k])
            k += 1
        if add:
            eng.add_tasks([_task_of(j) for j in add])
        eng.advance(max(t, eng.now))
        qn, ql = eng.queue_arrays()
        out.append(_backlog_arrays(mu_node, mu_link, qn, ql))
    return np.asarray(out, np.float64)
