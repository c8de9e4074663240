"""The *actual system*: an event-driven, preemptive-priority simulator.

Counterpart of ``repro.core.schedule``.  The routing formulation minimizes an upper bound
on completion time (the fictitious system of §III-B).  This module measures
what actually happens when the routed jobs run: every resource (compute
node, directed link) serves the highest-priority arrived task, preempting
lower-priority work on arrival (preempt-resume, work-conserving) — the
paper's scheduling model.  Tests assert bound >= simulated completion.

``replay_solution`` reconstructs, for any (assignment, priority) solution —
raw arrays or a :class:`~repro_torch.core.plan.Plan` — the per-job
fictitious bounds, the explicit per-layer transfer paths (chosen against
the queue state seen at that job's priority level), and the final queue
state; its closures go through the min-plus kernel on the network's
device.  The event loop itself is host-side numpy float64, as in the
reference, with its two engines: ``engine="ref"``
(:func:`run_event_loop_ref`, the linear scan, default for the one-shot
:func:`simulate`) and ``engine="indexed"``
(:mod:`repro_torch.core.eventsim`, O(log) per event and persistent across
drain windows; the committed-work ledger runs on it).

Event-time comparisons share one tolerance discipline: :func:`time_eps`
(relative to the clock) and :func:`work_eps` (relative to a stage's work).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .network import ComputeNetwork
from .jobs import JobBatch
from . import routing


@dataclasses.dataclass(frozen=True)
class SimResult:
    completion: np.ndarray  # [J] actual completion time of each job
    makespan: float


def _as_assign_order(assign, order):
    """Accept either (assign, order) arrays or a Plan in the first slot."""
    from .plan import Plan
    if isinstance(assign, Plan):
        if order is not None:
            raise ValueError("pass either a Plan or (assign, order), not both")
        return assign.assign, assign.order
    if order is None:
        raise ValueError("order is required when assign is an array")
    return assign, order


def replay_solution(net: ComputeNetwork, batch: JobBatch, assign, order=None):
    """Replay jobs in priority order, committing loads; return bounds+paths.

    Each priority step builds the job's [Lmax+1, V, V] closure stack once
    (``shortest_path.build_closures``) and shares it across the bound
    evaluation and the commit, whose charged hops are the job's paths.
    """
    from . import shortest_path as SP

    assign, order = _as_assign_order(assign, order)
    assign = np.asarray(assign, np.int32)
    host = batch.to_numpy()
    J = batch.num_jobs
    bounds = np.zeros((J,), np.float64)
    paths: dict[int, list[list[tuple[int, int]]]] = {}
    cur = net
    for p in range(J):
        j = int(order[p])
        args = (host["comp"][j], batch.data[j], host["src"][j],
                host["dst"][j], host["num_layers"][j], assign[j])
        cl = SP.build_closures(cur, batch.data[j])
        bounds[j] = float(routing.cost_given_assignment(cur, *args,
                                                        closures=cl))
        cur, hops = routing.commit_with_hops(cur, *args, closures=cl)
        paths[j] = routing.hops_to_paths(hops, host["num_layers"][j])
    return bounds, paths, cur


# A work stage: (resource key, amount of work).  Resource keys are
# ("node", u) for compute (work in FLOPs) and ("link", u, v) for a directed
# transfer hop (work in bytes).
Stage = tuple[tuple, float]


def job_stages(batch: JobBatch, assign,
               paths: dict[int, list[list[tuple[int, int]]]]
               ) -> dict[int, list[Stage]]:
    """Per-job (resource, work) stage lists, in precedence order.

    Layer l's output transfer hops come before layer l+1's compute, which
    comes before layer l+1's output hops — so layer k's transfer cannot
    start (and its bytes cannot occupy a link) before layer k's compute
    completes.  This is the precedence structure both the one-shot
    simulator and the incremental committed-work drain honour.
    """
    host = batch.to_numpy()
    comp = host["comp"].astype(np.float64)
    data = host["data"].astype(np.float64)
    nl = host["num_layers"]
    a = np.asarray(assign)
    stages: dict[int, list[Stage]] = {}
    for j in range(batch.num_jobs):
        L = int(nl[j])
        st: list[Stage] = []
        for l in range(L + 1):
            for (u, v) in paths[j][l]:
                st.append((("link", u, v), float(data[j, l])))
            if l < L:
                st.append((("node", int(a[j, l])), float(comp[j, l])))
        stages[j] = st
    return stages


@dataclasses.dataclass
class TaskRun:
    """Mutable run-state of one job inside the shared event loop."""

    stages: list[Stage]        # (resource, work) in precedence order
    prio: int                  # global priority (0 = served first)
    ptr: int = 0               # completed-stage count
    remaining: float | None = None  # residual work of the current stage
    arrived: float = 0.0       # instant the job became ready at this stage
    done: bool = False
    completion: float = 0.0    # valid once done


def time_eps(t: float) -> float:
    """Tolerance for event-time comparisons at clock ``t``.

    Relative to the clock magnitude: an absolute epsilon (the seed used
    ``t + 1e-18``) is below one ulp of ``t`` whenever ``t`` exceeds ~1e-2,
    so the arrival guard silently degraded to exact comparison at any
    nonzero clock.  Shared by both event-loop engines and the ledger's
    backlog trace so window boundaries and arrival cutoffs agree.
    """
    return 1e-12 * max(1.0, abs(t))


def work_eps(work: float) -> float:
    """Completion threshold for a stage of ``work`` units (relative)."""
    return 1e-12 * max(1.0, work)


def _resource_rate(res: tuple, mu_node: np.ndarray,
                   mu_link: np.ndarray) -> float:
    return float(mu_node[res[1]] if res[0] == "node"
                 else mu_link[res[1], res[2]])


def run_event_loop_ref(tasks: list[TaskRun], mu_node: np.ndarray,
                       mu_link: np.ndarray, *, t: float = 0.0,
                       t_end: float = np.inf, guard: int = 1_000_000,
                       down: frozenset | tuple = ()) -> float:
    """Preempt-resume priority service of ``tasks`` over ``[t, t_end]``.

    Every resource serves the highest-priority arrived task (strict
    priority, preempting on arrival, work-conserving).  Mutates the tasks
    in place and returns the stop time: ``t_end`` if work remains beyond
    it, else the instant the last event fired.  With the default
    ``t_end=inf`` this is exactly the one-shot simulator's loop; a finite
    ``t_end`` is the incremental drain window used by the committed-work
    ledger.

    ``down`` lists resource keys failed for the whole window: tasks whose
    current stage targets one wait (no service, no dead-resource error).
    Work stuck behind an outage at an infinite ``t_end`` raises — the
    caller must restore the resource or clear the work (recovery
    policies requeue / migrate / shed it) before running to completion.

    The linear-scan loop: each event rescans every task.  Service
    rates are hoisted into per-stage arrays up front — the rate of a
    (task, stage) pair never changes within a run, so the scan does one
    list index instead of two dict lookups per serving resource per event.
    """
    # Hoisted per-stage service rates, indexed [task][stage].
    stage_rates = [[_resource_rate(res, mu_node, mu_link)
                    for res, _ in task.stages] for task in tasks]
    down = frozenset(down)
    for task in tasks:
        if not task.done and task.ptr >= len(task.stages):
            task.done = True
            task.completion = task.arrived
    steps = 0
    while not all(task.done for task in tasks):
        steps += 1
        if steps > guard:
            raise RuntimeError("simulator did not converge")
        # Highest-priority arrived task per resource.
        serving: dict[tuple, tuple[TaskRun, float]] = {}
        eps = time_eps(t)
        for task, rates in zip(tasks, stage_rates):
            if task.done or task.arrived > t + eps:
                continue
            res, work = task.stages[task.ptr]
            if task.remaining is None:
                task.remaining = work
            if res in down:
                continue              # blocked on a failed resource
            cur = serving.get(res)
            if cur is None or task.prio < cur[0].prio:
                serving[res] = (task, rates[task.ptr])
        if not serving:
            # advance to the next stage-arrival (nothing serveable now).
            # With failed resources, live tasks may be *stuck* with
            # arrived <= t — jumping to min(arrived) would freeze the
            # clock and spin the guard out; only future arrivals advance.
            nxt = min((task.arrived for task in tasks
                       if not task.done and task.arrived > t + eps),
                      default=np.inf)
            if nxt >= t_end:
                if not np.isfinite(t_end) and not np.isfinite(nxt):
                    raise RuntimeError(
                        f"event loop stalled: live tasks blocked on "
                        f"failed resources {sorted(down)} — restore them "
                        f"or clear the work before running to completion")
                return t_end if np.isfinite(t_end) else t
            t = nxt
            continue
        # Next completion event.
        dt = np.inf
        for res, (task, rate) in serving.items():
            if rate <= 0:
                raise RuntimeError(
                    f"job with priority {task.prio} scheduled on dead "
                    f"resource {res}")
            dt = min(dt, task.remaining / rate)
        nxt_arr = min((task.arrived for task in tasks
                       if not task.done and task.arrived > t + eps),
                      default=np.inf)
        dt = min(dt, nxt_arr - t)
        clipped = t + dt >= t_end
        if clipped:
            dt = t_end - t  # serve the final partial slice, then stop
        t += dt
        for res, (task, rate) in serving.items():
            task.remaining -= rate * dt
            if task.remaining <= work_eps(task.stages[task.ptr][1]):
                task.remaining = None
                task.ptr += 1
                task.arrived = t
                if task.ptr >= len(task.stages):
                    task.done = True
                    task.completion = t
        if clipped:
            return t_end
    return t


def run_event_loop(tasks: list[TaskRun], mu_node: np.ndarray,
                   mu_link: np.ndarray, *, t: float = 0.0,
                   t_end: float = np.inf, guard: int = 1_000_000,
                   engine: str = "ref", down: frozenset | tuple = ()) -> float:
    """Run the preempt-resume loop with the chosen engine.

    ``engine="ref"`` (default) is the linear-scan loop;
    ``engine="indexed"`` routes through the O(log)-per-event engine of
    :mod:`repro_torch.core.eventsim` — same semantics, same tolerance
    discipline, event times equal up to float accumulation order.
    ``down`` lists resource keys failed for the whole window (both engines
    honour it).
    """
    if engine == "indexed":
        from . import eventsim
        return eventsim.run_event_loop_indexed(
            tasks, mu_node, mu_link, t=t, t_end=t_end, guard=guard,
            down=tuple(down))
    if engine != "ref":
        raise ValueError(f"engine must be 'ref' or 'indexed', got {engine!r}")
    return run_event_loop_ref(tasks, mu_node, mu_link, t=t, t_end=t_end,
                              guard=guard, down=down)


def simulate(net: ComputeNetwork, batch: JobBatch, assign, order=None,
             paths: dict[int, list[list[tuple[int, int]]]] | None = None,
             engine: str = "ref") -> SimResult:
    """Event-driven simulation of the routed jobs in the actual system.

    ``assign`` may be a :class:`~repro_torch.core.plan.Plan` (then
    ``order`` must be omitted and the plan's stored paths, if any, are
    used).  Without paths they are derived by :func:`replay_solution`
    against ``net`` with its queues reset.  ``engine`` picks the event
    loop; the default ``"ref"`` is the reference's default.
    """
    from .plan import Plan
    if isinstance(assign, Plan) and paths is None:
        paths = assign.paths
    assign, order = _as_assign_order(assign, order)
    if paths is None:
        _, paths, _ = replay_solution(net.reset_queues(), batch, assign, order)

    mu_node = net.mu_node.cpu().numpy().astype(np.float64)
    mu_link = net.mu_link.cpu().numpy().astype(np.float64)
    J = batch.num_jobs
    prio_of = {int(order[p]): p for p in range(len(order))}
    stages = job_stages(batch, assign, paths)
    tasks = [TaskRun(stages=stages[j], prio=prio_of[j]) for j in range(J)]
    run_event_loop(tasks, mu_node, mu_link, engine=engine)
    completion = np.array([task.completion for task in tasks], np.float64)
    return SimResult(completion=completion, makespan=float(np.max(completion)))
