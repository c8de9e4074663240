"""Indexed preempt-resume event engine: the exact drain's hot path.

Counterpart of ``repro.core.eventsim``: host-side float64 numpy, the same
operations in the same order, so its event times equal the reference
package's bit for bit on the same task lists.  It takes rates as host
arrays (``np.asarray`` refuses a CUDA tensor): callers copy the
topology's device tensors to the host once per engine, never per event.

The linear-scan loop (:func:`repro_torch.core.schedule.run_event_loop_ref`) rescans
every task at every event to rebuild the per-resource serving heads —
O(events x tasks), with every resource's rate looked up per event.  That is
fine for one-shot simulation of a small batch, but the online serving loop
in exact-drain mode runs it *per arrival*, over every live committed job,
at us-backbone:lm scale.

:class:`EventEngine` replaces the scan with three indexes:

  * ``ready`` — per-resource min-heaps of ``(priority, task, stage)`` over
    *arrived* tasks whose current stage runs on that resource, with lazy
    deletion: an entry is stale the moment its task moved past that stage,
    so preemption never has to find-and-remove anything.
  * a single global event heap holding only the *next* completion per busy
    resource (epoch-guarded against preemption) plus the pending stage
    arrivals — never one entry per task.
  * virtual-time residuals — a serving task's ``remaining`` is only
    materialized when its resource's serving head changes (preemption,
    completion, rate change, window end).  An uncontested stage costs one
    heap push and one pop no matter how many events fire elsewhere.

Cost per event: O(log) heap work — O((events + arrivals) * log) per drain
window instead of O(events * tasks * resources).  The engine is
*persistent*: it keeps its indexes alive across drain windows (finite
``t_end`` calls to :meth:`advance`), across commits (:meth:`add_tasks`
mid-stream), and across rate changes (:meth:`set_rates` re-prices only the
busy heads), which is how :mod:`repro_torch.core.completions` stops rebuilding
every ``TaskRun`` per online arrival.

Semantics are the reference loop's exactly — strict priority, preempt-
resume, work-conserving, precedence via stage order, the shared
:func:`repro_torch.core.schedule.time_eps` tolerance discipline — and event
times agree with the reference up to float accumulation order (the
reference decrements every serving residual at every global event; the
engine decrements each residual once per head change).  Parity is gated by
``tests/test_torch_eventsim.py``.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from . import schedule

# Event kinds, ordered so a completion at time t fires before a stage
# arrival at the same t — the reference loop applies a step's completions
# before the next serving re-decision sees new arrivals, and the order
# matters at a knife edge: an arrival processed first would preempt a head
# whose residual just hit zero, deferring its completion by a whole
# service quantum.  (Coincidences *between* the engines' float
# accumulation orders can still race; the parity gate budgets those.)
_DONE, _ARR = 0, 1


class EventEngine:
    """Indexed preempt-resume simulator over :class:`~repro_torch.core.schedule.TaskRun` records.

    Mutates the task records in place exactly like the reference loop
    (``ptr``/``remaining``/``arrived``/``done``/``completion``), so the
    two engines are drop-in interchangeable on the same task lists.
    """

    def __init__(self, mu_node, mu_link, *, clock: float = 0.0,
                 guard: int = 1_000_000):
        mu_node = np.asarray(mu_node, np.float64)
        mu_link = np.asarray(mu_link, np.float64)
        self.V = int(mu_node.shape[0])
        # Flat rate/backlog vectors indexed by resource id:
        # node u -> u, link (u, v) -> V + u*V + v.
        self._rate = np.concatenate([mu_node, mu_link.reshape(-1)])
        self._q = np.zeros_like(self._rate)   # residual committed work
        self.now = float(clock)
        self.guard = int(guard)
        self.tasks: list[schedule.TaskRun] = []
        self._stage_res: list[list[int]] = []  # [task][stage] -> resource id
        self._ready: dict[int, list] = {}      # res id -> heap of (prio, i, ptr)
        self._head: dict[int, int] = {}        # busy res id -> serving task
        self._head_since: dict[int, float] = {}
        self._epoch: dict[int, int] = {}       # invalidates completion events
        self._events: list = []                # (time, kind, seq, a, b)
        self._seq = 0
        self.live = 0                          # unfinished tasks
        self.events_processed = 0              # real (non-stale) events
        self.completions: list[tuple[int, float]] = []  # (task index, time)
        self._down: set[int] = set()           # failed resource ids

    # -- resource ids ---------------------------------------------------------
    def _res_id(self, res: tuple) -> int:
        if res[0] == "node":
            return int(res[1])
        return self.V + int(res[1]) * self.V + int(res[2])

    def _res_key(self, rid: int) -> tuple:
        if rid < self.V:
            return ("node", rid)
        rid -= self.V
        return ("link", rid // self.V, rid % self.V)

    # -- loading work ---------------------------------------------------------
    def add_tasks(self, tasks: list[schedule.TaskRun]) -> None:
        """Index new tasks (a committed batch, or the initial load).

        Tasks whose current stage has already arrived (``arrived <= now``
        up to :func:`~repro_torch.core.schedule.time_eps`) enter the ready heaps
        immediately and may preempt; later stage arrivals become events.
        """
        t = self.now
        eps = schedule.time_eps(t)
        touched = set()
        for task in tasks:
            i = len(self.tasks)
            self.tasks.append(task)
            self._stage_res.append([self._res_id(res)
                                    for res, _ in task.stages])
            if task.done:
                continue
            if task.ptr >= len(task.stages):   # no work at all
                task.done = True
                task.completion = task.arrived
                self.completions.append((i, task.arrived))
                continue
            self.live += 1
            # Residual committed work into the incremental backlog arrays.
            sres = self._stage_res[i]
            for k in range(task.ptr, len(task.stages)):
                w = (task.remaining if k == task.ptr
                     and task.remaining is not None else task.stages[k][1])
                self._q[sres[k]] += w
            if task.arrived > t + eps:
                self._push_event(task.arrived, _ARR, i, task.ptr)
            else:
                if task.remaining is None:
                    task.remaining = task.stages[task.ptr][1]
                rid = sres[task.ptr]
                heapq.heappush(self._ready.setdefault(rid, []),
                               (task.prio, i, task.ptr))
                touched.add(rid)
        for rid in touched:
            self._contest(rid, t)

    # -- what-if forking ------------------------------------------------------
    def fork(self) -> "EventEngine":
        """Independent what-if copy of the live simulation, O(tasks + V^2).

        The fork owns its rate/backlog arrays, task records, ready heaps,
        event heap, and head/epoch maps, so advancing or mutating it never
        perturbs this engine — and vice versa.  Stage lists are shared
        (the engine treats ``TaskRun.stages`` as immutable), which is what
        makes the copy cheap: no ledger re-fold, no index rebuild, no
        re-routing.  Advancing a fork from the same state fires the exact
        same float operations in the same order as advancing the original,
        so predictions made on a fork are bit-identical to the realized
        trajectory until new work or health events diverge them.
        """
        new = EventEngine.__new__(EventEngine)
        new.V = self.V
        new._rate = self._rate.copy()
        new._q = self._q.copy()
        new.now = self.now
        new.guard = self.guard
        new.tasks = [dataclasses.replace(task) for task in self.tasks]
        new._stage_res = list(self._stage_res)   # inner lists are read-only
        new._ready = {rid: list(h) for rid, h in self._ready.items()}
        new._head = dict(self._head)
        new._head_since = dict(self._head_since)
        new._epoch = dict(self._epoch)
        new._events = list(self._events)
        new._seq = self._seq
        new.live = self.live
        new.events_processed = self.events_processed
        new.completions = list(self.completions)
        new._down = set(self._down)
        return new

    # -- rates ----------------------------------------------------------------
    def set_rates(self, mu_node, mu_link) -> None:
        """Re-price service (straggler events between windows).

        No-op when the rates are unchanged; otherwise materializes every
        busy head at the old rates up to ``now``, then reschedules each
        head's completion at its new rate — O(busy resources), never
        O(tasks).
        """
        rate = np.concatenate([np.asarray(mu_node, np.float64),
                               np.asarray(mu_link, np.float64).reshape(-1)])
        if np.array_equal(rate, self._rate):
            return
        t = self.now
        for rid in list(self._head):
            self._touch(rid, t)
        self._rate = rate
        for rid, i in list(self._head.items()):
            self._set_head(rid, i, t)   # epoch bump invalidates the old event

    # -- availability ---------------------------------------------------------
    def remove_resource(self, res: tuple) -> None:
        """Mark a resource failed from ``now`` on (idempotent).

        The serving head (if any) is materialized — work served before the
        failure stays served — and unseated; its scheduled completion event
        goes stale via the epoch guard (lazy invalidation, nothing is
        searched or removed from the heaps).  Ready tasks stay indexed and
        simply wait; no new head is seated until :meth:`restore_resource`.
        Clearing the blocked work itself (requeue / migrate / shed) is the
        recovery policy's job, via :meth:`remove_tasks`.
        """
        rid = self._res_id(res)
        if rid in self._down:
            return
        self._down.add(rid)
        if rid in self._head:
            self._touch(rid, self.now)
            del self._head[rid]
            del self._head_since[rid]
            self._epoch[rid] = self._epoch.get(rid, 0) + 1

    def restore_resource(self, res: tuple) -> None:
        """Resource recovered (idempotent): the highest-priority ready task
        blocked on it resumes serving from ``now`` at its banked residual."""
        rid = self._res_id(res)
        if rid not in self._down:
            return
        self._down.discard(rid)
        top = self._peek(rid)
        if top is not None:
            self._set_head(rid, top, self.now)

    def remove_tasks(self, idxs) -> None:
        """Withdraw live tasks from the simulation (fault policies: the
        job's remaining work is requeued elsewhere, migrated, or lost).

        Work already served stays served; every residual stage leaves the
        incremental backlog arrays.  No completion is recorded — the task
        goes done-without-completion, so a ledger fold simply drops it from
        the live set.  Index entries (ready heaps, pending events) go stale
        lazily, exactly like a preemption.
        """
        t = self.now
        freed = set()
        for i in idxs:
            task = self.tasks[i]
            if task.done:
                continue
            sres = self._stage_res[i]
            rid = sres[task.ptr]
            if self._head.get(rid) == i:
                self._touch(rid, t)   # bank the partial service
                del self._head[rid]
                del self._head_since[rid]
                self._epoch[rid] = self._epoch.get(rid, 0) + 1
                freed.add(rid)
            for k in range(task.ptr, len(task.stages)):
                w = (task.remaining if k == task.ptr
                     and task.remaining is not None else task.stages[k][1])
                self._q[sres[k]] -= w
            task.done = True          # withdrawn, not served to completion
            self.live -= 1
        for rid in freed:
            top = self._peek(rid)
            if top is not None:
                self._set_head(rid, top, t)

    def sync(self, mu_node, mu_link, down=()) -> None:
        """Rates + availability in one step, in the only safe order.

        ``down`` is the *authoritative* set of currently-failed resource
        keys: resources newly failed are unseated **before** re-pricing (a
        busy head on a zeroed rate would otherwise trip the dead-resource
        guard), and recoveries are re-seated **after** (at their new
        rates).  Passing ``down=()`` restores everything.
        """
        want = {self._res_id(res) for res in down}
        for rid in sorted(want - self._down):
            self.remove_resource(self._res_key(rid))
        self.set_rates(mu_node, mu_link)
        for rid in sorted(self._down - want):
            self.restore_resource(self._res_key(rid))

    # -- index internals ------------------------------------------------------
    def _push_event(self, time: float, kind: int, a: int, b: int) -> None:
        self._seq += 1
        heapq.heappush(self._events, (time, kind, self._seq, a, b))

    def _peek(self, rid: int):
        """Min-priority *valid* ready task on ``rid`` (lazy deletion)."""
        h = self._ready.get(rid)
        while h:
            prio, i, ptr = h[0]
            task = self.tasks[i]
            if task.done or task.ptr != ptr:
                heapq.heappop(h)      # stale: task moved on
                continue
            return i
        return None

    def _touch(self, rid: int, t: float) -> None:
        """Materialize the head's virtual-time residual up to ``t``."""
        i = self._head.get(rid)
        if i is None:
            return
        dt = t - self._head_since[rid]
        if dt > 0.0:
            served = self._rate[rid] * dt
            self.tasks[i].remaining -= served
            self._q[rid] -= served
        self._head_since[rid] = t

    def _set_head(self, rid: int, i: int, t: float) -> None:
        if rid in self._down:
            return                    # failed resource serves nothing
        task = self.tasks[i]
        rate = self._rate[rid]
        if rate <= 0:
            raise RuntimeError(
                f"job with priority {task.prio} scheduled on dead "
                f"resource {self._res_key(rid)}")
        self._head[rid] = i
        self._head_since[rid] = t
        ep = self._epoch[rid] = self._epoch.get(rid, 0) + 1
        self._push_event(t + task.remaining / rate, _DONE, rid, ep)

    def _contest(self, rid: int, t: float) -> None:
        """Re-decide the serving head after ready-heap pushes."""
        if rid in self._down:
            return                    # ready work waits out the outage
        top = self._peek(rid)
        cur = self._head.get(rid)
        if top is None or top == cur:
            return
        if cur is not None:
            self._touch(rid, t)       # preempted: bank the served work
        self._set_head(rid, top, t)

    # -- event firing ---------------------------------------------------------
    def _fire_arr(self, t: float, i: int, ptr: int) -> bool:
        task = self.tasks[i]
        if task.done or task.ptr != ptr:
            return False
        if task.remaining is None:
            task.remaining = task.stages[ptr][1]
        rid = self._stage_res[i][ptr]
        heapq.heappush(self._ready.setdefault(rid, []), (task.prio, i, ptr))
        self._contest(rid, t)
        return True

    def _fire_done(self, t: float, rid: int, ep: int) -> bool:
        if self._epoch.get(rid) != ep:
            return False              # head changed since this was scheduled
        i = self._head.pop(rid)
        del self._head_since[rid]
        self._epoch[rid] = ep + 1
        task = self.tasks[i]
        self._q[rid] -= task.remaining   # residual since the last touch
        task.remaining = None
        task.ptr += 1
        task.arrived = t
        if task.ptr >= len(task.stages):
            task.done = True
            task.completion = t
            self.live -= 1
            self.completions.append((i, t))
        else:
            # Next stage arrives here and now; its heap entry is pushed
            # before the freed resource re-decides, so a same-resource
            # follow-on stage (consecutive layers on one node) contends.
            task.remaining = task.stages[task.ptr][1]
            rid2 = self._stage_res[i][task.ptr]
            heapq.heappush(self._ready.setdefault(rid2, []),
                           (task.prio, i, task.ptr))
            if rid2 != rid:
                self._contest(rid2, t)
        top = self._peek(rid)
        if top is not None:
            self._set_head(rid, top, t)
        return True

    # -- driving --------------------------------------------------------------
    def advance(self, t_end: float = np.inf) -> float:
        """Serve until ``t_end`` (or to completion when infinite).

        Fires events in time order; with a finite window, busy heads are
        materialized at ``t_end`` so residuals (and the backlog arrays)
        reflect the partial slice — exactly the reference loop's clipped
        final step.  Returns the reference loop's stop time: ``t_end`` if
        work remains beyond it, else the instant the last event fired.
        """
        t_end = float(t_end)
        steps = 0
        last = self.now
        while self.live > 0 and self._events:
            time = self._events[0][0]
            if time > t_end:
                break
            _, kind, _, a, b = heapq.heappop(self._events)
            fired = (self._fire_arr(time, a, b) if kind == _ARR
                     else self._fire_done(time, a, b))
            if fired:
                last = max(last, float(time))
                self.now = max(self.now, float(time))
                steps += 1
                self.events_processed += 1
                if steps > self.guard:
                    raise RuntimeError("simulator did not converge")
        if np.isfinite(t_end):
            for rid in list(self._head):
                self._touch(rid, t_end)
            self.now = t_end
            return t_end if self.live > 0 else last
        if self.live > 0:
            if self._down:
                raise RuntimeError(
                    f"{self.live} live task(s) blocked on failed resources "
                    f"{sorted(self._res_key(r) for r in self._down)} with "
                    f"no pending events: restore the resources or clear "
                    f"the work first (recovery policies requeue, migrate, "
                    f"or shed it)")
            raise RuntimeError(
                "event engine stalled with live tasks and no events — "
                "index invariant broken")
        return self.now

    def materialize(self) -> None:
        """Bank every busy head's virtual-time residual up to ``now``."""
        for rid in list(self._head):
            self._touch(rid, self.now)

    def queue_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Residual committed work per resource, materialized to ``now``.

        float64 ``(q_node [V], q_link [V, V])`` maintained incrementally —
        O(V^2) copy, never a rescan of live jobs.  Clamped at zero (float
        drift from incremental subtraction is ~1 ulp per event).
        """
        self.materialize()
        qn = np.maximum(self._q[:self.V], 0.0)
        ql = np.maximum(self._q[self.V:], 0.0).reshape(self.V, self.V)
        return qn, ql


def run_event_loop_indexed(tasks: list[schedule.TaskRun], mu_node, mu_link,
                           *, t: float = 0.0, t_end: float = np.inf,
                           guard: int = 1_000_000,
                           down: tuple = ()) -> float:
    """Drop-in replacement for :func:`repro_torch.core.schedule.run_event_loop_ref`.

    Builds a fresh engine over ``tasks`` and advances it — same mutation
    contract, same return value.  ``down`` lists resource keys failed for
    the whole window (work on them waits).  For the persistent
    (cross-window) use hold an :class:`EventEngine` instead.
    """
    eng = EventEngine(mu_node, mu_link, clock=t, guard=guard)
    for res in down:
        eng.remove_resource(res)
    eng.add_tasks(tasks)
    return eng.advance(t_end)
