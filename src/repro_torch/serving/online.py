"""Online serving loop: streamed arrivals against time-aware network state.

Counterpart of ``repro.serving.online``: host-side bookkeeping around the
port's scheduler, whose solves run on the topology's device.

The static path solves one batch against a snapshot of the queues.  This
loop is the deployment setting: request batches arrive on a clock (Poisson,
bursty, diurnal — ``repro_torch.core.arrivals``), and before each batch is solved
the scheduler **drains** the :class:`~repro_torch.core.state.QueueState` to the
arrival time — the work committed by earlier batches has been getting
served in the meantime.  Two drain models are supported (``drain="fluid" |
"exact"``): the fluid model q <- max(q - mu dt, 0) serves every resource
independently at full rate (fast, optimistic), while the exact model
drains a :class:`~repro_torch.core.completions.CommittedWork` ledger through the
event simulator's preempt-resume loop — exactly the committed jobs, with
priority and precedence.  Under sub-capacity load either keeps backlogs
(and hence latency bounds) bounded; the legacy no-drain commit loop
(``drain_queues=False``, the seed behaviour) only ever adds to Q and
diverges under any sustained traffic (``tests/test_torch_online.py``
asserts the contrast, as the reference's tests do).

``report_slowdown`` / ``replan_last`` are events on the same clock: a
straggler reported at time t degrades the *effective* topology from t on
(slower service and slower draining), and re-planning the last batch scores
it against the state at the current clock.

Per-arrival latency here is the fictitious-system completion bound of each
request measured from its arrival instant — the same quantity the solver
optimizes, now evaluated against a drained (time-correct) queue state.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch import tracing
from repro_torch.core import arrivals as A, completions as C, jobs as J, schedule
from repro_torch.core.state import Topology, backlog_seconds
from .admission import (AdmissionController, AdmissionPolicy, ReplanMonitor,
                        ReplanPolicy)
from .scheduler import Placement, Request, RoutedScheduler, requests_to_jobs


@dataclasses.dataclass(frozen=True)
class ArrivalRecord:
    """What happened at one arrival epoch."""

    time: float
    names: tuple[str, ...]
    latencies: tuple[float, ...]     # per-request completion bounds (s)
    backlog_before: float            # worst-resource wait (s) after draining
    backlog_after: float             # ... after committing this batch
    solve_s: float


@dataclasses.dataclass
class OnlineTrace:
    """Recorded trajectory of one online run.

    ``completions`` holds absolute completion times recorded by the exact
    drain (keyed by job name); ``replay_completions`` holds the
    ground-truth full-horizon event replay of the commit log (when the run
    tracked commits).  ``commit_log`` is that never-drained
    :class:`~repro_torch.core.completions.CommittedWork` record itself — the
    fidelity benchmark replays it under exact semantics.
    """

    records: list[ArrivalRecord] = dataclasses.field(default_factory=list)
    events: list[dict] = dataclasses.field(default_factory=list)
    completions: dict[str, float] = dataclasses.field(default_factory=dict)
    replay_completions: dict[str, float] = dataclasses.field(
        default_factory=dict)
    commit_log: "C.CommittedWork | None" = None
    # Per-request *original* arrival instants (filled by submit_window):
    # a fault-requeued job is committed later under a new name but keeps
    # its original arrival here, so actual latency spans the outage.
    arrivals_by_name: dict[str, float] = dataclasses.field(
        default_factory=dict)
    # Fault-policy losses: (name, reason) for requests that will never
    # complete (shed by the lost policy, unreachable after a failure, ...).
    lost: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    # Requests dropped before commit, one dict each: {"time", "name",
    # "reason", "arrival", ...}.  The admission layer sheds here with
    # reasons ``admission_reject`` / ``deadline_miss`` (a deferred-then-
    # expired arrival is charged from its ORIGINAL arrival time); the
    # streaming pipeline adds ``solver_error`` / ``arrival_unroutable``.
    shed: list[dict] = dataclasses.field(default_factory=list)
    # Live view of the AdmissionController's audit counters (assessed /
    # admitted / rejected / deferred / expired) when admission is on.
    admission: dict = dataclasses.field(default_factory=dict)
    # Relative SLO of every *committed* request that carried one (shed
    # requests keep their deadline inside the shed record).
    deadlines_by_name: dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def times(self) -> np.ndarray:
        return np.array([r.time for r in self.records], np.float64)

    @property
    def backlogs(self) -> np.ndarray:
        """Post-commit worst-resource backlog (s) at each arrival."""
        return np.array([r.backlog_after for r in self.records], np.float64)

    @property
    def latencies(self) -> np.ndarray:
        return np.array([x for r in self.records for x in r.latencies],
                        np.float64)

    def percentile(self, q: float) -> float:
        lat = self.latencies
        return float(np.percentile(lat, q)) if lat.size else float("nan")

    def backlog_growth(self, tol: float = 1e-9) -> float:
        """max backlog over the run's second half / first half.

        ~1 for a stable (drained) system that has reached steady state;
        grows without bound for the no-drain commit loop.  A run whose
        backlog never exceeds ``tol`` in *either* half (low-load streams
        that fully drain between arrivals) is flat by definition and
        returns exactly 1.0 — dividing by the floor would report a
        meaningless ~1e12 "growth" from numerical dust.
        """
        b = self.backlogs
        if b.size < 4:
            return float("nan")
        half = b.size // 2
        first, second = float(b[:half].max()), float(b[half:].max())
        if first <= tol and second <= tol:
            return 1.0
        return float(second / max(first, 1e-12))

    def actual_latencies(self) -> np.ndarray:
        """Per-request *actual* latency (completion - arrival), aligned with
        :attr:`latencies` where completion times are known.

        Uses the exact drain's recorded completions, falling back to the
        ground-truth replay record; requests with no known completion are
        skipped (run with ``finish=True`` to complete every job).  Arrival
        instants come from :attr:`arrivals_by_name` where recorded (a
        fault-requeued job keeps its original arrival), else the commit
        record's time.
        """
        comps = self.completions or self.replay_completions
        return np.array(
            [comps[n] - self.arrivals_by_name.get(n, r.time)
             for r in self.records for n in r.names if n in comps],
            np.float64)

    def shed_by_reason(self) -> dict[str, int]:
        by: dict[str, int] = {}
        for s in self.shed:
            why = s.get("reason", "unknown")
            by[why] = by.get(why, 0) + 1
        return by

    def slo_stats(self) -> dict | None:
        """SLO accounting over requests that carried a finite deadline.

        A committed request *meets* its SLO when its actual completion
        (exact drain, falling back to the ground-truth replay) lands
        within ``deadline_s`` of its original arrival; requests shed by
        admission (``admission_reject`` / ``deadline_miss``) count as
        misses against the offered load; committed requests whose
        completion was never recorded (run without ``finish=True``) are
        reported as pending and excluded from the rate.  Returns None
        when no request ever carried a deadline.
        """
        gated = [s for s in self.shed
                 if s["reason"] in ("admission_reject", "deadline_miss")]
        if not self.deadlines_by_name and not gated:
            return None
        comps = self.completions or self.replay_completions
        met = late = pending = 0
        for name, d in self.deadlines_by_name.items():
            if name not in comps:
                pending += 1
                continue
            lat = comps[name] - self.arrivals_by_name.get(name, 0.0)
            if lat <= d + schedule.time_eps(d):
                met += 1
            else:
                late += 1
        decided = met + late + len(gated)
        out = {"offered": decided + pending, "met": met, "late": late,
               "shed": len(gated), "pending": pending, "goodput": met}
        if decided:
            out["slo_miss_rate"] = (late + len(gated)) / decided
        return out

    def summary(self) -> dict:
        out = {
            "arrivals": len(self.records),
            "requests": int(self.latencies.size),
            "p50_latency_s": self.percentile(50),
            "p99_latency_s": self.percentile(99),
            "max_backlog_s": float(self.backlogs.max()) if self.records else 0.0,
            "final_backlog_s": self.records[-1].backlog_after if self.records else 0.0,
            "backlog_growth": self.backlog_growth(),
        }
        act = self.actual_latencies()
        if act.size:
            out["p50_actual_s"] = float(np.percentile(act, 50))
            out["p99_actual_s"] = float(np.percentile(act, 99))
        if self.lost:
            out["lost"] = len(self.lost)
        if self.shed:
            out["shed"] = len(self.shed)
            out["shed_by_reason"] = self.shed_by_reason()
        if self.admission:
            out["admission"] = dict(self.admission)
        replans = sum(1 for e in self.events if e.get("event") == "replan")
        autos = sum(1 for e in self.events if e.get("event") == "auto_replan")
        skipped: dict[str, int] = {}
        for e in self.events:
            if e.get("event") == "replan_skipped":
                r = e.get("reason") or "unknown"
                skipped[r] = skipped.get(r, 0) + 1
        if replans or autos or skipped:
            out["replans"] = replans
            if autos:
                out["auto_replan_triggers"] = autos
            if skipped:
                out["replans_skipped"] = skipped
        slo = self.slo_stats()
        if slo is not None:
            out["slo"] = slo
        return out

    def to_dict(self) -> dict:
        # ``names``/``completions``/``replay_completions`` carry the exact
        # drain's results: without them a serialized trace loses every
        # actual (ground-truth) completion time and the actual-latency
        # percentiles the summary derives from them.
        return {
            **self.summary(),
            "times": self.times.tolist(),
            "names": [list(r.names) for r in self.records],
            "backlogs": self.backlogs.tolist(),
            "latencies": self.latencies.tolist(),
            "actual_latencies": self.actual_latencies().tolist(),
            "completions": dict(self.completions),
            "replay_completions": dict(self.replay_completions),
            "events": self.events,
            "shed": list(self.shed),
        }


class OnlineScheduler(RoutedScheduler):
    """RoutedScheduler + a clock: drains state to each event before acting.

    ``drain_queues=False`` reproduces the legacy behaviour (queues only
    grow) for divergence comparisons; ``drain="fluid" | "exact"`` picks the
    drain *model* (rate-capacity fluid vs per-plan completion tracking —
    see :mod:`repro_torch.core.completions`); everything else is identical, so
    any gap between two runs is the drain semantics alone.
    """

    def __init__(self, net: Topology, *, method: str = "greedy",
                 drain_queues: bool = True,
                 admission: "AdmissionController | AdmissionPolicy | str | None" = None,
                 auto_replan: "ReplanMonitor | ReplanPolicy | bool | None" = None,
                 **solver_opts):
        super().__init__(net, method=method, **solver_opts)
        self.drain_queues = drain_queues
        self.trace = OnlineTrace()
        if admission is None or isinstance(admission, AdmissionController):
            self.admission = admission
        else:
            self.admission = AdmissionController(admission)
        if self.admission is not None:
            # Live view: the controller mutates this same dict, so the
            # trace summary always reflects current counters.
            self.trace.admission = self.admission.counters
        if auto_replan is None or auto_replan is False:
            self.monitor = None
        elif auto_replan is True:
            self.monitor = ReplanMonitor()
        elif isinstance(auto_replan, ReplanMonitor):
            self.monitor = auto_replan
        else:
            self.monitor = ReplanMonitor(auto_replan)

    # -- clock --------------------------------------------------------------
    @property
    def now(self) -> float:
        """Event time == the scheduler's one authoritative clock."""
        return self.clock

    def advance_to(self, t: float) -> None:
        """Move the clock to absolute time ``t``, draining if enabled.

        The clock always advances — time passing and queue draining are
        independent; ``drain_queues=False`` freezes only the backlogs.
        """
        # Relative tolerance (schedule.time_eps): an absolute 1e-9 slack is
        # below one ulp of the clock once it passes ~2^20 s, so the guard
        # would start rejecting legitimate same-instant events at large
        # clocks.
        if t < self.now - schedule.time_eps(self.now):
            raise ValueError(f"time went backwards: {t} < {self.now}")
        dt = max(t - self.now, 0.0)
        if dt > 0 and self.drain_queues:
            # drains at effective (health-aware) rates, fluid or exact
            with tracing.span("online.drain"):
                self._drain_state(dt)
        self._now = max(self._now, float(t))
        self._stamp_clock()

    # -- events -------------------------------------------------------------
    def submit_jobs(self, t: float, infer_jobs: Sequence[J.InferenceJob],
                    *, pad_to: int | None = None) -> list[Placement]:
        """Arrival event: drain to ``t``, place the batch, record the epoch."""
        return self.submit_window(t, infer_jobs, pad_to=pad_to)

    def submit_window(self, t: float, infer_jobs: Sequence[J.InferenceJob],
                      *, arrivals: Sequence[float] | None = None,
                      pad_to: int | None = None,
                      solve_mode: str = "batched",
                      method: str | None = None) -> list[Placement]:
        """Window-batched submission (the streaming pipeline's hook).

        ``t`` is the *commit* instant: the state drains to it and the whole
        window is placed there in one scheduler entry (one drain sync, one
        backlog accounting pass, one trace record).  ``solve_mode`` picks
        the solver shape inside that entry: ``"batched"`` runs one padded
        batched solve over the window (``batch_jobs(pad_to=)`` operand —
        the accelerator-friendly shape); ``"sequential"`` runs one width-1
        solve per request in window order against the evolving queue state
        — exactly the plans the serial loop would commit for coincident
        arrivals, with none of the padded batch's extra per-round
        evaluation work.  ``arrivals`` gives each request's own arrival
        instant (aligned with ``infer_jobs``); the recorded per-request
        latency is then queueing wait plus the solver's completion bound,
        ``(t - arrival_i) + bound_i`` — the quantity a batching window
        actually delivers.  With ``arrivals`` omitted every request
        arrived at ``t`` and this is exactly :meth:`submit_jobs`; names
        within a window must be unique (they key the wait accounting and
        the exact-drain completions).  After either mode ``last_solve_s``
        holds the window's total solve wall.  The whole entry is the span
        ``online.submit``, whose request id is the first job's name.
        """
        jobs = list(infer_jobs)
        with tracing.span("online.submit", jobs[0].name if jobs else None):
            return self._submit_window(t, jobs, arrivals, pad_to,
                                       solve_mode, method)

    def _submit_window(self, t: float, jobs: list[J.InferenceJob],
                       arrivals: Sequence[float] | None, pad_to: int | None,
                       solve_mode: str, method: str | None
                       ) -> list[Placement]:
        if solve_mode not in ("batched", "sequential"):
            raise ValueError(f"solve_mode must be 'batched' or "
                             f"'sequential', got {solve_mode!r}")
        if arrivals is not None and len(arrivals) != len(jobs):
            raise ValueError(
                f"arrivals ({len(arrivals)}) must align with infer_jobs "
                f"({len(jobs)})")
        arrs = ([float(a) for a in arrivals] if arrivals is not None
                else [float(t)] * len(jobs))
        track_wait = arrivals is not None
        ctl = self.admission
        if ctl is not None and not ctl.external_defer and ctl.deferred:
            # Deferred arrivals ride the next window with their ORIGINAL
            # arrival instants (wait accounting spans the deferral).
            for job, a0 in ctl.pop_deferred():
                jobs.append(job)
                arrs.append(float(a0))
            track_wait = True
        if track_wait:
            names = [j.name for j in jobs]
            if len(set(names)) != len(names):
                raise ValueError("window job names must be unique")
        self.advance_to(t)
        eff = self._effective_topology()
        before = backlog_seconds(eff, self.state)
        reuse, assess_s = None, 0.0
        if ctl is not None and ctl.active(jobs):
            jobs, arrs, reuse, assess_s = self._assess_admission(
                float(t), jobs, arrs, eff, pad_to=pad_to, method=method)
            track_wait = True
        self.trace.deadlines_by_name.update(
            {j.name: j.deadline_s for j in jobs
             if np.isfinite(j.deadline_s)})
        if ctl is not None and not jobs:
            # Admission shed/deferred the whole window: nothing to commit,
            # the shed records already tell the story.
            self.last_solve_s = assess_s
            self.check_replan()
            return []
        wait = ({j.name: float(t) - a for j, a in zip(jobs, arrs)}
                if track_wait else None)
        if solve_mode == "sequential" and len(jobs) > 1:
            placements, walls = [], 0.0
            for job in jobs:
                placements.extend(self.schedule_jobs([job], pad_to=pad_to,
                                                     method=method))
                walls += self.last_solve_s
            self.last_solve_s = walls + assess_s
        elif reuse is not None:
            # Every candidate was admitted: commit the assessment's own
            # solve — admission adds no second dispatch on this path.
            placements = self.commit_presolved(jobs, *reuse)
        else:
            placements = self.schedule_jobs(jobs, pad_to=pad_to,
                                            method=method)
            self.last_solve_s += assess_s
        after = backlog_seconds(eff, self.state)
        self.trace.arrivals_by_name.update(
            {j.name: a for j, a in zip(jobs, arrs)})
        self.trace.records.append(ArrivalRecord(
            time=t,
            names=tuple(p.job_name for p in placements),
            latencies=tuple(p.bound_s if wait is None
                            else wait[p.job_name] + p.bound_s
                            for p in placements),
            backlog_before=before,
            backlog_after=after,
            solve_s=self.last_solve_s,
        ))
        self.check_replan()
        return placements

    def _assess_admission(self, t: float, jobs: list[J.InferenceJob],
                          arrs: list[float], eff: Topology,
                          *, pad_to: int | None, method: str | None):
        """Score one candidate window against its SLOs before committing.

        Pure-solves the whole window (:meth:`~RoutedScheduler.presolve`),
        releases the candidate plan into a *fork* of the live simulation
        (:func:`repro_torch.core.completions.predict_completions` — nothing
        committed), and partitions: a request whose predicted latency
        exceeds ``deadline_s - margin_s`` is shed (``reject``) or parked
        (``defer``).  Falls back to wait + fictitious-system bound when
        there is no exact ledger, or while an outage strands committed
        work (the fork cannot drain to quiescence then).  Returns
        ``(kept_jobs, kept_arrivals, reusable (batch, plan) | None,
        assessment wall)`` — the plan is reusable only when every
        candidate was admitted, otherwise the committed job set differs
        from the assessed batch.
        """
        ctl = self.admission
        ctl.counters["assessed"] += len(jobs)
        batch, plan = self.presolve(jobs, pad_to=pad_to, method=method)
        assess_s = float(plan.meta.get("solve_s", 0.0))
        names = [j.name for j in jobs]
        bounds = np.asarray(plan.bounds, np.float64)
        preds = None
        if self.ledger is not None:
            cand = plan
            if cand.paths is None:
                _, paths, _ = schedule.replay_solution(
                    eff.view(self.state), batch, plan.assign, plan.order)
                cand = dataclasses.replace(plan, paths=paths)
            try:
                preds = C.predict_completions(
                    eff, self.ledger, extra_plans=[(batch, cand, names)],
                    at=t, down=self._down_keys())
            except RuntimeError:
                preds = None
        keep_jobs, keep_arrs = [], []
        for i, (job, a) in enumerate(zip(jobs, arrs)):
            if preds is not None:
                predicted = float(preds[job.name]) - a
            else:
                predicted = (t - a) + float(bounds[i])
            if ctl.admits(predicted, job.deadline_s):
                keep_jobs.append(job)
                keep_arrs.append(a)
                ctl.counters["admitted"] += 1
                continue
            if t - a > job.deadline_s or ctl.final:
                # Already expired (or end-of-stream drain-out): charged as
                # a deadline miss from the ORIGINAL arrival, whatever the
                # policy — deferring again could never help.
                ctl.counters["expired"] += 1
                self._shed_admission(t, job, a, predicted, "deadline_miss")
            elif ctl.policy.policy == "reject":
                ctl.counters["rejected"] += 1
                self._shed_admission(t, job, a, predicted,
                                     "admission_reject")
            else:
                ctl.counters["deferred"] += 1
                ctl.deferred.append((job, a))
                self.trace.events.append(
                    {"time": t, "event": "admission_defer",
                     "name": job.name, "arrival": a,
                     "predicted_s": predicted,
                     "deadline_s": job.deadline_s})
        reuse = (batch, plan) if len(keep_jobs) == len(jobs) else None
        return keep_jobs, keep_arrs, reuse, assess_s

    def _shed_admission(self, t: float, job: J.InferenceJob, arrival: float,
                        predicted: float, reason: str) -> None:
        self.trace.arrivals_by_name.setdefault(job.name, float(arrival))
        self.trace.shed.append({
            "time": float(t), "name": job.name, "reason": reason,
            "arrival": float(arrival), "deadline_s": float(job.deadline_s),
            "predicted_s": float(predicted)})

    def flush_deferred(self, *, at: float | None = None,
                       pad_to: int | None = None) -> list[Placement]:
        """End-of-stream admission sweep: re-assess every still-deferred
        arrival at ``at`` (default: now) in drain-out mode — admitted ones
        commit, predicted misses are shed as ``deadline_miss`` (never
        re-deferred, so the sweep terminates)."""
        ctl = self.admission
        if ctl is None or not ctl.deferred:
            return []
        t = self.now if at is None else max(float(at), self.now)
        ctl.final = True
        try:
            return self.submit_window(t, [], pad_to=pad_to)
        finally:
            ctl.final = False

    def submit_windows(self, t: float,
                       windows: Sequence[Sequence[J.InferenceJob]],
                       *, arrivals: Sequence[Sequence[float]] | None = None,
                       pad_to: int | None = None,
                       method: str | None = None) -> list[list[Placement]]:
        """Cross-arrival fused submission: W queued windows, one dispatch.

        All windows commit at instant ``t`` (one drain sync), solved in
        order against each other's committed queues by
        :meth:`RoutedScheduler.schedule_windows` — the same plans W
        back-to-back :meth:`submit_window` calls at ``t`` would commit,
        in a single fused device program.  One :class:`ArrivalRecord` per
        window keeps the trace shape identical to the sequential path
        (per-window ``solve_s`` is the shared dispatch's per-window
        share); ``arrivals`` aligns per-window arrival instants exactly
        as in :meth:`submit_window`.
        """
        if self.admission is not None and (self.admission.gating
                                           or self.admission.deferred):
            raise ValueError(
                "admission control gates windows one at a time — use "
                "submit_window (fused multi-window dispatch would commit "
                "candidates before they can be assessed)")
        windows = [list(w) for w in windows]
        if arrivals is not None and len(arrivals) != len(windows):
            raise ValueError(f"arrivals ({len(arrivals)}) must align with "
                             f"windows ({len(windows)})")
        waits: list[dict[str, float] | None] = [None] * len(windows)
        if arrivals is not None:
            for w, (jobs, arrs) in enumerate(zip(windows, arrivals)):
                if len(arrs) != len(jobs):
                    raise ValueError(
                        f"window {w}: arrivals ({len(arrs)}) must align "
                        f"with jobs ({len(jobs)})")
                names = [j.name for j in jobs]
                if len(set(names)) != len(names):
                    raise ValueError("window job names must be unique")
                waits[w] = {j.name: float(t) - float(a)
                            for j, a in zip(jobs, arrs)}
        self.advance_to(t)
        eff = self._effective_topology()
        before = backlog_seconds(eff, self.state)
        per_window = self.schedule_windows(windows, pad_to=pad_to,
                                           method=method)
        walls = 0.0
        for w, (jobs, placements) in enumerate(zip(windows, per_window)):
            arrs = (arrivals[w] if arrivals is not None
                    else [t] * len(jobs))
            self.trace.arrivals_by_name.update(
                {j.name: float(a) for j, a in zip(jobs, arrs)})
            # Backlogs come from the scheduler's per-window post-commit
            # snapshots (ledger-synced in exact mode), so the recorded
            # telemetry matches what W submit_window calls would have read
            # — not the solver's fluid committed queues, which differ from
            # the ledger materialization in the last ulp.
            after = backlog_seconds(eff, self._window_states[w])
            solve_w = float(placements[0].plan.meta.get(
                "solve_share_s", placements[0].plan.meta.get("solve_s", 0.0)))
            walls += solve_w
            wait = waits[w]
            self.trace.records.append(ArrivalRecord(
                time=t,
                names=tuple(p.job_name for p in placements),
                latencies=tuple(p.bound_s if wait is None
                                else wait[p.job_name] + p.bound_s
                                for p in placements),
                backlog_before=before,
                backlog_after=after,
                solve_s=solve_w,
            ))
            before = after
        self.last_solve_s = walls
        return per_window

    def submit(self, t: float, requests: list[Request],
               *, pad_to: int | None = None) -> list[Placement]:
        return self.submit_jobs(t, requests_to_jobs(requests), pad_to=pad_to)

    def report_slowdown(self, node: int, factor: float,
                        *, at: float | None = None) -> None:
        """Straggler event on the clock: drain to ``at`` (default: now),
        then degrade the node's effective rate from that instant on
        (``factor=2`` means half speed; must be finite and > 0)."""
        self._check_slowdown(node, factor)  # reject before the clock moves
        if at is not None:
            self.advance_to(at)
        super().report_slowdown(node, factor)
        self.trace.events.append({"time": self.now, "event": "slowdown",
                                  "node": int(node), "factor": float(factor)})

    def report_recovery(self, node: int, *, at: float | None = None) -> None:
        """Recovery event on the clock: drain to ``at`` (default: now) at
        the still-degraded rates, then restore the node to full health."""
        self._check_slowdown(node, 1.0)     # reject before the clock moves
        if at is not None:
            self.advance_to(at)
        RoutedScheduler.report_slowdown(self, node, 1.0)
        self.trace.events.append({"time": self.now, "event": "recovery",
                                  "node": int(node)})

    def set_node_availability(self, node: int, up: bool,
                              *, at: float | None = None) -> None:
        """Availability event on the clock: drain to ``at`` (default: now)
        under the pre-event health, then fail/recover the node."""
        self._check_node(node)              # reject before the clock moves
        if at is not None:
            self.advance_to(at)
        super().set_node_availability(node, up)
        self.trace.events.append(
            {"time": self.now, "event": "node_up" if up else "node_down",
             "node": int(node)})

    def set_link_availability(self, u: int, v: int, up: bool,
                              *, at: float | None = None) -> None:
        """Directed-link availability event on the clock (see
        :meth:`set_node_availability`)."""
        self._check_node(u), self._check_node(v)
        if at is not None:
            self.advance_to(at)
        super().set_link_availability(u, v, up)
        self.trace.events.append(
            {"time": self.now, "event": "link_up" if up else "link_down",
             "link": (int(u), int(v))})

    def replan_last(self, *, min_improvement: float | None = None
                    ) -> list[Placement] | None:
        out = super().replan_last(min_improvement=min_improvement)
        if out is None:
            # Auditable decline: no batch to re-place, or the re-solve
            # didn't clear the min_improvement gate.
            self.trace.events.append(
                {"time": self.now, "event": "replan_skipped",
                 "reason": self.last_replan_reason})
        if out is not None:
            self.trace.events.append({"time": self.now, "event": "replan",
                                      "reason": self.last_replan_reason,
                                      "bound_s": self.last_plan.bound()})
            # The last arrival record described the superseded plan; refresh
            # it so bound-vs-actual comparisons stay honest.  The new bound
            # is measured from *now*, so from the original arrival instant
            # the completion bound is (now - arrival) + new bound.
            rec = self.trace.records[-1] if self.trace.records else None
            if rec is not None and set(rec.names) == {p.job_name
                                                      for p in out}:
                bound_by_name = {p.job_name: p.bound_s for p in out}
                wait = self.now - rec.time
                self.trace.records[-1] = dataclasses.replace(
                    rec,
                    latencies=tuple(wait + bound_by_name[n]
                                    for n in rec.names),
                    backlog_after=backlog_seconds(
                        self._effective_topology(), self.state))
        return out

    # -- SLO guard ----------------------------------------------------------
    def plan_divergence(self) -> float | None:
        """How far reality has drifted from the last committed plan.

        Exact mode: forks the live simulation, predicts every last-batch
        job's completion under *current* health, and returns the worst
        relative excess over the bound it was committed with —
        ``(predicted - commit instant) / bound - 1`` (0 = on plan, 0.5 =
        running 50% over).  Fluid mode falls back to measured-vs-expected
        backlog, scaled by the plan's worst bound.  Returns None when
        there is nothing to compare (no batch committed yet, or an outage
        strands committed work so the fork cannot drain).  Read-only —
        nothing is committed or mutated.
        """
        if self._last is None or self.last_plan is None:
            return None
        _, infer_jobs, _, _, pre_now, _, _ = self._last
        bounds = np.asarray(self.last_plan.bounds, np.float64)
        if self.ledger is not None:
            try:
                preds = C.predict_completions(
                    self._effective_topology(), self.ledger,
                    down=self._down_keys())
            except RuntimeError:
                return None
            worst = None
            for i, job in enumerate(infer_jobs):
                b = float(bounds[i])
                if job.name not in preds or b <= 0:
                    continue
                div = (preds[job.name] - pre_now) / b - 1.0
                worst = div if worst is None else max(worst, div)
            return worst
        if not self.trace.records:
            return None
        rec = self.trace.records[-1]
        expected = max(rec.backlog_after - (self.now - rec.time), 0.0)
        measured = backlog_seconds(self._effective_topology(), self.state)
        return (measured - expected) / max(float(bounds.max()), 1e-9)

    def check_replan(self) -> bool:
        """One auto-replan monitor observation (no-op without
        ``auto_replan``); True iff a re-plan was committed.  Called after
        every window commit; drivers also call it after fault events."""
        return self.monitor is not None and self.monitor.check(self)

    # -- end-of-run accounting -----------------------------------------------
    def finish(self) -> dict[str, float]:
        """Serve all committed work to completion under exact semantics.

        Requires ``drain="exact"``.  The clock jumps to the last
        completion, the queues empty, and every job's absolute completion
        time lands in ``trace.completions`` (and is returned).
        """
        if self.ledger is None:
            raise ValueError("finish() requires drain='exact'")
        comps, self.ledger = C.run_to_completion(
            self._effective_topology(), self.ledger,
            engine=self.sim_engine, down=self._down_keys())
        self._sync_ledger_queues()
        if comps:
            self._now = max(self._now, max(comps.values()))
        self._stamp_clock()
        self.trace.completions.update(comps)
        return comps

    def replay_ground_truth(self) -> dict[str, float]:
        """Full-horizon event replay of every committed plan.

        Requires ``track_commits=True``.  Replays the never-drained commit
        log through the event simulator *piecewise*: every
        ``report_slowdown`` was recorded in the log's health history, and
        each segment replays at the effective topology actually in force
        during it (a log with no health events replays at base health in
        one segment).  Results land in ``trace.replay_completions``.
        """
        if self.commit_log is None:
            raise ValueError("replay_ground_truth() requires "
                             "track_commits=True")
        comps, _ = C.replay_piecewise(self.topology, self.commit_log,
                                      engine=self.sim_engine)
        self.trace.replay_completions.update(comps)
        self.trace.commit_log = self.commit_log
        return comps


def run_online(scenario, *, horizon: float, seed: int = 0,
               process: str = "poisson", rate: float | None = None,
               batch_size: int = 1, method: str = "greedy",
               drain_queues: bool = True, finish: bool = False,
               pad_to: int | None = None,
               process_params: dict | None = None,
               fault_schedule=None, recovery: str = "requeue",
               max_retries: int = 3,
               deadline_s: float | None = None,
               admission=None, auto_replan=None,
               **solver_opts) -> OnlineTrace:
    """Drive a scenario through an arrival stream; return the trace.

    ``scenario`` is anything with ``.topology`` and
    ``.sample_jobs(rng, n) -> list[InferenceJob]`` —
    ``repro_torch.scenarios.make_scenario(...)`` is the canonical source.

    **Process-params contract.**  ``process`` names an arrival process from
    ``repro_torch.core.arrivals``; ``process_params`` are its keyword arguments,
    passed through verbatim and always winning over the ``rate`` shorthand.
    ``rate`` maps onto each built-in process's own parameters where the
    mapping is well-defined:

      * ``poisson`` / ``bursty`` — ``rate`` is the process's ``rate``;
      * ``diurnal`` — ``rate`` scales the whole profile: ``peak_rate =
        rate`` and ``base_rate = peak_rate / 5`` (the module defaults'
        5:1 peak:base ratio) unless given explicitly;
      * any other registered process — the shorthand is ambiguous, so
        passing ``rate`` raises ``ValueError``; use ``process_params``.

    ``drain_queues=False`` is the legacy no-drain baseline; pass
    ``drain="fluid" | "exact"`` / ``track_commits=True`` through to the
    scheduler to pick the drain model and keep a ground-truth commit log.
    ``finish=True`` completes the accounting after the last arrival: the
    exact ledger (if any) is served to completion into
    ``trace.completions`` and the commit log (if any) is replayed into
    ``trace.replay_completions``.

    ``fault_schedule`` (a :class:`~repro_torch.serving.faults.FaultSchedule` or
    any iterable of :class:`~repro_torch.serving.faults.FaultEvent`) injects
    infrastructure events between arrivals on the same clock; ``recovery``
    picks the policy for work caught on a failed resource (``"requeue"`` |
    ``"migrate"`` | ``"lost"``, with at most ``max_retries`` re-placements
    per job) — requires ``drain="exact"``.

    ``deadline_s`` attaches a uniform relative SLO to every sampled job
    (a job's own finite ``deadline_s`` wins); ``admission`` /
    ``auto_replan`` are forwarded to :class:`OnlineScheduler` — an
    :class:`~repro_torch.serving.admission.AdmissionPolicy` (or its name) gates
    arrivals against predicted completions, a
    :class:`~repro_torch.serving.admission.ReplanPolicy` (or ``True``) arms the
    SLO-guarded re-plan monitor, which is also consulted after every
    injected fault.  Still-deferred arrivals get one drain-out admission
    sweep after the last arrival, before ``finish``.
    """
    rng = np.random.default_rng(seed)
    params = A.resolve_rate(process, rate, process_params)
    times = A.make_process(process, **params)(rng, horizon)
    sched = OnlineScheduler(scenario.topology, method=method,
                            drain_queues=drain_queues, admission=admission,
                            auto_replan=auto_replan, **solver_opts)
    if pad_to is None:
        pad_to = getattr(scenario, "max_layers", None)
    injector, faults, fi = None, [], 0
    if fault_schedule is not None:
        from .faults import FaultInjector
        faults = sorted(fault_schedule, key=lambda ev: ev.time)
        injector = FaultInjector(sched, policy=recovery,
                                 max_retries=max_retries, pad_to=pad_to)
    for t in times:
        while fi < len(faults) and faults[fi].time <= float(t):
            injector.apply(faults[fi])
            fi += 1
            sched.check_replan()
        jobs = scenario.sample_jobs(rng, batch_size)
        if deadline_s is not None:
            jobs = [j if np.isfinite(j.deadline_s)
                    else j.with_deadline(deadline_s) for j in jobs]
        if injector is not None and sched.degraded:
            jobs = injector.filter_arrivals(float(t), jobs)
            if not jobs:
                continue
        sched.submit_jobs(float(t), jobs, pad_to=pad_to)
    while fi < len(faults) and faults[fi].time <= horizon:
        injector.apply(faults[fi])
        fi += 1
        sched.check_replan()
    sched.flush_deferred(pad_to=pad_to)
    if finish:
        if sched.ledger is not None:
            sched.finish()
        if sched.commit_log is not None:
            sched.replay_ground_truth()
    sched.trace.commit_log = sched.commit_log
    return sched.trace
