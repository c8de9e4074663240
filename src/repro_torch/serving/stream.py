"""Streaming serving pipeline: ingestion queue, batching window, decoupled
solver/drain stages with backpressure.

Counterpart of ``repro.serving.stream``.  The serial online loop
(:func:`repro_torch.serving.online.run_online`) handles one arrival at a
time: drain -> solve -> commit, a full solver invocation per request.
This module restructures serving as a simulated-time pipeline of three
decoupled stages:

  1. **Ingestion queue + batching window.**  Arrivals stream in one epoch at
     a time (:func:`repro_torch.core.arrivals.stream_times` /
     ``Scenario.job_stream`` are the iterator views).  The first admitted
     request opens a *window*; the window closes after ``window_s`` (δ)
     simulated seconds or as soon as ``max_batch`` (B) requests have
     accumulated, whichever comes first, and the whole window is placed in
     **one** scheduler entry — one drain sync, one backlog accounting
     pass, one trace record.  ``solve_mode`` picks the solver shape
     inside it: one padded batched solve (``batch_jobs(pad_to=)``), or
     ``"sequential"`` width-1 solves in window order (the serial loop's
     plans with the per-entry overhead still amortized).  A partial window
     left open when the stream ends is flushed at the horizon.
  2. **Decoupled solver and drain stages.**  Closed windows queue for a
     single solver server; its wall-time is *modeled on the simulated
     clock* (``solver_latency`` — a constant, or ``"measured"``: an EMA of
     the real solve walls the scheduler reports via ``last_solve_s``), so
     solve latency itself delays commits and a slow solver visibly backs
     the system up.  With ``fuse_windows > 1`` (batched mode) the solver
     server takes up to that many queued windows per start in one
     cross-arrival call (:meth:`OnlineScheduler.submit_windows`).
     :func:`run_stream`'s ``warmup=True`` runs throwaway solves at the
     serving shapes first and seeds the ``"measured"`` EMA with a warm
     solve's wall.  The port has no jit, so no solve pays a compile and
     ``StreamTrace.compile_walls`` stays empty.  The drain — the
     authoritative :class:`~repro_torch.core.eventsim.EventEngine` clock in
     exact mode, the fluid model otherwise — advances independently
     underneath: the scheduler drains to each *commit* instant, not to
     each arrival.
  3. **Backpressure.**  At most ``max_pending`` admitted-but-uncommitted
     requests are in flight.  When the solver falls behind, further
     arrivals are *deferred* (they wait in a FIFO spill queue and are
     admitted — in arrival order, so backpressure never reorders them — as
     commits free capacity, with the extra wait charged to their latency)
     or, with ``policy="shed"``, dropped and accounted.

Per-request latency decomposes as **wait + service**: wait is everything
before the plan lands (window residence + solver queue + modeled solve
latency), service is the solver's completion bound from the commit instant.
:class:`StreamTrace` extends the serial :class:`OnlineTrace` with that
decomposition, per-window records, shed/deferral accounting, and a
sustained-throughput summary.

Correctness gate: with δ=0, B=1 and zero modeled solver latency every
window is a single request committed at its own arrival instant, and the
pipeline reproduces the serial ``OnlineScheduler`` trace **bit-identically**
(``tests/test_torch_stream.py`` holds it).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import arrivals as A, jobs as J
from repro_torch.core.state import Topology
from .online import OnlineScheduler, OnlineTrace


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming pipeline.

    ``window_s`` (δ) and ``max_batch`` (B) shape the batching window;
    ``solve_mode`` picks the solver shape inside each window's single
    scheduler entry (``"batched"``: one padded batched solve — the
    accelerator-friendly operand; ``"sequential"``: width-1 solves in
    window order — serial plans, amortized dispatch);
    ``solver_latency`` models the solver stage's wall-time on the simulated
    clock (seconds per solve, or ``"measured"`` for an EMA of the real
    solve walls); ``max_pending`` bounds the admitted-but-uncommitted
    buffer and ``policy`` picks what happens to arrivals beyond it
    (``"defer"`` queues them FIFO, ``"shed"`` drops them).
    ``fuse_windows`` lets one solver start drain up to that many queued
    windows in a single cross-arrival fused dispatch (batched mode only;
    the default 1 preserves the window-per-dispatch behaviour the δ=0/B=1
    serial-parity gate is defined over).
    """

    window_s: float = 0.0
    max_batch: int = 1
    solve_mode: str = "batched"
    solver_latency: float | str = 0.0
    max_pending: int | None = None
    policy: str = "defer"
    fuse_windows: int = 1

    def __post_init__(self):
        if self.window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {self.window_s}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.fuse_windows < 1:
            raise ValueError(
                f"fuse_windows must be >= 1, got {self.fuse_windows}")
        if self.policy not in ("defer", "shed"):
            raise ValueError(
                f"policy must be 'defer' or 'shed', got {self.policy!r}")
        if self.solve_mode not in ("batched", "sequential"):
            raise ValueError(f"solve_mode must be 'batched' or "
                             f"'sequential', got {self.solve_mode!r}")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 (or None), got {self.max_pending}")
        if isinstance(self.solver_latency, str):
            if self.solver_latency != "measured":
                raise ValueError(
                    f"solver_latency must be seconds or 'measured', got "
                    f"{self.solver_latency!r}")
        elif not (float(self.solver_latency) >= 0):
            raise ValueError(
                f"solver_latency must be >= 0, got {self.solver_latency}")


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Latency decomposition of one committed request."""

    name: str
    window: int          # index of the window that carried it
    arrival_s: float     # instant the request arrived at the pipeline
    admit_s: float       # instant it entered a window (> arrival if deferred)
    close_s: float       # instant its window closed (flush or B reached)
    commit_s: float      # instant its plan landed (clock of the solve)
    solve_s: float       # modeled solver latency charged to its window
    service_s: float     # solver's completion bound from the commit instant

    @property
    def wait_s(self) -> float:
        """Everything before service: window residence + solver queue +
        modeled solve latency."""
        return self.commit_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        """Solver-queue share of the wait (window close -> solve start)."""
        return (self.commit_s - self.solve_s) - self.close_s

    @property
    def latency_s(self) -> float:
        return self.wait_s + self.service_s


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """One batching window's life cycle."""

    index: int
    open_s: float
    close_s: float
    commit_s: float
    size: int
    solve_model_s: float   # latency modeled on the simulated clock
    solve_wall_s: float    # wall-time the solve actually took


@dataclasses.dataclass
class StreamTrace(OnlineTrace):
    """:class:`OnlineTrace` + the streaming decomposition.

    ``records`` (inherited) holds one :class:`ArrivalRecord` per *window*
    commit — so every serial-trace metric (p99, backlog growth) reads the
    same way — while ``requests`` decomposes each request's latency into
    wait/solve/service and ``windows``/``shed``/``deferred`` account for
    the batching and backpressure machinery.
    """

    requests: list[RequestRecord] = dataclasses.field(default_factory=list)
    windows: list[WindowRecord] = dataclasses.field(default_factory=list)
    # ``shed`` is inherited from OnlineTrace: backpressure / fault / solver
    # sheds and the admission layer's rejections share one list and one
    # ``shed_by_reason`` accounting.
    deferred: int = 0
    # Solve walls that paid a compile: none in the port (no jit); kept so
    # summary() reports the reference's keys.
    compile_walls: list[float] = dataclasses.field(default_factory=list)

    def _field(self, name: str) -> np.ndarray:
        return np.array([getattr(r, name) for r in self.requests],
                        np.float64)

    @property
    def waits(self) -> np.ndarray:
        return self._field("wait_s")

    @property
    def services(self) -> np.ndarray:
        return self._field("service_s")

    @property
    def solves(self) -> np.ndarray:
        return self._field("solve_s")

    def sustained_arr_s(self) -> float:
        """Committed requests per simulated second, first arrival to last
        commit — the throughput the pipeline actually *sustained* (a
        backed-up solver stretches the commit horizon and lowers it)."""
        if len(self.requests) < 2:
            return float("nan")
        span = (max(r.commit_s for r in self.requests)
                - min(r.arrival_s for r in self.requests))
        if span <= 0:
            return float("nan")
        return len(self.requests) / span

    def summary(self) -> dict:
        out = super().summary()
        out.update({
            "windows": len(self.windows),
            "mean_window": (len(self.requests) / len(self.windows)
                            if self.windows else float("nan")),
            "deferred": self.deferred,
            "shed": len(self.shed),
            "sustained_arr_s": self.sustained_arr_s(),
            "compile_solves": len(self.compile_walls),
            "compile_wall_s": float(sum(self.compile_walls)),
        })
        if self.requests:
            for key, arr in (("wait", self.waits), ("solve", self.solves),
                             ("service", self.services)):
                out[f"p50_{key}_s"] = float(np.percentile(arr, 50))
                out[f"p99_{key}_s"] = float(np.percentile(arr, 99))
        return out

    def to_dict(self) -> dict:
        return {
            **super().to_dict(),
            "requests": [dataclasses.asdict(r) | {
                "wait_s": r.wait_s, "latency_s": r.latency_s}
                for r in self.requests],
            "window_records": [dataclasses.asdict(w) for w in self.windows],
            "shed_records": list(self.shed),
        }


@dataclasses.dataclass
class _Admit:
    job: J.InferenceJob
    arrival_s: float
    admit_s: float


@dataclasses.dataclass
class _Window:
    index: int
    open_s: float
    jobs: list[_Admit]
    close_s: float = 0.0


# Event ordering at equal simulated instants: an infrastructure fault
# applies first (commits at the same instant already see the post-event
# topology), then a commit frees buffer capacity (and admits deferred
# work) before a window-deadline flush fires, and both precede any new
# arrival at the same instant — so deferred requests are always
# re-admitted ahead of later traffic and FIFO order is preserved.
_FAULT, _COMMIT, _FLUSH, _ARRIVAL = -1, 0, 1, 2


class StreamingPipeline:
    """Simulated-time event loop over arrival / flush / commit events.

    Wraps an :class:`OnlineScheduler` (or builds one from a
    :class:`Topology`): the scheduler stays the single authority for the
    clock, the drain and every plan commit — the pipeline only decides
    *when* windows of requests reach it, via the
    :meth:`OnlineScheduler.submit_window` hook.
    """

    def __init__(self, net: Topology | OnlineScheduler,
                 config: StreamConfig | None = None, **sched_opts):
        self.config = config or StreamConfig()
        if isinstance(net, OnlineScheduler):
            if sched_opts:
                raise ValueError("pass scheduler options only when the "
                                 "pipeline builds the scheduler itself")
            self.sched = net
        else:
            self.sched = OnlineScheduler(net, **sched_opts)
        # The pipeline owns one fresh run: its trace replaces the
        # scheduler's so both record into the same (stream-aware) object.
        self.sched.trace = StreamTrace()
        self.trace: StreamTrace = self.sched.trace
        if self.sched.admission is not None:
            # Keep admission counters live on the fresh trace, and route
            # deferred re-admission through the pipeline's own windowing/
            # backpressure accounting instead of the scheduler's
            # self-merge.
            self.trace.admission = self.sched.admission.counters
            self.sched.admission.external_defer = True
        self._ema: float | None = None   # "measured" latency model state
        self._defer_time = -np.inf       # last instant admission deferred

    # -- solver latency model ------------------------------------------------
    def _model_latency(self) -> float:
        if self.config.solver_latency == "measured":
            # EMA of observed solve walls; until the first observation the
            # model falls back to the warmup seed (:meth:`seed_latency` —
            # the scheduler's post-warmup solve wall), or 0.0 on unwarmed
            # runs.
            return self._ema if self._ema is not None else 0.0
        return float(self.config.solver_latency)

    def seed_latency(self, wall_s: float) -> None:
        """Seed the ``"measured"`` EMA before any traffic (cold-start fix):
        without this the first window's solve is modeled at 0 s, so its
        commit — and every latency in it — ignores real solver delay.
        ``run_stream(warmup=True)`` passes the warmup's warm solve wall
        here.  A no-op once an observation exists."""
        if self._ema is None and float(wall_s) > 0.0:
            self._ema = float(wall_s)

    def _observe_solve(self, wall_s: float) -> None:
        if self._ema is None:
            self._ema = wall_s
        else:
            self._ema = 0.5 * self._ema + 0.5 * wall_s

    # -- the event loop ------------------------------------------------------
    def run(self, stream: Iterable[tuple[float, Sequence[J.InferenceJob]]],
            *, horizon: float | None = None,
            pad_to: int | None = None,
            fault_schedule=None, recovery: str = "requeue",
            max_retries: int = 3) -> StreamTrace:
        """Drive ``(t, jobs)`` epochs (nondecreasing ``t``) to completion.

        ``horizon`` clamps the last partial window's flush (a window opened
        near the end of the stream flushes at ``min(open + window_s,
        horizon)`` rather than waiting out the full δ).  Every admitted
        request is committed before returning; shed requests are recorded
        in ``trace.shed`` with a ``reason``.

        ``fault_schedule`` (any iterable of
        :class:`~repro_torch.serving.faults.FaultEvent`) pushes infrastructure
        events into the same event heap; they apply *before* any commit at
        the same instant and strand/recover work per ``recovery`` (see
        :class:`~repro_torch.serving.faults.FaultInjector`) — requires
        ``drain="exact"``.
        """
        self._pad_to = pad_to
        self._horizon = horizon
        self._events: list[tuple] = []          # (time, kind, seq, payload)
        self._seq = itertools.count()
        self._stream = iter(stream)
        self._window: list[_Admit] = []
        self._window_open = 0.0
        self._wid = 0                           # current open window's id
        self._windows_made = 0
        self._solver_q: collections.deque[_Window] = collections.deque()
        self._busy = False
        self._spill: collections.deque[tuple[float, J.InferenceJob]] = (
            collections.deque())
        self._pending = 0
        self._last_t = -np.inf
        self._injector = None
        if fault_schedule is not None:
            from .faults import FaultInjector
            self._injector = FaultInjector(self.sched, policy=recovery,
                                           max_retries=max_retries,
                                           pad_to=pad_to)
            for ev in fault_schedule:
                if horizon is None or ev.time <= horizon:
                    self._push(ev.time, _FAULT, ev)

        self._pull_arrival()
        while self._events:
            self._step()
        # Drain-out: requests the admission layer still holds deferred when
        # the stream ends get one final assessment in ``final`` mode —
        # admitted ones commit, predicted misses are shed (deadline_miss,
        # charged from their original arrival), never re-deferred, so the
        # sweep terminates.
        ctl = self.sched.admission
        while ctl is not None and ctl.deferred:
            ctl.final = True
            try:
                t = self.sched.now
                for job, a0 in ctl.pop_deferred():
                    self._admit(job, arrival_s=a0, admit_s=t)
                if self._window:
                    self._close_window(t)
                while self._events:
                    self._step()
            finally:
                ctl.final = False
        assert self._pending == 0 and not self._spill and not self._window
        return self.trace

    def _step(self) -> None:
        t, kind, _, payload = heapq.heappop(self._events)
        if kind == _ARRIVAL:
            for job in payload:
                self._ingest(t, job)
            self._pull_arrival()
        elif kind == _FLUSH:
            if payload == self._wid and self._window:
                self._close_window(t)
        elif kind == _FAULT:
            self._injector.apply(payload)
            # Fault events are exactly when the committed plan can go
            # stale: give the auto-replan monitor (if armed) a look.
            self.sched.check_replan()
        else:  # _COMMIT
            self._commit(t, *payload)

    def _push(self, t: float, kind: int, payload) -> None:
        heapq.heappush(self._events, (t, kind, next(self._seq), payload))

    def _pull_arrival(self) -> None:
        epoch = next(self._stream, None)
        if epoch is None:
            return
        t, jobs = float(epoch[0]), list(epoch[1])
        if t < self._last_t:
            raise ValueError(
                f"arrival stream went backwards: {t} < {self._last_t}")
        self._last_t = t
        self._push(t, _ARRIVAL, jobs)

    # -- ingestion + backpressure -------------------------------------------
    def _ingest(self, t: float, job: J.InferenceJob) -> None:
        cfg = self.config
        if cfg.max_pending is not None and self._pending >= cfg.max_pending:
            if cfg.policy == "shed":
                self.trace.shed.append({"time": t, "name": job.name,
                                        "reason": "backpressure"})
            else:
                self._spill.append((t, job))
                self.trace.deferred += 1
            return
        self._admit(job, arrival_s=t, admit_s=t)

    def _admit(self, job: J.InferenceJob, *, arrival_s: float,
               admit_s: float) -> None:
        cfg = self.config
        if not self._window:
            self._window_open = admit_s
            self._wid += 1
            flush_at = admit_s + cfg.window_s
            if self._horizon is not None:
                flush_at = max(admit_s, min(flush_at, self._horizon))
            self._push(flush_at, _FLUSH, self._wid)
        self._window.append(_Admit(job, arrival_s, admit_s))
        self._pending += 1
        if len(self._window) >= cfg.max_batch:
            self._close_window(admit_s)

    # -- batching window -> solver stage ------------------------------------
    def _close_window(self, t: float) -> None:
        w = _Window(self._windows_made, self._window_open,
                    list(self._window), close_s=t)
        self._windows_made += 1
        self._window.clear()
        self._wid += 1                      # invalidate the pending flush
        self._solver_q.append(w)
        self._maybe_start(t)

    def _maybe_start(self, t: float) -> None:
        if self._busy or not self._solver_q:
            return
        # Batched mode drains up to fuse_windows queued windows per solver
        # start — one cross-arrival fused dispatch clears all of them, so
        # a backed-up solver catches up k windows per modeled latency d
        # instead of one.  Sequential mode keeps one window per start
        # (width-1 solves have no multi-window device program).
        k = (self.config.fuse_windows
             if self.config.solve_mode == "batched" else 1)
        ctl = self.sched.admission
        if ctl is not None and ctl.gating:
            # Admission gates windows one at a time (submit_windows would
            # commit candidates before they can be assessed).
            k = 1
        ws = [self._solver_q.popleft()]
        while len(ws) < k and self._solver_q:
            ws.append(self._solver_q.popleft())
        d = self._model_latency()
        self._busy = True
        self._push(t + d, _COMMIT, (ws, d))

    # -- solver commit stage -------------------------------------------------
    def _commit(self, t: float, ws: list[_Window], d: float) -> None:
        if self._injector is not None and self.sched.degraded:
            # Commit-time routability: the topology may have degraded since
            # these requests were admitted; a request whose endpoints are
            # dead or partitioned now has no serveable plan.
            for w in ws:
                live = [a for a in w.jobs
                        if self._injector.routable(int(a.job.src),
                                                   int(a.job.dst))]
                for a in w.jobs:
                    if a not in live:
                        self.trace.shed.append(
                            {"time": t, "name": a.job.name,
                             "reason": "unroutable"})
                        self._pending -= 1
                w.jobs = live
        nonempty = [w for w in ws if w.jobs]
        walls: dict[int, float] = {}
        ctl = self.sched.admission
        pre_defer = len(ctl.deferred) if ctl is not None else 0
        if nonempty:
            jobs_w = [[a.job for a in w.jobs] for w in nonempty]
            arrs_w = [[a.arrival_s for a in w.jobs] for w in nonempty]
            if len(nonempty) == 1:
                one = self._solve_window(t, jobs_w[0], arrs_w[0])
                per = None if one is None else [one]
            else:
                per = self._solve_windows(t, jobs_w, arrs_w)
            wall = self.sched.last_solve_s
            if per is None:           # solver died twice: shed the group
                for w in nonempty:
                    for a in w.jobs:
                        self.trace.shed.append(
                            {"time": t, "name": a.job.name,
                             "reason": "solver_error"})
                        self._pending -= 1
                    w.jobs = []
                    walls[id(w)] = wall / len(nonempty)
            else:
                self._observe_solve(wall)
                for w, placements in zip(nonempty, per):
                    walls[id(w)] = (
                        float(placements[0].plan.meta.get(
                            "solve_share_s", wall / len(nonempty)))
                        if placements else wall / len(nonempty))
                    bound = {p.job_name: p.bound_s for p in placements}
                    for a in w.jobs:
                        # A window job missing from the placements was shed
                        # or deferred by the admission assessment inside
                        # submit_window — the scheduler already recorded it.
                        if a.job.name in bound:
                            self.trace.requests.append(RequestRecord(
                                name=a.job.name, window=w.index,
                                arrival_s=a.arrival_s, admit_s=a.admit_s,
                                close_s=w.close_s, commit_s=t,
                                solve_s=d, service_s=bound[a.job.name]))
                    self._pending -= len(w.jobs)
        if ctl is not None and len(ctl.deferred) > pre_defer:
            # Deferred at this instant: re-admitting before time advances
            # would re-run the identical assessment and loop — _release
            # holds them until a strictly later commit (or the end-of-run
            # drain-out sweep).
            self._defer_time = t
        for w in ws:
            self._finish_window(t, w, d, wall=walls.get(id(w), 0.0))
        self._release(t)

    def _solve_window(self, t: float, jobs, arrivals):
        """One window's solve with the robustness contract: a solver
        exception must not kill the pipeline.  A clean failure (nothing
        committed) is retried once; a *partial* failure (sequential mode
        committed a prefix before the raise) is rolled back through the
        ledger's withdrawal machinery — the raise happened at the commit
        instant, so zero served work is discarded — and not retried
        (committed names are unique for the ledger's lifetime, so the same
        requests cannot be resubmitted).  Returns ``None`` when the window
        commits nothing; the caller sheds it with ``reason:
        "solver_error"``."""
        sched = self.sched
        for attempt in (0, 1):
            pre = (sched.ledger.names_seen if sched.ledger is not None
                   else frozenset())
            try:
                return sched.submit_window(
                    t, jobs, arrivals=arrivals, pad_to=self._pad_to,
                    solve_mode=self.config.solve_mode)
            except Exception:  # noqa: BLE001 — serving must survive
                landed = (sorted(sched.ledger.names_seen - pre)
                          if sched.ledger is not None else [])
                if landed:
                    sched.ledger = sched.ledger.remove_jobs(landed, at=t)
                    if sched.commit_log is not None:
                        sched.commit_log = sched.commit_log.record_removal(
                            t, landed)
                    sched._sync_ledger_queues()
                    sched._last = None
                    return None
        return None

    def _solve_windows(self, t: float, jobs_w, arrs_w):
        """Cross-arrival fused solve of several windows, with the same
        robustness contract as :meth:`_solve_window`: a clean failure is
        retried once, a partial failure (some windows committed before the
        raise) is rolled back through the ledger and not retried.  Returns
        per-window placement lists, or ``None`` when nothing commits."""
        sched = self.sched
        for attempt in (0, 1):
            pre = (sched.ledger.names_seen if sched.ledger is not None
                   else frozenset())
            try:
                return sched.submit_windows(t, jobs_w, arrivals=arrs_w,
                                            pad_to=self._pad_to)
            except Exception:  # noqa: BLE001 — serving must survive
                landed = (sorted(sched.ledger.names_seen - pre)
                          if sched.ledger is not None else [])
                if landed:
                    sched.ledger = sched.ledger.remove_jobs(landed, at=t)
                    if sched.commit_log is not None:
                        sched.commit_log = sched.commit_log.record_removal(
                            t, landed)
                    sched._sync_ledger_queues()
                    sched._last = None
                    return None
        return None

    def _finish_window(self, t: float, w: _Window, d: float,
                       *, wall: float) -> None:
        self.trace.windows.append(WindowRecord(
            index=w.index, open_s=w.open_s, close_s=w.close_s, commit_s=t,
            size=len(w.jobs), solve_model_s=d, solve_wall_s=wall))

    def _release(self, t: float) -> None:
        """Free the solver server after a commit group lands."""
        self._busy = False
        # Commits free buffer capacity: re-admit deferred arrivals FIFO —
        # before any later traffic — so backpressure never reorders them.
        cfg = self.config
        while self._spill and (cfg.max_pending is None
                               or self._pending < cfg.max_pending):
            arr_t, job = self._spill.popleft()
            self._admit(job, arrival_s=arr_t, admit_s=t)
        # Admission-deferred requests re-enter through the same ingestion
        # path (original arrival preserved — a later expiry is charged from
        # it), but only once the clock has moved past the commit that
        # deferred them: the very same assessment would just bounce them
        # again.
        ctl = self.sched.admission
        if ctl is not None and ctl.deferred and t > self._defer_time:
            for job, a0 in ctl.pop_deferred():
                if (cfg.max_pending is not None
                        and self._pending >= cfg.max_pending):
                    self._spill.append((a0, job))
                    self.trace.deferred += 1
                else:
                    self._admit(job, arrival_s=a0, admit_s=t)
        self._maybe_start(t)


def run_stream(scenario, *, horizon: float, seed: int = 0,
               process: str = "poisson", rate: float | None = None,
               batch_size: int = 1, window_s: float = 0.0,
               max_batch: int = 1, solve_mode: str = "batched",
               solver_latency: float | str = 0.0,
               max_pending: int | None = None, policy: str = "defer",
               fuse_windows: int = 1, warmup: bool = False,
               method: str = "greedy", drain_queues: bool = True,
               finish: bool = False, pad_to: int | None = None,
               process_params: dict | None = None,
               fault_schedule=None, recovery: str = "requeue",
               max_retries: int = 3,
               deadline_s: float | None = None,
               admission=None, auto_replan=None,
               **solver_opts) -> StreamTrace:
    """Drive a scenario through the streaming pipeline; return the trace.

    The streaming counterpart of :func:`repro_torch.serving.online.run_online`,
    sharing its scenario protocol, arrival processes and the ``rate``
    shorthand (:func:`repro_torch.core.arrivals.resolve_rate`) — identical
    arguments produce the *identical* arrival stream and job sequence, so
    with ``window_s=0, max_batch=1, solver_latency=0`` the returned trace
    is bit-identical to the serial loop's.  ``window_s``/``max_batch``/
    ``solver_latency``/``max_pending``/``policy`` populate the
    :class:`StreamConfig`; everything else reaches the underlying
    :class:`OnlineScheduler` unchanged (``drain="fluid" | "exact"``,
    ``track_commits=``, ...).  ``finish=True`` runs the same end-of-run
    accounting as the serial loop (exact ledger served to completion,
    commit log replayed).  ``fault_schedule``/``recovery``/``max_retries``
    inject infrastructure events into the pipeline's event heap (see
    :meth:`StreamingPipeline.run`) — requires ``drain="exact"``.

    ``fuse_windows`` reaches the :class:`StreamConfig` (cross-arrival
    solves of queued windows); ``warmup=True`` runs throwaway solves at
    this run's serving shapes
    (:meth:`~repro_torch.serving.scheduler.RoutedScheduler.warmup`) before
    any traffic, and its post-warmup solve wall *seeds* the
    ``"measured"`` EMA, so even the very first window's commit models
    real solver delay instead of the cold-start 0.  Warmup samples
    throwaway jobs from the scenario, which advances its shared job-name
    counter — a warmed run's job *names* differ from an unwarmed one's
    (values are unaffected).

    ``deadline_s`` attaches a uniform relative SLO to every streamed job
    (a job's own finite ``deadline_s`` wins); ``admission`` /
    ``auto_replan`` reach the underlying :class:`OnlineScheduler` exactly
    as in :func:`~repro_torch.serving.online.run_online` — deferred arrivals
    re-enter through the pipeline's own ingestion path (original arrival
    preserved) and get a final drain-out assessment when the stream ends.
    """
    rng = np.random.default_rng(seed)
    params = A.resolve_rate(process, rate, process_params)
    times = A.stream_times(process, rng, horizon, **params)
    cfg = StreamConfig(window_s=window_s, max_batch=max_batch,
                       solve_mode=solve_mode,
                       solver_latency=solver_latency,
                       max_pending=max_pending, policy=policy,
                       fuse_windows=fuse_windows)
    sched = OnlineScheduler(scenario.topology, method=method,
                            drain_queues=drain_queues, admission=admission,
                            auto_replan=auto_replan, **solver_opts)
    pipe = StreamingPipeline(sched, cfg)
    if pad_to is None:
        pad_to = getattr(scenario, "max_layers", None)
    if warmup:
        wrng = np.random.default_rng(seed)
        counts = (fuse_windows,) if fuse_windows > 1 else ()
        winfo = sched.warmup(scenario.sample_jobs(wrng, max(max_batch, 1)),
                             pad_to=pad_to, window_counts=counts)
        pipe.seed_latency(float(winfo.get("warm_solve_s", 0.0)))
    if hasattr(scenario, "job_stream"):
        stream = scenario.job_stream(rng, times, batch_size)
    else:
        stream = ((float(t), scenario.sample_jobs(rng, batch_size))
                  for t in times)
    if deadline_s is not None:
        def _with_slo(src, d=float(deadline_s)):
            for t, jobs in src:
                yield t, [j if np.isfinite(j.deadline_s)
                          else j.with_deadline(d) for j in jobs]
        stream = _with_slo(stream)
    pipe.run(stream, horizon=horizon, pad_to=pad_to,
             fault_schedule=fault_schedule, recovery=recovery,
             max_retries=max_retries)
    if finish:
        if sched.ledger is not None:
            sched.finish()
        if sched.commit_log is not None:
            sched.replay_ground_truth()
    pipe.trace.commit_log = sched.commit_log
    return pipe.trace
