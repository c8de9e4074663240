"""Predictive admission control & SLO-guarded automatic re-planning.

Counterpart of ``repro.serving.admission``, copied: plain numpy, so the
port keeps its own copy instead of importing the JAX package.

The paper's framework minimizes end-to-end latency for the jobs it is
*given*; a production serving system must also refuse or defer work it
cannot finish in time, and notice when reality diverges from the plan.
Both decisions here are driven by the same primitive: the exact-drain
ledger's what-if fork
(:func:`repro_torch.core.completions.predict_completions`), which serves
a copy of the live event heap to quiescence and reports every job's
*predicted* completion time — bit-identical to what the real drain will
realize if no further work arrives.

Two policies live here:

  * :class:`AdmissionPolicy` / :class:`AdmissionController` — deadline-aware
    admission.  Each candidate window is pure-solved (no commit), released
    into a fork of the live simulation, and scored: arrivals whose predicted
    completion misses their ``deadline_s`` (an SLO relative to arrival) are
    shed (``policy="reject"``) or parked for a later, hopefully calmer,
    window (``policy="defer"``).  Sheds are first-class trace records —
    ``admission_reject`` / ``deadline_miss`` in ``summary()["shed_by_
    reason"]`` — and a deferred-then-expired arrival is charged from its
    ORIGINAL arrival time, the same rule the fault layer applies to
    requeues.  ``policy="admit_all"`` (default) disables gating but keeps
    the counters, so an A/B against gated runs shares one code path.
  * :class:`ReplanPolicy` / :class:`ReplanMonitor` — automatic re-planning
    with hysteresis.  The monitor compares the last committed batch's
    *predicted* completions (forked, under current health) against the
    bounds it was committed with; when the worst relative divergence
    crosses ``threshold`` it triggers ``replan_last(min_improvement=...)``.
    Cooldown plus exponential backoff bound the re-plan rate, so faults and
    slowdown storms cause a bounded number of re-placements instead of
    thrash; declined re-plans (``no_improvement``) are recorded, not
    retried immediately.

Neither policy touches device code: admission scoring is one extra pure
solve plus an O(tasks) engine fork per gated window, and the monitor is a
pure observer between events.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_POLICIES = ("admit_all", "reject", "defer")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """How to gate arrivals against their SLOs.

    ``policy``: ``admit_all`` (no gating, counters only), ``reject`` (shed
    predicted misses immediately), ``defer`` (park predicted misses and
    re-assess them at later windows, until they expire).  ``margin_s``
    tightens every deadline by a safety margin: a job is admitted only if
    its predicted latency is <= ``deadline_s - margin_s``.
    """

    policy: str = "admit_all"
    margin_s: float = 0.0

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"admission policy must be one of {_POLICIES}, "
                             f"got {self.policy!r}")
        if not np.isfinite(self.margin_s) or self.margin_s < 0:
            raise ValueError(f"margin_s must be finite and >= 0, "
                             f"got {self.margin_s}")


class AdmissionController:
    """Mutable admission state: the defer queue and the audit counters.

    Held by an :class:`~repro_torch.serving.online.OnlineScheduler`; the
    scheduler's ``submit_window`` calls :meth:`pop_deferred` to merge due
    deferrals into the next window and runs the assessment itself (it owns
    the solver and the ledger).  ``counters`` is surfaced live in
    ``OnlineTrace.summary()["admission"]``.

    ``external_defer=True`` hands re-admission of deferred arrivals to an
    outer driver (the streaming pipeline, which must route them through its
    own windowing/backpressure accounting) — the scheduler then never
    self-merges.  ``final=True`` switches ``defer`` into drain-out mode: a
    predicted miss is shed (``deadline_miss``) instead of parked, so
    end-of-stream sweeps terminate.
    """

    def __init__(self, policy: AdmissionPolicy | str | None = None):
        if policy is None:
            policy = AdmissionPolicy()
        elif isinstance(policy, str):
            policy = AdmissionPolicy(policy=policy)
        self.policy = policy
        self.deferred: list[tuple] = []   # (InferenceJob, original arrival)
        self.external_defer = False
        self.final = False
        self.counters = {"assessed": 0, "admitted": 0, "rejected": 0,
                         "deferred": 0, "expired": 0}

    @property
    def gating(self) -> bool:
        return self.policy.policy != "admit_all"

    def active(self, jobs) -> bool:
        """Does this window need an assessment at all?"""
        return self.gating and any(np.isfinite(j.deadline_s) for j in jobs)

    def pop_deferred(self) -> list[tuple]:
        out, self.deferred = self.deferred, []
        return out

    def admits(self, predicted_latency: float, deadline_s: float) -> bool:
        return (not np.isfinite(deadline_s)
                or predicted_latency <= deadline_s - self.policy.margin_s)


@dataclasses.dataclass(frozen=True)
class ReplanPolicy:
    """Hysteresis for automatic re-planning.

    ``threshold``: relative divergence that triggers — the last batch's
    worst ``predicted latency / committed bound`` must exceed ``1 +
    threshold``.  ``cooldown_s`` (simulated seconds) silences the monitor
    after each trigger; every consecutive trigger multiplies the next
    cooldown by ``backoff`` (capped at ``max_cooldown_s``), and a calm
    check (divergence back under threshold) resets it — bounded re-plan
    storms, no thrash.  ``budget`` caps total triggers per run (None =
    unlimited).  ``min_improvement`` is forwarded to
    ``replan_last(min_improvement=...)``: the re-plan commits only if the
    re-solve beats the old assignment re-scored under current health by
    that relative margin.
    """

    threshold: float = 0.25
    cooldown_s: float = 1.0
    backoff: float = 2.0
    max_cooldown_s: float = 60.0
    budget: int | None = None
    min_improvement: float = 0.0

    def __post_init__(self):
        if not np.isfinite(self.threshold) or self.threshold < 0:
            raise ValueError(f"threshold must be finite and >= 0, "
                             f"got {self.threshold}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.max_cooldown_s < self.cooldown_s:
            raise ValueError("max_cooldown_s must be >= cooldown_s")
        if self.budget is not None and self.budget < 0:
            raise ValueError(f"budget must be >= 0, got {self.budget}")
        if not (0.0 <= self.min_improvement < 1.0):
            raise ValueError(f"min_improvement must be in [0, 1), "
                             f"got {self.min_improvement}")


class ReplanMonitor:
    """SLO guard: watches plan divergence, triggers bounded re-planning.

    Stateful but tiny: next-allowed trigger time, current cooldown, trigger
    count.  :meth:`check` is called by the scheduler after window commits
    and by the drivers after fault events; it reads
    ``sched.plan_divergence()`` (a forked prediction — nothing committed)
    and calls ``sched.replan_last`` only past the hysteresis gates.
    """

    def __init__(self, policy: ReplanPolicy | None = None):
        self.policy = policy if policy is not None else ReplanPolicy()
        self._quiet_until = -np.inf
        self._cool = self.policy.cooldown_s
        self.checks = 0
        self.triggers = 0
        self.replans = 0
        self.last_divergence: float | None = None

    def check(self, sched) -> bool:
        """One observation; returns True iff a re-plan was committed."""
        self.checks += 1
        now = sched.now
        if now < self._quiet_until:
            return False
        if (self.policy.budget is not None
                and self.triggers >= self.policy.budget):
            return False
        div = sched.plan_divergence()
        self.last_divergence = div
        if div is None or div <= self.policy.threshold:
            self._cool = self.policy.cooldown_s   # calm: backoff resets
            return False
        self.triggers += 1
        self._quiet_until = now + self._cool
        self._cool = min(self._cool * self.policy.backoff,
                         self.policy.max_cooldown_s)
        sched.trace.events.append({"time": now, "event": "auto_replan",
                                   "divergence": float(div),
                                   "cooldown_s": float(self._quiet_until
                                                       - now)})
        out = sched.replan_last(
            min_improvement=self.policy.min_improvement)
        if out is not None:
            self.replans += 1
        return out is not None
