"""One entry point for every routing algorithm: ``solve(net, batch, method=...)``.

Counterpart of ``repro.core.solvers``.  Every algorithm is a
:class:`Solver`: a callable ``(net, batch, **opts) -> Plan`` registered
under a short method name.  Ported methods: ``greedy`` (Algorithm 1),
``greedy_ref`` (the host-driven round loop it is held against), ``lazy``,
``sa`` (Algorithm 2), ``exact`` (every priority order routed exactly)
and ``migrate`` (the fault layer's one-node re-placement);
:func:`available` lists exactly what is registered.  :func:`solve_fused`
solves several queued arrival windows in one call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from .network import ComputeNetwork
from .state import QueueState, Topology
from .jobs import JobBatch
from .plan import Plan
from .shortest_path import closure_build_count
from .. import tracing


@runtime_checkable
class Solver(Protocol):
    """A routing algorithm: maps (network, job batch, options) to a Plan."""

    def __call__(self, net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
        ...


_REGISTRY: dict[str, Solver] = {}


def register(name: str) -> Callable[[Solver], Solver]:
    """Decorator: register a solver under ``name`` (overwrites silently so
    downstream code can shadow a built-in with a tuned variant)."""

    def deco(fn: Solver) -> Solver:
        _REGISTRY[name] = fn
        return fn

    return deco


def available() -> tuple[str, ...]:
    """Registered method names, sorted."""
    return tuple(sorted(_REGISTRY))


def get(name: str) -> Solver:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {', '.join(available())}"
        ) from None


def solve(net: ComputeNetwork | Topology, batch: JobBatch,
          method: str = "greedy", *, state: QueueState | None = None,
          **opts) -> Plan:
    """Route a job batch with the named algorithm; always returns a Plan.

    ``net`` may be a :class:`ComputeNetwork` view or an immutable
    :class:`Topology` with the queue ``state`` passed explicitly.  The
    plan's ``meta`` records the method name, the wall-clock solve time
    (``meta["solve_s"]``, ending after the solver's last host sync) and
    the number of counted closure builds (``meta["closure_builds"]``) on
    top of whatever the solver itself reports.
    """
    if isinstance(net, Topology):
        net = net.view(state)
    elif state is not None:
        raise ValueError("state= is only meaningful with a Topology first arg")
    fn = get(method)
    n0 = closure_build_count()
    with tracing.span("solvers.solve", timed=True) as timed:
        plan = fn(net, batch, **opts)
    if not isinstance(plan, Plan):
        raise TypeError(f"solver {method!r} returned {type(plan).__name__}, "
                        "expected Plan")
    meta = {"method": method, **plan.meta,
            "solve_s": timed.seconds,
            "closure_builds": closure_build_count() - n0}
    return dataclasses.replace(plan, meta=meta)


def solve_fused(net: ComputeNetwork | Topology, batches: list[JobBatch],
                *, state: QueueState | None = None, pad_to: int | None = None,
                **opts) -> list[Plan]:
    """Solve several queued arrival windows in one call.

    ``batches`` are solved in order, each against the previous window's
    committed queues (``greedy.greedy_route_windows``): bit-identical to
    sequential ``solve(method="greedy")`` calls threading the state by
    hand.  All windows must share a padded layer width; ``pad_to`` asserts
    it (callers that built their batches with ``batch_jobs(pad_to=...)``
    pass the same value).  Returns one Plan per window; each plan's ``net``
    carries that window's post-commit queue state and its ``meta`` the
    call's accounting (``solve_s`` is the whole call's wall;
    ``solve_share_s`` the per-window share).
    """
    from . import greedy
    if isinstance(net, Topology):
        net = net.view(state)
    elif state is not None:
        raise ValueError("state= is only meaningful with a Topology first arg")
    if pad_to is not None:
        bad = [b.max_layers for b in batches if b.max_layers != pad_to]
        if bad:
            raise ValueError(f"every window must be padded to pad_to="
                             f"{pad_to}; got layer widths {bad}")
    n0 = closure_build_count()
    with tracing.span("solvers.solve", timed=True) as timed:
        plans = greedy.greedy_route_windows(net, batches, **opts)
    wall = timed.seconds
    builds = closure_build_count() - n0
    return [dataclasses.replace(p, meta={
        "method": "greedy", **p.meta, "solve_s": wall,
        "solve_share_s": wall / max(len(plans), 1),
        "closure_builds": builds}) for p in plans]


# -- built-ins --------------------------------------------------------------

@register("greedy")
def _solve_greedy(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    from . import greedy
    return greedy.greedy_route(net, batch, **opts)


@register("greedy_ref")
def _solve_greedy_ref(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    from . import greedy
    return greedy.greedy_route_ref(net, batch, **opts)


@register("lazy")
def _solve_lazy(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    from . import greedy
    return greedy.greedy_route(net, batch, lazy=True, **opts)


@register("sa")
def _solve_sa(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    from . import annealing
    return annealing.anneal(net, batch, **opts)


@register("exact")
def _solve_exact(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    from . import exact
    return exact.exact_plan(net, batch, **opts)


@register("migrate")
def _solve_migrate(net: ComputeNetwork, batch: JobBatch, **opts) -> Plan:
    # Importing the fault layer re-registers the real function over this
    # stub; either path runs the same solver.
    from ..serving import faults
    return faults.migrate_solve(net, batch, **opts)
