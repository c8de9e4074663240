"""Algorithm 1: greedy multi-job routing.

Counterpart of ``repro.core.greedy``.  :func:`greedy_route` has the
semantics of the reference's fused solver.  Per priority round:

  1. one closure build for the current queues through the two-level dedupe
     plan (``shortest_path.dedupe_plan``): the [D, V, V] unique-data-size
     stack goes through the min-plus kernel and is gathered back to
     [J, Lmax+1, V, V];
  2. the forward DP for every job at once (``routing.route_batch_fwd``);
  3. the earliest-finishing unrouted job (a masked argmin; routed jobs are
     masked with true ``inf``, not the finite ``INF`` sentinel, so an
     unroutable job's clipped cost can never tie with them);
  4. one backpointer walk, for that job only;
  5. one commit of its load to the queues, which also yields its paths.

Each round is three spans (:mod:`repro_torch.tracing`): ``greedy.closures``
(1), ``greedy.dp`` (2-4, ending with the host's read of the bound) and
``greedy.commit`` (5).

The reference pads J and the dedupe counts to powers of two for its jit
cache; padding is bit-exact and PyTorch runs eagerly, so the port does not
pad.  :func:`greedy_route_ref` is the host-driven reference loop (every
job's assignment walked each round, paths extracted separately from the
commit) and :func:`_greedy_lazy` the lazy greedy.

``plan.meta`` reports the port's own counts: ``rounds``,
``kernel_launches`` (min-plus kernel launches during the solve; 0 on the
CPU, where the plain version runs) and ``n_routings`` (single-job DPs run);
``solvers.solve`` adds ``closure_builds``.  The reference's jit-dispatch
counters ``fused_dispatch_count`` / ``reset_fused_dispatch_count`` are left
out on purpose: the port counts kernel launches
(:func:`repro_torch.kernels.minplus.launch_count`) instead.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..kernels import minplus
from .network import ComputeNetwork
from .jobs import JobBatch
from .plan import Plan
from . import routing
from . import shortest_path as SP


def _meta(rounds: int, n_routings: int, launches0: int) -> dict:
    return {"rounds": rounds, "n_routings": n_routings,
            "kernel_launches": minplus.launch_count() - launches0}


def _commit_job(cur: ComputeNetwork, batch: JobBatch, host: dict, j: int,
                assign_row, closures: SP.Closures):
    return routing.commit_with_hops(
        cur, host["comp"][j], batch.data[j], host["src"][j], host["dst"][j],
        host["num_layers"][j], assign_row, closures=closures.job(j))


def greedy_route(net: ComputeNetwork, batch: JobBatch, *,
                 lazy: bool = False, extract_paths: bool = False) -> Plan:
    """Run Algorithm 1 to completion (one host sync per round, for the
    chosen job).  ``lazy=True`` delegates to the lazy greedy.
    ``extract_paths=True`` fills ``plan.paths`` from the hops each round's
    commit charged."""
    if lazy:
        return _greedy_lazy(net, batch, extract_paths=extract_paths)
    launches0 = minplus.launch_count()
    J, lmax = batch.num_jobs, batch.max_layers
    host = batch.to_numpy()
    dplan = SP.dedupe_plan(batch)
    routed = torch.zeros((J,), dtype=torch.bool, device=batch.device)
    order = np.zeros((J,), np.int32)
    assign = np.zeros((J, lmax), np.int32)
    bounds = np.zeros((J,), np.float64)
    paths: dict[int, list] | None = {} if extract_paths else None
    cur = net
    for p in range(J):
        with tracing.span("greedy.closures"):
            cl = SP.build_closures_batch(cur, batch, dplan=dplan)
        with tracing.span("greedy.dp"):
            cost, total, bps = routing.route_batch_fwd(cur, batch,
                                                       closures=cl)
            j = int(torch.argmin(torch.where(routed, torch.inf, cost)))
            a = routing.assign_from_backpointers(total[j], bps[j])
            bounds[j] = float(cost[j])
        with tracing.span("greedy.commit"):
            cur, hops = _commit_job(cur, batch, host, j, a, cl)
            if paths is not None:
                paths[j] = routing.hops_to_paths(hops, host["num_layers"][j])
            routed[j] = True
        order[p] = j
        assign[j] = a
    return Plan.from_order(assign, order, bounds, solver="greedy",
                           meta=_meta(J, J * J, launches0), net=cur,
                           paths=paths)


def greedy_route_windows(net: ComputeNetwork, batches: list[JobBatch], *,
                         extract_paths: bool = False) -> list[Plan]:
    """Cross-arrival batching: W windows, W chained plans.

    Window w+1 is solved against ``plans[w].net``, window w's committed
    queues: exactly the state W sequential :func:`greedy_route` calls
    thread through, so each plan equals its sequential counterpart bit for
    bit (each plan's ``net`` carries that window's post-commit queues).
    The reference fuses the chain into one padded device program; the port
    runs eagerly, so it solves window by window and pads nothing.  All
    windows must share the layer width (``batch_jobs(pad_to=)``).
    """
    lmax = {b.max_layers for b in batches}
    if len(lmax) > 1:
        raise ValueError(
            f"windows must share a padded layer width (batch_jobs(pad_to=)); "
            f"got {sorted(lmax)}")
    plans, cur = [], net
    for batch in batches:
        plans.append(greedy_route(cur, batch, extract_paths=extract_paths))
        cur = plans[-1].net
    return plans


def greedy_route_ref(net: ComputeNetwork, batch: JobBatch, *,
                     extract_paths: bool = False) -> Plan:
    """Host-driven Algorithm 1 round loop (the parity reference).

    Each round builds the batched closure stack once, routes every job
    (forward DP and backpointer walk for all J), commits the masked argmin
    and, with ``extract_paths=True``, extracts that job's paths in a pass
    of its own against the round's closures.
    """
    launches0 = minplus.launch_count()
    J, lmax = batch.num_jobs, batch.max_layers
    host = batch.to_numpy()
    dplan = SP.dedupe_plan(batch)
    routed = np.zeros((J,), bool)
    order = np.zeros((J,), np.int32)
    assign = np.zeros((J, lmax), np.int32)
    bounds = np.zeros((J,), np.float64)
    paths: dict[int, list] | None = {} if extract_paths else None
    cur = net
    for p in range(J):
        cl = SP.build_closures_batch(cur, batch, dplan=dplan)
        r = routing.route_batch(cur, batch, closures=cl)
        costs = np.where(routed, np.inf, r.cost.cpu().numpy())
        j = int(np.argmin(costs))
        order[p] = j
        bounds[j] = float(costs[j])
        assign[j] = r.assign[j]
        if paths is not None:
            paths[j] = routing.extract_paths(
                cur, host["comp"][j], batch.data[j], host["src"][j],
                host["dst"][j], host["num_layers"][j], assign[j],
                closures=cl.job(j))
        cur = routing.commit_assignment(
            cur, host["comp"][j], batch.data[j], host["src"][j],
            host["dst"][j], host["num_layers"][j], assign[j],
            closures=cl.job(j))
        routed[j] = True
    return Plan.from_order(assign, order, bounds, solver="greedy",
                           meta=_meta(J, J * J, launches0), net=cur,
                           paths=paths)


def _greedy_lazy(net: ComputeNetwork, batch: JobBatch, *,
                 extract_paths: bool = False) -> Plan:
    """Lazy greedy: queues only grow, so every job's bound is monotone
    non-decreasing across rounds and a stale cached bound is a valid lower
    bound.  Each round re-routes only the cached argmin until it proves
    itself fresh-minimal.  The cached bounds live on the host (float32,
    exactly the device values), so selecting a job costs no device sync.
    """
    launches0 = minplus.launch_count()
    J, lmax = batch.num_jobs, batch.max_layers
    host = batch.to_numpy()
    dplan = SP.dedupe_plan(batch)
    closures = SP.build_closures_batch(net, batch, dplan=dplan)
    paths: dict[int, list] | None = {} if extract_paths else None
    r0 = routing.route_batch(net, batch, closures=closures)
    cost = r0.cost.cpu().numpy().copy()             # [J] cached lower bounds
    assign_c = r0.assign.copy()
    fresh = np.ones((J,), bool)
    active = np.ones((J,), bool)

    order = np.zeros((J,), np.int32)
    assign = np.zeros((J, lmax), np.int32)
    bounds = np.zeros((J,), np.float64)
    cur = net
    n_routings = J
    for p in range(J):
        while True:
            # inf (not the finite INF sentinel) so routed jobs can never tie
            # with an unroutable active job's clipped-to-INF bound
            j = int(np.argmin(np.where(active, cost, np.inf)))
            if fresh[j]:
                break
            r = routing.route_single(
                cur, host["comp"][j], batch.data[j], host["src"][j],
                host["dst"][j], host["num_layers"][j],
                closures=closures.job(j))
            cost[j] = r.cost.cpu().numpy()
            assign_c[j] = r.assign
            fresh[j] = True
            n_routings += 1
        order[p] = j
        bounds[j] = float(cost[j])
        assign[j] = assign_c[j]
        active[j] = False
        cur, hops = _commit_job(cur, batch, host, j, assign_c[j], closures)
        if paths is not None:
            paths[j] = routing.hops_to_paths(hops, host["num_layers"][j])
        if p + 1 < J:
            closures = SP.build_closures_batch(cur, batch, dplan=dplan)
            fresh[:] = False
            fresh[j] = True  # routed jobs are never probed again
    return Plan.from_order(assign, order, bounds, solver="lazy",
                           meta=_meta(J, n_routings, launches0), net=cur,
                           paths=paths)
