"""The port's fault layer (``repro_torch.serving.faults``) against the JAX
package's, on the CPU.

Every fault family under every recovery policy gives the reference's trace
bit for bit (completions, losses, events), and the piecewise replay of the
commit log reproduces the incremental exact drain.  ``migrate_solve``
scores all candidate nodes of a job in one batched call and equals the
reference's ``jax.vmap`` scoring bit for bit, fresh and at a queued state.
The rest mirrors ``tests/test_faults.py``.
"""
import copy

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import jobs as JJ, solvers as JS  # noqa: E402
from repro.serving import faults as JF, online as JO  # noqa: E402
from repro_torch.core import (completions as C, eventsim, jobs as J,  # noqa: E402
                              shortest_path as SP, solvers)
from repro_torch.core.state import Topology  # noqa: E402
from repro_torch.scenarios import make_scenario  # noqa: E402
from repro_torch.serving import faults as F  # noqa: E402
from repro_torch.serving.online import OnlineScheduler, run_online  # noqa: E402
from repro_torch.serving.stream import run_stream  # noqa: E402
from test_torch_eventsim import _assert_same_outcome, _random_system  # noqa: E402
from test_torch_online import assert_same_trace, scenario_pair  # noqa: E402

FAMILIES = tuple(sorted(F.FAULT_FAMILIES))
REPLAY_EPS_S = 1e-6


def _edge_cloud():
    return make_scenario("edge-cloud", seed=0, device="cpu")


# -- every family x policy, against the reference ------------------------------

@pytest.mark.parametrize("policy", F.POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_faulted_run_equals_reference_and_replays(family, policy):
    """The faulted exact run equals the reference's trace bit for bit, and
    the piecewise commit-log replay reproduces its completions."""
    assert tuple(sorted(JF.FAULT_FAMILIES)) == FAMILIES
    jsc, sc = scenario_pair("edge-cloud", seed=0)
    rate = jsc.nominal_rate(0.9)
    assert sc.nominal_rate(0.9) == rate
    horizon = 12 / rate
    want_ev = JF.make_fault_schedule(family, jsc, horizon, seed=1)
    got_ev = F.make_fault_schedule(family, sc, horizon, seed=1)
    assert [(e.time, e.kind, e.node, e.link, e.factor) for e in got_ev] == \
        [(e.time, e.kind, e.node, e.link, e.factor) for e in want_ev]
    kw = dict(horizon=horizon, rate=rate, seed=3, drain="exact",
              track_commits=True, finish=True, recovery=policy)
    want = JO.run_online(jsc, fault_schedule=want_ev, **kw)
    got = run_online(sc, fault_schedule=got_ev, **kw)
    assert_same_trace(want, got)
    assert got.events == want.events
    cc, rr = got.completions, got.replay_completions
    assert set(cc) == set(rr)
    for name, t in cc.items():
        assert abs(rr[name] - t) <= REPLAY_EPS_S, (family, policy, name)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_replay_matches_exact_drain_through_faults(seed):
    family = FAMILIES[seed % len(FAMILIES)]
    policy = F.POLICIES[(seed // len(FAMILIES)) % len(F.POLICIES)]
    sc = _edge_cloud()
    rate = sc.nominal_rate(0.9)
    horizon = 12 / rate
    faults = F.make_fault_schedule(family, sc, horizon, seed=seed % 1000)
    tr = run_online(sc, horizon=horizon, rate=rate, seed=seed % 100,
                    drain="exact", track_commits=True, finish=True,
                    fault_schedule=faults, recovery=policy)
    cc, rr = tr.completions, tr.replay_completions
    assert set(cc) == set(rr)
    for name, t in cc.items():
        assert abs(rr[name] - t) <= REPLAY_EPS_S, (family, policy, name)


# -- the migrate solver ----------------------------------------------------------

def _queued(sc, jobs, L):
    """A ledger-drained queued state built from ``jobs``: committed at 0,
    drained for half the window's bound."""
    batch = J.batch_jobs(jobs, pad_to=L, device="cpu")
    plan = solvers.solve(sc.topology, batch, extract_paths=True)
    led = C.CommittedWork.empty(sc.num_nodes).commit(
        batch, plan, names=[f"q{i}" for i in range(len(jobs))])
    led = C.drain_exact(sc.topology, led, 0.5 * plan.makespan_bound)
    return led.queue_state(device="cpu")


@pytest.mark.parametrize("family", ["paper-small", "star", "edge-cloud",
                                    "us-backbone"])
def test_migrate_solve_equals_reference(family):
    """Bounds, assignments and committed queues equal the reference's
    vmapped scoring bit for bit, at the fresh state and at a queued one
    (the same queues handed to both); one closure build a job."""
    jsc, sc = scenario_pair(family, seed=0)
    L = sc.max_layers
    tjobs = sc.sample_jobs(np.random.default_rng(4), 7)
    jjobs = jsc.sample_jobs(np.random.default_rng(4), 7)
    queued = _queued(sc, tjobs[4:], L)
    for state in (sc.topology.empty_state(), queued):
        batch = J.batch_jobs(tjobs[:4], pad_to=L, device="cpu")
        n0 = SP.closure_build_count()
        got = solvers.solve(sc.topology, batch, method="migrate",
                            state=state)
        assert SP.closure_build_count() - n0 == 4
        jstate = jsc.topology.empty_state().with_queues(
            jnp.asarray(state.q_node.numpy()),
            jnp.asarray(state.q_link.numpy()))
        want = JS.solve(jsc.topology, JJ.batch_jobs(jjobs[:4], pad_to=L),
                        method="migrate", state=jstate)
        assert got.solver == want.solver == "migrate"
        np.testing.assert_array_equal(got.assign, np.asarray(want.assign))
        assert got.bounds.tolist() == np.asarray(want.bounds).tolist()
        for name in ("q_node", "q_link"):
            np.testing.assert_array_equal(getattr(got.net, name).numpy(),
                                          np.asarray(getattr(want.net, name)))
        assert got.meta["n_routings"] == want.meta["n_routings"]


def test_batched_scoring_equals_reference_per_assignment():
    """The [C, L] gather equals the reference's single-assignment cost of
    every row bit for bit: one-node rows and rows that move between
    nodes, at a queued state."""
    from repro.core import routing as JR
    from repro_torch.core import routing
    jsc, sc = scenario_pair("edge-cloud", seed=0)
    jobs = sc.sample_jobs(np.random.default_rng(1), 2)
    batch = J.batch_jobs(jobs, pad_to=sc.max_layers, device="cpu")
    state = _queued(sc, jobs, sc.max_layers)
    net = sc.topology.view(state)
    jnet = jsc.topology.view(jsc.topology.empty_state().with_queues(
        jnp.asarray(state.q_node.numpy()), jnp.asarray(state.q_link.numpy())))
    host = batch.to_numpy()
    cand = np.flatnonzero(sc.topology.mu_node.numpy() > 0)
    rows = np.repeat(cand[:, None], sc.max_layers, axis=1)
    mixed = rows[[0, -1]].copy()             # runs that move between nodes
    mixed[0, ::2] = cand[-1]
    for j in range(2):
        args = [host[k][j] for k in ("comp", "data", "src", "dst",
                                     "num_layers")]
        cl = SP.closures_for(net, batch.data[j])
        for assigns in (rows, mixed):
            got = routing.cost_given_assignments(net, *args, assigns,
                                                 closures=cl)
            assert got.dtype == np.float32
            assert got.tolist() == [
                float(JR.cost_given_assignment(
                    jnet, *map(jnp.asarray, args), jnp.asarray(a)))
                for a in assigns]


def test_migrate_solver_places_each_job_on_one_node():
    sc = _edge_cloud()
    jobs = sc.sample_jobs(np.random.default_rng(0), 3)
    plan = solvers.solve(sc.topology, J.batch_jobs(jobs, device="cpu"),
                         method="migrate")
    for j, job in enumerate(jobs):
        row = plan.assign[j, :job.num_layers]
        assert len(set(row.tolist())) == 1
        assert sc.topology.mu_node[row[0]] > 0
    assert plan.solver == "migrate"


def test_migrate_requires_a_compute_node():
    topo = make_scenario("star", seed=0, device="cpu").topology
    dead = Topology(mu_node=torch.zeros_like(topo.mu_node),
                    mu_link=topo.mu_link).view()
    with pytest.raises(ValueError, match="no compute-capable node"):
        F.migrate_solve(dead, J.batch_jobs(
            [J.synthetic_job("x", 0, 1, 2)], device="cpu"))


# -- engine remove/restore vs fresh rebuild -------------------------------------

@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1), st.booleans())
def test_engine_remove_restore_matches_fresh_rebuild(seed, link_victim):
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=True)
    V = mu_node.shape[0]
    if link_victim:
        u, v = rng.choice(V, 2, replace=False)
        res = ("link", int(u), int(v))
    else:
        res = ("node", int(rng.integers(V)))
    t1, t2 = np.sort(rng.uniform(0.0, 8.0, 2))

    live = copy.deepcopy(tasks)
    eng = eventsim.EventEngine(mu_node, mu_link)
    eng.add_tasks(live)
    eng.advance(float(t1))
    eng.remove_resource(res)
    eng.advance(float(t2))
    eng.restore_resource(res)
    eng.advance()

    ref = copy.deepcopy(tasks)
    eventsim.run_event_loop_indexed(ref, mu_node, mu_link, t=0.0,
                                    t_end=float(t1))
    eventsim.run_event_loop_indexed(ref, mu_node, mu_link, t=float(t1),
                                    t_end=float(t2), down=(res,))
    eventsim.run_event_loop_indexed(ref, mu_node, mu_link, t=float(t2))
    _assert_same_outcome(ref, live, rtol=1e-7, atol=1e-7)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_engine_sync_is_remove_then_restore(seed):
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=True)
    res = ("node", int(rng.integers(mu_node.shape[0])))
    t1, t2 = np.sort(rng.uniform(0.0, 8.0, 2))
    a, b = copy.deepcopy(tasks), copy.deepcopy(tasks)
    ea = eventsim.EventEngine(mu_node, mu_link)
    eb = eventsim.EventEngine(mu_node, mu_link)
    ea.add_tasks(a), eb.add_tasks(b)
    ea.advance(float(t1)), eb.advance(float(t1))
    ea.remove_resource(res)
    eb.sync(mu_node, mu_link, down=(res,))
    ea.advance(float(t2)), eb.advance(float(t2))
    ea.restore_resource(res)
    eb.sync(mu_node, mu_link, down=())
    ea.advance(), eb.advance()
    _assert_same_outcome(a, b)


# -- recovery and availability events on the scheduler --------------------------

def test_report_recovery_restores_full_health():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact", track_commits=True)
    sched.report_slowdown(8, 2.0)
    assert sched._slowdown[8] == 2.0
    sched.report_recovery(8, at=1.0)
    assert sched._slowdown[8] == 1.0
    assert sched.now == 1.0
    assert sched.commit_log.health[-1] == (1.0, 8, 1.0)
    assert sched.trace.events[-1]["event"] == "recovery"


def test_report_recovery_validates_node():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact")
    with pytest.raises(ValueError, match="out of range"):
        sched.report_recovery(sc.num_nodes)
    with pytest.raises(ValueError, match="out of range"):
        sched.report_recovery(-1)


def test_availability_setters_validate():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact")
    with pytest.raises(ValueError, match="out of range"):
        sched.set_node_availability(sc.num_nodes, False)
    u, v = map(int, np.argwhere(sc.topology.mu_link.numpy() == 0)[0])
    with pytest.raises(ValueError, match="does not exist"):
        sched.set_link_availability(u, v, False)


# -- event / schedule validation -------------------------------------------------

def test_fault_event_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        F.FaultEvent(1.0, "meteor")
    with pytest.raises(ValueError, match="needs link"):
        F.FaultEvent(1.0, "link_fail")
    with pytest.raises(ValueError, match="needs node"):
        F.FaultEvent(1.0, "node_fail")
    with pytest.raises(ValueError, match="finite and > 0"):
        F.FaultEvent(1.0, "rescale", node=0, factor=0.0)
    with pytest.raises(ValueError, match="finite and > 0"):
        F.FaultEvent(1.0, "rescale", node=0, factor=np.inf)
    with pytest.raises(ValueError, match="time must be finite"):
        F.node_fail(np.inf, 0)


def test_fault_schedule_sorts_and_validates():
    sched = F.schedule_from([F.node_recover(5.0, 1), F.node_fail(2.0, 1)])
    assert [ev.kind for ev in sched] == ["node_fail", "node_recover"]
    assert len(sched) == 2
    with pytest.raises(ValueError, match="outside"):
        F.FaultSchedule((F.node_fail(1.0, 99),)).validate(4)
    with pytest.raises(ValueError, match="outside"):
        F.FaultSchedule((F.link_fail(1.0, 0, 99),)).validate(4)


def test_capacity_rescale_lag():
    ev = F.capacity_rescale(2.0, 3, 0.5, lag=0.25)
    assert ev.time == 2.25 and ev.kind == "rescale" and ev.factor == 0.5


def test_make_fault_schedule_families():
    sc = _edge_cloud()
    with pytest.raises(ValueError, match="unknown fault family"):
        F.make_fault_schedule("volcano", sc, 10.0)
    for family in FAMILIES:
        sched = F.make_fault_schedule(family, sc, 10.0, seed=3)
        assert len(sched) >= 2
        assert all(0.0 <= ev.time <= 10.0 for ev in sched)
        times = [ev.time for ev in sched]
        assert times == sorted(times)


@pytest.mark.parametrize("family", ["edge-cloud", "us-backbone",
                                    "random-geometric"])
def test_pick_victim_prefers_interior_compute(family):
    jsc, sc = scenario_pair(family, seed=0)
    assert F.pick_victims(sc, 2) == JF.pick_victims(jsc, 2)
    assert F.pick_victim_link(sc) == JF.pick_victim_link(jsc)
    if family == "edge-cloud":
        assert F.pick_victim(sc) == 8
        assert F.pick_victim_link(sc)[0] == 8


# -- the injector: construction + policies ---------------------------------------

def _stranded_setup(policy, **kw):
    """Two jobs committed at t=0 (greedy puts work on the cloud node 8),
    then node 8 fails at t=0.1: (sched, injector, outage record), with the
    reference's run of the same sequence checked against it."""
    jsc, sc = scenario_pair("edge-cloud", seed=0)
    out = []
    for pkg_sc, Sched, mod in ((jsc, JO.OnlineScheduler, JF),
                               (sc, OnlineScheduler, F)):
        sched = Sched(pkg_sc.topology, drain="exact", track_commits=True)
        sched.submit_jobs(0.0, pkg_sc.sample_jobs(np.random.default_rng(0),
                                                  2))
        inj = mod.FaultInjector(sched, policy=policy, **kw)
        out.append((sched, inj, inj.apply(mod.node_fail(0.1, 8))))
    (js, _, jrec), (sched, inj, rec) = out
    assert rec == jrec
    assert sched.trace.lost == js.trace.lost
    assert [(j.name, j.stages, j.ptr, j.remaining) for j in
            sched.ledger.jobs] == [(j.name, j.stages, j.ptr, j.remaining)
                                   for j in js.ledger.jobs]
    assert rec["affected"], "setup: no work landed on the victim node"
    return sched, inj, rec


def test_injector_requires_exact_drain():
    sc = _edge_cloud()
    with pytest.raises(ValueError, match="drain='exact'"):
        F.FaultInjector(OnlineScheduler(sc.topology))


def test_injector_validates_args():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact")
    with pytest.raises(ValueError, match="policy"):
        F.FaultInjector(sched, policy="pray")
    with pytest.raises(ValueError, match="max_retries"):
        F.FaultInjector(sched, max_retries=-1)


def test_policy_lost_sheds_and_accounts():
    sched, _, rec = _stranded_setup("lost")
    assert rec["lost"] and not rec["requeued"]
    assert {why for _, why in rec["lost"]} == {"failed_resource"}
    assert set(rec["lost"]) == set(sched.trace.lost)
    downs = set(sched._down_keys())
    assert all(job.stages[k][0] not in downs
               for job in sched.ledger.jobs
               for k in range(job.ptr, len(job.stages)))


def test_policy_requeue_replans_with_retry_suffix():
    sched, _, rec = _stranded_setup("requeue")
    assert rec["requeued"]
    assert {why for _, why in rec["lost"]} <= {"data_lost"}
    assert all(n.endswith("#r1") for n in rec["requeued"])
    live = {j.name for j in sched.ledger.jobs}
    assert set(rec["requeued"]) <= live
    assert not any(F._parse_retry(n)[1] == 0 for n in live)
    for n in rec["requeued"]:
        base, _ = F._parse_retry(n)
        assert sched.trace.arrivals_by_name[n] == \
            sched.trace.arrivals_by_name[base]


def test_policy_requeue_avoids_dead_resources():
    sched, _, _ = _stranded_setup("requeue")
    downs = set(sched._down_keys())
    for job in sched.ledger.jobs:
        assert all(res not in downs for res, _ in job.stages)


def test_policy_migrate_places_residual_on_one_node():
    sched, _, rec = _stranded_setup("migrate")
    assert rec["requeued"]
    requeued = [j for j in sched.ledger.jobs if j.name in set(rec["requeued"])]
    assert requeued
    for job in requeued:
        nodes = {res[1] for res, _ in job.stages if res[0] == "node"}
        assert len(nodes) == 1 and 8 not in nodes


def test_retries_exhausted_bounds_the_loop():
    _, _, rec = _stranded_setup("requeue", max_retries=0)
    assert not rec["requeued"]
    assert {why for _, why in rec["lost"]} == {"retries_exhausted"}


def test_recover_event_restores_routability():
    sched, inj, _ = _stranded_setup("lost")
    assert sched.degraded
    inj.apply(F.node_recover(0.5, 8))
    assert not sched.degraded
    assert sched._slowdown[8] == 1.0


def test_rescale_event_is_absolute_slowdown():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact")
    inj = F.FaultInjector(sched)
    inj.apply(F.capacity_rescale(0.0, 8, 0.5))
    assert sched._slowdown[8] == 2.0
    inj.apply(F.capacity_rescale(1.0, 8, 1.0))
    assert sched._slowdown[8] == 1.0


# -- routability + arrival filtering ---------------------------------------------

def test_filter_arrivals_sheds_unroutable():
    sc = _edge_cloud()
    sched = OnlineScheduler(sc.topology, drain="exact")
    inj = F.FaultInjector(sched, policy="lost")
    sched.set_node_availability(0, False)
    assert not inj.routable(0, 3)
    assert not inj.routable(3, 0)
    assert inj.routable(1, 3)
    jobs = [J.synthetic_job("dead-src", 0, 3, 4, seed=1),
            J.synthetic_job("alive", 1, 3, 4, seed=2)]
    kept = inj.filter_arrivals(0.0, jobs)
    assert [j.name for j in kept] == ["alive"]
    assert ("dead-src", "arrival_unroutable") in sched.trace.lost


# -- solver exceptions must not kill the pipeline --------------------------------

def test_stream_survives_solver_exception():
    @solvers.register("test-bomb")
    def _bomb(net, batch, **opts):
        raise RuntimeError("solver exploded")

    try:
        sc = make_scenario("star", seed=0, device="cpu")
        rate = sc.nominal_rate(0.5)
        tr = run_stream(sc, horizon=8 / rate, rate=rate, seed=1,
                        drain="exact", method="test-bomb")
    finally:
        solvers._REGISTRY.pop("test-bomb", None)
    s = tr.summary()
    assert s["requests"] == 0
    assert s["shed"] > 0
    assert s["shed_by_reason"] == {"solver_error": s["shed"]}


def test_stream_retries_transient_solver_failure_once():
    calls = {"n": 0}

    @solvers.register("test-flaky")
    def _flaky(net, batch, **opts):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient")
        return solvers.get("greedy")(net, batch, **opts)

    try:
        sc = make_scenario("star", seed=0, device="cpu")
        rate = sc.nominal_rate(0.5)
        tr = run_stream(sc, horizon=8 / rate, rate=rate, seed=1,
                        drain="exact", method="test-flaky", finish=True)
    finally:
        solvers._REGISTRY.pop("test-flaky", None)
    s = tr.summary()
    assert s.get("shed", 0) == 0
    assert s["requests"] == s["arrivals"] > 0
    assert calls["n"] >= 2


# -- faults through the streaming pipeline ---------------------------------------

def test_stream_fault_schedule_matches_serial_loop():
    sc = _edge_cloud()
    rate = sc.nominal_rate(0.85)
    horizon = 10 / rate
    faults = F.make_fault_schedule("transient-node", sc, horizon, seed=5)
    kw = dict(horizon=horizon, rate=rate, seed=2, drain="exact",
              track_commits=True, finish=True,
              fault_schedule=faults, recovery="requeue")
    serial = run_online(_edge_cloud(), **kw)
    pipe = run_stream(_edge_cloud(), window_s=0.0, max_batch=1, **kw)
    assert set(pipe.completions) == set(serial.completions)
    for n, t in serial.completions.items():
        assert abs(pipe.completions[n] - t) <= REPLAY_EPS_S
    assert sorted(n for n, _ in pipe.lost) == sorted(n for n, _ in serial.lost)
