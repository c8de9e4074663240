"""The port's committed-work ledger and exact drain
(``repro_torch.core.completions``) against the JAX package's, and its own
invariants.

The ledger is host float64 in both packages, so commits, drains,
``run_to_completion``, ``predict_completions``, the piecewise replay and
the exact backlog trace equal the reference's bit for bit: ``completed``
tuples, live job records and queue arrays.  The rest mirrors the tests of
``tests/test_completions.py`` and ``tests/test_predict.py`` that need no
online scheduler.
"""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro import scenarios as RS  # noqa: E402
from repro.core import (completions as JC, jobs as JJ,  # noqa: E402
                        solve as jsolve)
from repro_torch import interop  # noqa: E402
from repro_torch.core import (completions as C, jobs as J, network as N,  # noqa: E402
                              schedule, solve)
from repro_torch.core.eventsim import EventEngine  # noqa: E402
from repro_torch.core.plan import Plan  # noqa: E402
from repro_torch.scenarios import FAMILIES, make_scenario  # noqa: E402
from util import random_instance  # noqa: E402

RTOL = 1e-9


def _port_instance(rng, num_jobs):
    """A reference random instance and the same instance in the port."""
    jnet, jobs = random_instance(rng, num_jobs=num_jobs)
    net = interop.network_from_numpy(
        *(np.asarray(x) for x in (jnet.mu_node, jnet.mu_link, jnet.q_node,
                                  jnet.q_link, jnet.clock)), device="cpu")
    tjobs = [J.InferenceJob(j.name, j.src, j.dst, j.comp, j.data)
             for j in jobs]
    return jnet, jobs, net, tjobs


def _committed_ledger(rng, num_jobs=3):
    """(net, batch, plan-with-paths, ledger committed at t=0) in the port."""
    _, _, net, jobs = _port_instance(rng, num_jobs)
    batch = J.batch_jobs(jobs, device="cpu")
    plan = solve(net, batch, method="greedy")
    if plan.makespan_bound >= 1e29:
        return None  # disconnected/dead instance; skip
    plan = plan.replay(net, batch)  # fill explicit paths
    ledger = C.CommittedWork.empty(net.num_nodes).commit(
        batch, plan, names=[j.name for j in jobs])
    return net, batch, plan, ledger


def _records(ledger):
    return [(j.name, j.prio, j.release, j.stages, j.ptr, j.remaining,
             j.arrived) for j in ledger.jobs]


def _assert_ledgers_equal(got, want):
    assert got.completed == want.completed
    assert got.clock == want.clock and got.next_prio == want.next_prio
    assert _records(got) == _records(want)
    for a, b in zip(got.queue_arrays(), want.queue_arrays()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# -- against the reference package, bit for bit -------------------------------

def _ledger_run(pkg, family, engine):
    """One solve-commit-drain-commit sequence on a catalog scenario: the
    ledgers after each step, the predictions before the final drain and
    the realized completions."""
    if pkg == "ref":
        sc = RS.make_scenario(family, 0)
        Jm, Cm, solve_, kw = JJ, JC, jsolve, {}
    else:
        sc = make_scenario(family, 0, device="cpu")
        Jm, Cm, solve_, kw = J, C, solve, {"device": "cpu"}
    rng = np.random.default_rng(3)
    jobs1, jobs2 = sc.sample_jobs(rng, 4), sc.sample_jobs(rng, 4)
    b1 = Jm.batch_jobs(jobs1, pad_to=sc.max_layers, **kw)
    p1 = solve_(sc.topology, b1, method="greedy",
                state=sc.topology.empty_state(), extract_paths=True)
    t1 = 0.25 * p1.makespan_bound
    led = Cm.CommittedWork.empty(sc.num_nodes, clock=t1).commit(
        b1, p1, names=[j.name for j in jobs1], at=t1)
    steps = [led]
    led = Cm.drain_exact(sc.topology, led, 0.4 * p1.makespan_bound,
                         engine=engine)
    steps.append(led)
    b2 = Jm.batch_jobs(jobs2, pad_to=sc.max_layers, **kw)
    p2 = solve_(sc.topology, b2, method="greedy",
                state=led.queue_state(**kw), extract_paths=True)
    led = led.commit(b2, p2, names=[j.name for j in jobs2])
    steps.append(led)
    preds = Cm.predict_completions(sc.topology, led, engine=engine)
    done, final = Cm.run_to_completion(sc.topology, led, engine=engine)
    steps.append(final)
    return steps, preds, done


@pytest.mark.parametrize("engine", ["indexed", "ref"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ledger_matches_reference(family, engine):
    got_steps, got_preds, got_done = _ledger_run("port", family, engine)
    want_steps, want_preds, want_done = _ledger_run("ref", family, engine)
    for got, want in zip(got_steps, want_steps):
        _assert_ledgers_equal(got, want)
    assert got_preds == want_preds
    assert got_done == want_done
    assert len(got_done) == 8
    # the prediction made before the drain is what the drain realized
    for name, when in got_done.items():
        np.testing.assert_allclose(got_preds[name], when, rtol=RTOL)


def test_replay_piecewise_and_backlog_trace_match_reference():
    """A commit log with a slowdown, a failed and recovered link, a node
    failed and recovered, and a withdrawal: the piecewise replay, the
    exact backlog trace and the down keys equal the reference's, for both
    engines."""
    out = []
    for mk, Jm, Cm, solve_, kw in (
            (RS.make_scenario, JJ, JC, jsolve, {}),
            (make_scenario, J, C, solve, {"device": "cpu"})):
        sc = mk("us-backbone", 0, **kw)
        rng = np.random.default_rng(8)
        log = Cm.CommittedWork.empty(sc.num_nodes)
        t = 0.0
        for _ in range(3):
            jobs = sc.sample_jobs(rng, 2)
            batch = Jm.batch_jobs(jobs, pad_to=sc.max_layers, **kw)
            plan = solve_(sc.topology, batch, method="greedy",
                          state=sc.topology.empty_state(),
                          extract_paths=True)
            log = log.commit(batch, plan, names=[j.name for j in jobs], at=t)
            t += 0.3
        log = (log.record_slowdown(0.1, 2, 3.0)
               .record_health(0.2, ("link", 0, 1), float("inf"))
               .record_health(0.5, ("link", 0, 1), 1.0)
               .record_health(0.6, 9, float("inf"))
               .record_removal(0.7, [log.jobs[-1].name])
               .record_health(0.8, 9, 1.0))
        avail = np.ones(sc.num_nodes, bool)
        avail[9] = False
        res = {"down": Cm.down_keys(sc.topology, avail)}
        for engine in ("indexed", "ref"):
            done, final = Cm.replay_piecewise(sc.topology, log, engine=engine)
            res[engine] = (done, final.completed)
            res["trace-" + engine] = Cm.exact_backlog_trace(
                sc.topology, log, [0.05, 0.3, 0.31, 0.9], engine=engine)
        out.append(res)
    want, got = out
    assert got["down"] == want["down"] and ("node", 9) in got["down"]
    for key in ("indexed", "ref"):
        assert got[key] == want[key]
        assert got["trace-" + key].tolist() == want["trace-" + key].tolist()
    for name, when in got["indexed"][0].items():
        np.testing.assert_allclose(got["ref"][0][name], when, rtol=RTOL)


def test_queue_state_lands_on_the_requested_device(monkeypatch):
    led = C.CommittedWork.empty(3, clock=2.5)
    qs = led.queue_state(device="cpu")
    assert qs.q_node.dtype == torch.float32 and qs.q_link.shape == (3, 3)
    assert float(qs.clock) == 2.5 and qs.q_node.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        led.queue_state()


# -- mirror of tests/test_completions.py --------------------------------------

def test_commit_requires_paths_and_monotone_time():
    rng = np.random.default_rng(0)
    _, _, net, jobs = _port_instance(rng, 2)
    batch = J.batch_jobs(jobs, device="cpu")
    plan = solve(net, batch, method="greedy")
    led = C.CommittedWork.empty(net.num_nodes, clock=5.0)
    with pytest.raises(ValueError, match="paths"):
        led.commit(batch, plan)
    plan = plan.replay(net, batch)
    with pytest.raises(ValueError, match="behind the ledger clock"):
        led.commit(batch, plan, at=1.0)
    led2 = led.commit(batch, plan, at=5.0, names=[j.name for j in jobs])
    assert len(led2.jobs) == 2 and led2.next_prio == 2
    assert [j.prio for j in led2.jobs] == [0, 1]
    assert led2.jobs[0].name == jobs[int(plan.order[0])].name
    assert led2.clock == 5.0
    with pytest.raises(ValueError, match="duplicate job name"):
        led2.commit(batch, plan, names=[j.name for j in jobs])


def test_queue_arrays_match_fluid_commit_at_commit_instant():
    """Before any draining, the ledger's residual work equals the fluid
    committed queues (same loads on the same resources)."""
    rng = np.random.default_rng(1)
    out = _committed_ledger(rng)
    assert out is not None
    net, batch, plan, ledger = out
    qn, ql = ledger.queue_arrays()
    np.testing.assert_allclose(qn, plan.net.q_node.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ql, plan.net.q_link.numpy(), rtol=1e-5,
                               atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_run_to_completion_matches_simulate(seed):
    """Draining a freshly committed ledger to completion reproduces the
    event simulator's per-job completion times."""
    rng = np.random.default_rng(seed)
    out = _committed_ledger(rng)
    if out is None:
        return
    net, batch, plan, ledger = out
    sim = schedule.simulate(net.reset_queues(), batch, plan)
    comps, drained = C.run_to_completion(net.topology, ledger)
    assert not drained.jobs
    for j in range(batch.num_jobs):
        np.testing.assert_allclose(comps[f"job{j}"], sim.completion[j],
                                   rtol=1e-9, atol=1e-12)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_drain_exact_composes(seed):
    """drain(a) then drain(b) == drain(a+b) in residual work, progress and
    recorded completions."""
    rng = np.random.default_rng(seed)
    out = _committed_ledger(rng)
    if out is None:
        return
    net, batch, plan, ledger = out
    a, b = rng.uniform(0, 2, size=2)
    two = C.drain_exact(net.topology,
                        C.drain_exact(net.topology, ledger, a), b)
    one = C.drain_exact(net.topology, ledger, a + b)
    assert dict(two.completed).keys() == dict(one.completed).keys()
    for name, when in one.completed:
        np.testing.assert_allclose(dict(two.completed)[name], when,
                                   rtol=1e-9, atol=1e-12)
    qn2, ql2 = two.queue_arrays()
    qn1, ql1 = one.queue_arrays()
    np.testing.assert_allclose(qn2, qn1, atol=1e-5)
    np.testing.assert_allclose(ql2, ql1, atol=1e-5)
    assert two.clock == pytest.approx(one.clock)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_drain_exact_never_under_drains_vs_fluid(seed):
    """Fluid is the optimistic bound: per resource, the exact residual is
    >= the fluid residual after any dt."""
    rng = np.random.default_rng(seed)
    out = _committed_ledger(rng)
    if out is None:
        return
    net, batch, plan, ledger = out
    dt = float(rng.uniform(0, 3))
    led = C.drain_exact(net.topology, ledger, dt)
    qn_e, ql_e = led.queue_arrays()
    fluid = net.state.with_queues(plan.net.q_node,
                                  plan.net.q_link).advance(net.topology, dt)
    assert (qn_e >= fluid.q_node.numpy() - 1e-4).all()
    assert (ql_e >= fluid.q_link.numpy() - 1e-4).all()


def test_drain_exact_respects_precedence():
    """A layer's transfer bytes do not drain before its compute does."""
    net = N.make_network(3, [(0, 1, 1.0), (1, 2, 1.0)], [0.0, 1.0, 0.0],
                         device="cpu")
    job = J.InferenceJob("j", 0, 2, np.asarray([10.0], np.float32),
                         np.asarray([1.0, 4.0], np.float32))
    batch = J.batch_jobs([job], device="cpu")
    plan = Plan(assign=np.asarray([[1]]), priority=np.asarray([0]),
                bounds=np.asarray([0.0]))
    plan = plan.replay(net, batch)
    ledger = C.CommittedWork.empty(3).commit(batch, plan, names=["j"])
    led = C.drain_exact(net.topology, ledger, 2.0)
    qn, ql = led.queue_arrays()
    assert ql[1, 2] == pytest.approx(4.0)       # untouched: precedence
    assert qn[1] == pytest.approx(9.0)          # compute drained 1s worth
    fluid = net.state.with_queues(plan.net.q_node,
                                  plan.net.q_link).advance(net.topology, 2.0)
    assert float(fluid.q_link[1, 2]) == pytest.approx(2.0)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_bound_dominates_simulation_on_ledger_drained_state(seed):
    """bound >= simulated completion still holds when the queue state a new
    batch is solved against came from an exact ledger drain."""
    rng = np.random.default_rng(seed)
    out = _committed_ledger(rng, num_jobs=2)
    if out is None:
        return
    ledger_net, batch1, plan1, ledger = out
    led = C.drain_exact(ledger_net.topology, ledger, float(rng.uniform(0, 3)))
    state = led.queue_state(device=ledger_net.device)
    net = ledger_net.topology.view(state)
    _, _, _, jobs2 = _port_instance(rng, 3)
    batch2 = J.batch_jobs(jobs2, device="cpu")
    plan2 = solve(net, batch2, method="greedy")
    if plan2.makespan_bound >= 1e29:
        return
    sim = schedule.simulate(net, batch2, plan2.assign, plan2.order)
    assert sim.makespan <= plan2.makespan_bound * (1 + 1e-5)


def test_scenario_job_names_unique_across_batches():
    sc = make_scenario("star", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    names = [j.name for _ in range(50) for j in sc.sample_jobs(rng, 2)]
    assert len(set(names)) == len(names)


# -- mirror of tests/test_predict.py ------------------------------------------

def test_fork_mutation_never_perturbs_live_engine():
    """Two identical ledgers, one repeatedly forked and mutated between
    drains, realize bit-identical completions."""
    rng = np.random.default_rng(5)
    _, _, net, jobs = _port_instance(rng, 4)
    batch = J.batch_jobs(jobs, device="cpu")
    plan = solve(net, batch, method="greedy").replay(net, batch)
    names = [j.name for j in jobs]

    def fresh():
        led = C.CommittedWork.empty(net.num_nodes).commit(batch, plan,
                                                          names=names)
        return C.warm_engine(net.topology, led)

    control, probed = fresh(), fresh()
    for _ in range(4):
        C.predict_completions(net.topology, probed)
        eng = C._engine_of(probed).eng
        fk = eng.fork()
        fk.advance(fk.now + 0.7)
        fk.add_tasks([C._task_of(j) for j in probed.jobs[:1]])
        control = C.drain_exact(net.topology, control, 0.2)
        probed = C.drain_exact(net.topology, probed, 0.2)
        assert control.completed == probed.completed  # bit-identical
    done_c, _ = C.run_to_completion(net.topology, control)
    done_p, _ = C.run_to_completion(net.topology, probed)
    assert done_c == done_p


def test_fork_is_independent_copy():
    """Mutating every forked structure leaves the original untouched."""
    rng = np.random.default_rng(9)
    _, _, net, jobs = _port_instance(rng, 3)
    batch = J.batch_jobs(jobs, device="cpu")
    plan = solve(net, batch, method="greedy").replay(net, batch)
    led = C.CommittedWork.empty(net.num_nodes).commit(
        batch, plan, names=[j.name for j in jobs])
    led = C.warm_engine(net.topology, led)
    eng: EventEngine = C._engine_of(led).eng
    before = (eng.now, len(eng.completions), eng.events_processed,
              [(t.ptr, t.remaining, t.done) for t in eng.tasks])
    fk = eng.fork()
    fk.advance(np.inf)
    assert fk.live == 0 and len(fk.completions) == len(eng.tasks)
    after = (eng.now, len(eng.completions), eng.events_processed,
             [(t.ptr, t.remaining, t.done) for t in eng.tasks])
    assert before == after
    eng.advance(np.inf)
    assert eng.completions == fk.completions


def test_exact_backlog_trace_rejects_drained_ledger():
    """The trace replays an undrained commit log; a drained ledger is
    refused (the reference's test drains it through the online
    scheduler; here ``drain_exact`` does it directly)."""
    rng = np.random.default_rng(0)
    out = _committed_ledger(rng, num_jobs=1)
    assert out is not None
    net, _, _, ledger = out
    C.exact_backlog_trace(net.topology, ledger, [1.0])
    drained = C.drain_exact(net.topology, ledger, 1e-3)
    with pytest.raises(ValueError, match="undrained"):
        C.exact_backlog_trace(net.topology, drained, [1.0])
