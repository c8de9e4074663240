"""The port's indexed event engine (``repro_torch.core.eventsim``) against
its linear-scan loop and against the JAX package's engines.

Both packages run the same float64 numpy operations in the same order, so
the port's indexed engine equals the reference's indexed engine bit for
bit on the same task lists, and likewise for the linear-scan loops.  The
port's two engines agree with each other at rtol 1e-9, the reference's own
parity bar.  The rest mirrors the tests of ``tests/test_eventsim.py`` that
need no online scheduler.
"""
import copy

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro.core import (eventsim as JE, jobs as JJ, schedule as JSch,  # noqa: E402
                        solve as jsolve)
from repro_torch import interop  # noqa: E402
from repro_torch.core import (eventsim, jobs as J, schedule,  # noqa: E402
                              solve)
from repro_torch.scenarios import make_scenario  # noqa: E402


def _random_system(rng, *, staggered=False, V=5, max_tasks=6,
                   dead_node=None, t0=0.0, sched=schedule):
    """Random rates + task stage lists (no solver involved: pure loop test).
    ``sched`` picks whose ``TaskRun`` records to build."""
    mu_node = rng.uniform(0.5, 3.0, V)
    mu_link = rng.uniform(0.5, 3.0, (V, V))
    if dead_node is not None:
        mu_node[dead_node] = 0.0
    n = int(rng.integers(1, max_tasks + 1))
    prios = rng.permutation(n)
    tasks = []
    for i in range(n):
        stages = []
        for _ in range(int(rng.integers(1, 7))):
            if rng.random() < 0.5:
                stages.append((("node", int(rng.integers(V))),
                               float(rng.uniform(0.2, 3.0))))
            else:
                u, v = rng.choice(V, 2, replace=False)
                stages.append((("link", int(u), int(v)),
                               float(rng.uniform(0.2, 3.0))))
        arrived = t0 + (float(rng.uniform(0, 3.0)) if staggered else 0.0)
        tasks.append(sched.TaskRun(stages=stages, prio=int(prios[i]),
                                   arrived=arrived))
    return mu_node, mu_link, tasks


def _as_ref(tasks):
    """The same task records as the reference package's ``TaskRun``."""
    return [JSch.TaskRun(stages=list(t.stages), prio=t.prio, ptr=t.ptr,
                         remaining=t.remaining, arrived=t.arrived)
            for t in tasks]


def _state(tasks):
    return [(t.ptr, t.remaining, t.arrived, t.done, t.completion)
            for t in tasks]


def _residual(task):
    """Total unfinished work of a task (current-stage residual included)."""
    out = 0.0
    for k in range(task.ptr, len(task.stages)):
        w = task.stages[k][1]
        if k == task.ptr and task.remaining is not None:
            w = task.remaining
        out += w
    return out


def _assert_same_outcome(ref, idx, *, rtol=1e-9, atol=1e-9):
    for a, b in zip(ref, idx):
        assert a.done == b.done
        if a.done:
            np.testing.assert_allclose(b.completion, a.completion,
                                       rtol=rtol, atol=atol)
        else:
            np.testing.assert_allclose(_residual(b), _residual(a),
                                       rtol=1e-7, atol=1e-7)
            np.testing.assert_allclose(b.arrived, a.arrived,
                                       rtol=rtol, atol=atol)


# -- against the reference package, bit for bit -------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.booleans())
def test_engines_equal_reference_bitwise(seed, staggered):
    """Each engine of the port reproduces the same engine of the reference
    exactly: every task's completion, pointer and residual, the stop time,
    the completion log and the queue arrays."""
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=staggered)
    for ours, theirs in ((eventsim.run_event_loop_indexed,
                          JE.run_event_loop_indexed),
                         (schedule.run_event_loop_ref,
                          JSch.run_event_loop_ref)):
        a, b = copy.deepcopy(tasks), _as_ref(tasks)
        assert ours(a, mu_node, mu_link) == theirs(b, mu_node, mu_link)
        assert _state(a) == _state(b)
    eng, jeng = (eventsim.EventEngine(mu_node, mu_link),
                 JE.EventEngine(mu_node, mu_link))
    eng.add_tasks(copy.deepcopy(tasks))
    jeng.add_tasks(_as_ref(tasks))
    for t_end in (1.0, 2.5, np.inf):
        assert eng.advance(t_end) == jeng.advance(t_end)
        for x, y in zip(eng.queue_arrays(), jeng.queue_arrays()):
            np.testing.assert_array_equal(x, y)
    assert eng.completions == jeng.completions
    assert eng.events_processed == jeng.events_processed


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_engine_faults_and_rates_equal_reference_bitwise(seed):
    """Rate changes, a failed and restored resource, withdrawn tasks and a
    what-if fork fire the same float operations as the reference."""
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=True,
                                             max_tasks=8)
    engs = (eventsim.EventEngine(mu_node, mu_link),
            JE.EventEngine(mu_node, mu_link))
    engs[0].add_tasks(copy.deepcopy(tasks))
    engs[1].add_tasks(_as_ref(tasks))
    slow = mu_node * rng.uniform(0.3, 1.0, mu_node.shape)
    node = ("node", int(rng.integers(mu_node.shape[0])))
    for eng in engs:
        eng.advance(0.7)
        eng.set_rates(slow, mu_link)
        eng.advance(1.4)
        eng.sync(slow, mu_link, down=(node,))
        eng.advance(2.0)
        eng.remove_tasks([0])
        eng.sync(mu_node, mu_link, down=())
    forks = [eng.fork() for eng in engs]
    for eng in forks + list(engs):
        eng.advance(np.inf)
    for a, b in ((engs[0], engs[1]), (forks[0], forks[1])):
        assert a.completions == b.completions
        assert _state(a.tasks) == _state(b.tasks)


# -- the port's two engines (mirror of tests/test_eventsim.py) ---------------

@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.booleans())
def test_indexed_matches_ref_to_completion(seed, staggered):
    """Random priorities, shared resources, optional staggered arrivals:
    identical completion trajectories up to float accumulation order."""
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=staggered)
    ref = copy.deepcopy(tasks)
    idx = copy.deepcopy(tasks)
    t_ref = schedule.run_event_loop_ref(ref, mu_node, mu_link)
    t_idx = eventsim.run_event_loop_indexed(idx, mu_node, mu_link)
    _assert_same_outcome(ref, idx)
    np.testing.assert_allclose(t_idx, t_ref, rtol=1e-9, atol=1e-9)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_window_splits_compose_and_match_ref(seed):
    """Finite t_end windows: the persistent engine advanced window by
    window matches the linear-scan loop run over the same windows *and*
    its own one-shot run (drain composition across arbitrary cuts)."""
    rng = np.random.default_rng(seed)
    mu_node, mu_link, tasks = _random_system(rng, staggered=True)
    ref = copy.deepcopy(tasks)
    idx = copy.deepcopy(tasks)
    one = copy.deepcopy(tasks)
    cuts = np.sort(rng.uniform(0.0, 12.0, 3))
    eng = eventsim.EventEngine(mu_node, mu_link)
    eng.add_tasks(idx)
    t = 0.0
    for c in cuts:
        schedule.run_event_loop_ref(ref, mu_node, mu_link, t=t, t_end=float(c))
        eng.advance(float(c))
        _assert_same_outcome(ref, idx, rtol=1e-7, atol=1e-7)
        t = float(c)
    schedule.run_event_loop_ref(ref, mu_node, mu_link, t=t)
    eng.advance()
    eventsim.run_event_loop_indexed(one, mu_node, mu_link)
    _assert_same_outcome(ref, idx)
    _assert_same_outcome(one, idx)   # windowing is invisible


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_zero_rate_resource_error_parity(seed):
    """A job routed over a dead resource raises the same error from both
    engines (and neither silently serves at rate 0)."""
    rng = np.random.default_rng(seed)
    V = 5
    dead = int(rng.integers(V))
    mu_node, mu_link, tasks = _random_system(rng, V=V, dead_node=dead)
    victim = tasks[int(rng.integers(len(tasks)))]
    victim.stages[int(rng.integers(len(victim.stages)))] = (
        ("node", dead), 1.0)
    with pytest.raises(RuntimeError, match="dead resource"):
        schedule.run_event_loop_ref(copy.deepcopy(tasks), mu_node, mu_link)
    with pytest.raises(RuntimeError, match="dead resource"):
        eventsim.run_event_loop_indexed(copy.deepcopy(tasks), mu_node,
                                        mu_link)
    with pytest.raises(RuntimeError, match="dead resource"):
        schedule.run_event_loop(copy.deepcopy(tasks), mu_node, mu_link,
                                engine="indexed")


def test_time_eps_is_relative():
    assert schedule.time_eps(0.0) == 1e-12
    assert schedule.time_eps(1.0) == 1e-12
    t = 2.0**26
    assert t + schedule.time_eps(t) > t          # representable nudge
    assert t + 1e-18 == t                        # an absolute guard is not
    assert schedule.time_eps(-t) == schedule.time_eps(t)
    assert schedule.work_eps(5.0) == JSch.work_eps(5.0)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_large_clock_drain_matches_time_shifted_run(seed):
    """The same system released at clock 2^26 reproduces the t=0
    trajectory shifted, for both engines."""
    t0 = float(2**26)
    rng = np.random.default_rng(seed)
    mu_node, mu_link, base = _random_system(rng, staggered=True)
    shifted = copy.deepcopy(base)
    for task in shifted:
        task.arrived += t0
    schedule.run_event_loop_ref(base, mu_node, mu_link)
    for runner in (schedule.run_event_loop_ref,
                   eventsim.run_event_loop_indexed):
        eng_tasks = copy.deepcopy(shifted)
        runner(eng_tasks, mu_node, mu_link, t=t0)
        for a, b in zip(base, eng_tasks):
            assert b.done
            np.testing.assert_allclose(b.completion - t0, a.completion,
                                       rtol=1e-9, atol=1e-4)


def test_solver_extracted_paths_match_replay():
    """greedy/lazy extract_paths=True fills plan.paths with exactly the
    hops replay_solution derives, and leaves bounds untouched."""
    sc = make_scenario("edge-cloud", traffic="synthetic", seed=0,
                       device="cpu")
    rng = np.random.default_rng(9)
    batch = J.batch_jobs(sc.sample_jobs(rng, 4), pad_to=sc.max_layers,
                         device="cpu")
    net = sc.topology.view()
    for method in ("greedy", "lazy"):
        plan = solve(net, batch, method=method, extract_paths=True)
        assert plan.paths is not None and set(plan.paths) == set(range(4))
        _, paths, _ = schedule.replay_solution(net, batch, plan.assign,
                                               plan.order)
        assert plan.paths == paths
        base = solve(net, batch, method=method)
        assert base.paths is None
        np.testing.assert_array_equal(base.assign, plan.assign)
        assert base.bounds.tolist() == plan.bounds.tolist()


def test_engine_validation():
    with pytest.raises(ValueError, match="engine must be"):
        schedule.run_event_loop([], np.ones(1), np.ones((1, 1)),
                                engine="magic")
    assert schedule.run_event_loop([], np.ones(1), np.ones((1, 1)),
                                   engine="indexed") == 0.0


@pytest.mark.parametrize("seed", [2, 4, 7])
def test_simulate_engine_param_agrees(seed):
    """One-shot simulate: the default (ref) and indexed engines agree on a
    solved instance, and each equals the reference's same engine bit for
    bit."""
    from util import random_instance

    rng = np.random.default_rng(seed)
    jnet, jobs = random_instance(rng, num_jobs=3)
    jbatch = JJ.batch_jobs(jobs)
    net = interop.network_from_numpy(
        *(np.asarray(x) for x in (jnet.mu_node, jnet.mu_link, jnet.q_node,
                                  jnet.q_link, jnet.clock)), device="cpu")
    batch = J.batch_jobs([J.InferenceJob(j.name, j.src, j.dst, j.comp,
                                         j.data) for j in jobs],
                         device="cpu")
    plan = solve(net, batch, method="greedy")
    jplan = jsolve(jnet, jbatch, method="greedy")
    if plan.makespan_bound >= 1e29:
        pytest.skip("disconnected instance")
    ref = schedule.simulate(net, batch, plan)
    idx = schedule.simulate(net, batch, plan, engine="indexed")
    np.testing.assert_allclose(idx.completion, ref.completion,
                               rtol=1e-9, atol=1e-9)
    again = schedule.simulate(net, batch, plan)   # default == ref, bitwise
    assert again.completion.tolist() == ref.completion.tolist()
    for engine, got in (("ref", ref), ("indexed", idx)):
        want = JSch.simulate(jnet, jbatch, jplan, engine=engine)
        assert got.completion.tolist() == want.completion.tolist()
