"""The port's streaming pipeline (``repro_torch.serving.stream``) and its
cross-window solve (``solvers.solve_fused``) against the JAX package's, on
the CPU.

``solve_fused`` equals sequential ``solve`` calls that thread the queues
by hand, bit for bit (fluid and ledger-drained states, ragged window
sizes, with and without paths), and equals the reference's fused solve.
The pipeline at δ = 0, B = 1 equals the serial loop bit for bit, and a
batched run through ``schedule_windows`` equals the reference's trace
(wall-time fields taken out).  The rest mirrors ``tests/test_stream.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import jobs as JJ, solvers as JS  # noqa: E402
from repro.serving import online as JO, stream as JST  # noqa: E402
from repro_torch.core import completions as C, jobs as J, solvers  # noqa: E402
from repro_torch.scenarios import make_scenario  # noqa: E402
from repro_torch.serving.online import OnlineScheduler, run_online  # noqa: E402
from repro_torch.serving.stream import (StreamConfig, StreamingPipeline,  # noqa: E402
                                        StreamTrace, run_stream)
from test_torch_online import (assert_same_trace, record_rows,  # noqa: E402
                               scenario_pair, trace_json)


@pytest.fixture(scope="module")
def star():
    return make_scenario("star", seed=0, device="cpu")


def _jobs(sc, n, seed=0):
    return sc.sample_jobs(np.random.default_rng(seed), n)


def _pipe(sc, **cfg):
    return StreamingPipeline(sc.topology, StreamConfig(**cfg))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_plans(got, want):
    """Port plans against port or reference plans, bit for bit."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.assign, _host(b.assign))
        np.testing.assert_array_equal(a.priority, _host(b.priority))
        assert a.bounds.tolist() == _host(b.bounds).tolist()
        assert a.paths == b.paths
        for name in ("q_node", "q_link"):
            np.testing.assert_array_equal(_host(getattr(a.net, name)),
                                          _host(getattr(b.net, name)))


# -- the cross-window solve ------------------------------------------------------

@pytest.mark.parametrize("family", ["paper-small", "star", "edge-cloud"])
@pytest.mark.parametrize("extract_paths", [False, True])
def test_solve_fused_equals_sequential_solves(family, extract_paths):
    """Ragged windows of 3, 1 and 4 jobs: each plan equals a sequential
    greedy solve against the previous window's committed queues, at the
    fresh state and at a ledger-drained queued one, and equals the
    reference's fused solve."""
    jsc, sc = scenario_pair(family, seed=0)
    sizes = (3, 1, 4)
    tjobs = sc.sample_jobs(np.random.default_rng(5), sum(sizes))
    jjobs = jsc.sample_jobs(np.random.default_rng(5), sum(sizes))
    cuts = np.cumsum((0,) + sizes)
    L = sc.max_layers

    def windows(jobs, mod, **kw):
        return [mod.batch_jobs(jobs[a:b], pad_to=L, **kw)
                for a, b in zip(cuts[:-1], cuts[1:])]

    tb = windows(tjobs, J, device="cpu")
    led = C.CommittedWork.empty(sc.num_nodes)
    warm = solvers.solve(sc.topology, J.batch_jobs(tjobs[:3], pad_to=L,
                                                   device="cpu"),
                         extract_paths=True)
    led = C.drain_exact(sc.topology, led.commit(
        J.batch_jobs(tjobs[:3], pad_to=L, device="cpu"), warm,
        names=["w0", "w1", "w2"]), 0.5 * warm.makespan_bound)
    for state in (sc.topology.empty_state(),
                  led.queue_state(device="cpu")):
        plans = solvers.solve_fused(sc.topology, tb, state=state, pad_to=L,
                                    extract_paths=extract_paths)
        seq, net = [], sc.topology.view(state)
        for b in tb:
            seq.append(solvers.solve(net, b, extract_paths=extract_paths))
            net = seq[-1].net
        _same_plans(plans, seq)
        walls = {p.meta["solve_s"] for p in plans}
        assert len(walls) == 1
        assert plans[0].meta["solve_share_s"] == walls.pop() / len(tb)
        assert all(p.meta["method"] == "greedy" for p in plans)
    want = JS.solve_fused(jsc.topology, windows(jjobs, JJ), pad_to=L,
                          extract_paths=extract_paths)
    _same_plans(solvers.solve_fused(sc.topology, tb, pad_to=L,
                                    extract_paths=extract_paths), want)


def test_solve_fused_validation_and_degenerate_cases(star):
    jobs = _jobs(star, 3)
    L = star.max_layers
    assert solvers.solve_fused(star.topology, []) == []
    one = solvers.solve_fused(star.topology,
                              [J.batch_jobs(jobs, pad_to=L, device="cpu")])
    direct = solvers.solve(star.topology, J.batch_jobs(jobs, pad_to=L,
                                                       device="cpu"))
    _same_plans(one, [direct])
    ragged = [J.batch_jobs(jobs[:1], pad_to=L, device="cpu"),
              J.batch_jobs(jobs[1:], pad_to=L + 1, device="cpu")]
    with pytest.raises(ValueError, match="share a padded layer width"):
        solvers.solve_fused(star.topology, ragged)
    with pytest.raises(ValueError, match="pad_to="):
        solvers.solve_fused(star.topology, ragged[:1], pad_to=L + 3)
    with pytest.raises(ValueError, match="state= is only meaningful"):
        solvers.solve_fused(star.topology.view(), ragged[:1],
                            state=star.topology.empty_state())


@pytest.mark.parametrize("drain", ["fluid", "exact"])
def test_schedule_windows_equals_sequential_and_reference(drain):
    """``schedule_windows`` commits the same plans, queues and ledger as W
    ``schedule_jobs`` calls, and equals the reference's."""
    jsc, sc = scenario_pair("edge-cloud", seed=0)
    L = sc.max_layers
    kw = dict(drain=drain, track_commits=True)
    fused = OnlineScheduler(sc.topology, **kw)
    seq = OnlineScheduler(sc.topology, **kw)
    ref = JO.OnlineScheduler(jsc.topology, **kw)
    jobs = sc.sample_jobs(np.random.default_rng(2), 7)
    jjobs = jsc.sample_jobs(np.random.default_rng(2), 7)
    wins = [jobs[:2], jobs[2:3], jobs[3:]]
    jwins = [jjobs[:2], jjobs[2:3], jjobs[3:]]
    for s in (fused, seq, ref):
        s.advance_to(0.25)
    got = fused.submit_windows(0.25, wins, pad_to=L)
    want = [seq.schedule_jobs(w, pad_to=L) for w in wins]
    ref.submit_windows(0.25, jwins, pad_to=L)
    for a, b in zip(got, want):
        assert [(p.job_name, p.priority, p.bound_s) for p in a] == \
            [(p.job_name, p.priority, p.bound_s) for p in b]
    for s in (seq, ref):
        for name in ("q_node", "q_link"):
            np.testing.assert_array_equal(
                getattr(fused.state, name).numpy(),
                np.asarray(getattr(s.state, name)))
        if drain == "exact":
            assert fused.ledger.queue_arrays()[0].tolist() == \
                s.ledger.queue_arrays()[0].tolist()
    assert record_rows(fused.trace) == record_rows(ref.trace)
    assert len(fused._window_states) == 3
    assert fused.commit_log.next_prio == seq.commit_log.next_prio == 7
    if drain == "exact":
        assert fused.finish() == ref.finish()


def test_fused_stream_window_equals_reference():
    """A batched pipeline with δ > 0, B = 8 and a busy solver, so queued
    windows go through ``schedule_windows`` four at a time: the trace
    equals the reference's."""
    jsc, sc = scenario_pair("paper-small", seed=0)
    rate = jsc.nominal_rate(1.5)
    sc.nominal_rate(1.5)
    kw = dict(horizon=24 / rate, seed=4, rate=rate, window_s=0.5 / rate,
              max_batch=8, fuse_windows=4, solver_latency=4 / rate,
              drain="exact", track_commits=True, finish=True)
    want = JST.run_stream(jsc, **kw)
    got = run_stream(sc, **kw)
    assert_same_trace(want, got)
    assert max(len({r.commit_s for r in got.requests if r.commit_s == t})
               for t in {w.commit_s for w in got.windows}) == 1
    per_commit = {}
    for w in got.windows:
        per_commit[w.commit_s] = per_commit.get(w.commit_s, 0) + 1
    assert max(per_commit.values()) > 1        # some solves took several


# -- config validation ----------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError, match="window_s"):
        StreamConfig(window_s=-1.0)
    with pytest.raises(ValueError, match="max_batch"):
        StreamConfig(max_batch=0)
    with pytest.raises(ValueError, match="policy"):
        StreamConfig(policy="drop")
    with pytest.raises(ValueError, match="max_pending"):
        StreamConfig(max_pending=0)
    with pytest.raises(ValueError, match="solver_latency"):
        StreamConfig(solver_latency="estimated")
    with pytest.raises(ValueError, match="solver_latency"):
        StreamConfig(solver_latency=-0.1)
    with pytest.raises(ValueError, match="fuse_windows"):
        StreamConfig(fuse_windows=0)


# -- δ = 0, B = 1, zero latency == serial loop ----------------------------------

def test_serial_equivalence_bit_identical():
    rate = make_scenario("star", seed=0, device="cpu").nominal_rate(0.5)
    kw = dict(horizon=20 / rate, seed=1, rate=rate)
    serial = run_online(make_scenario("star", seed=0, device="cpu"), **kw)
    pipe = run_stream(make_scenario("star", seed=0, device="cpu"),
                      window_s=0.0, max_batch=1, solver_latency=0.0, **kw)
    assert len(serial.records) == len(pipe.records) >= 10
    for a, b in zip(serial.records, pipe.records):
        assert dataclasses.replace(a, solve_s=0.0) == \
            dataclasses.replace(b, solve_s=0.0)
    assert serial.events == pipe.events
    assert all(r.wait_s == 0.0 for r in pipe.requests)
    assert all(w.size == 1 for w in pipe.windows)
    assert [r.commit_s for r in pipe.requests] == \
        [r.arrival_s for r in pipe.requests]


def test_serial_equivalence_exact_drain():
    rate = make_scenario("paper-small", seed=0, device="cpu").nominal_rate(0.8)
    jsc, _ = scenario_pair("paper-small", seed=0)
    kw = dict(horizon=8 / rate, seed=2, rate=rate, drain="exact",
              finish=True)
    serial = run_online(make_scenario("paper-small", seed=0, device="cpu"),
                        **kw)
    pipe = run_stream(make_scenario("paper-small", seed=0, device="cpu"),
                      window_s=0.0, max_batch=1, solver_latency=0.0, **kw)
    for a, b in zip(serial.records, pipe.records):
        assert dataclasses.replace(a, solve_s=0.0) == \
            dataclasses.replace(b, solve_s=0.0)
    assert serial.completions == pipe.completions
    want = JST.run_stream(jsc, window_s=0.0, max_batch=1, solver_latency=0.0,
                          **kw)
    assert_same_trace(want, pipe)


# -- window semantics -----------------------------------------------------------

def test_window_closes_at_batch_cap(star):
    jobs = _jobs(star, 6)
    stream = [(0.1 * i, [j]) for i, j in enumerate(jobs)]
    tr = _pipe(star, window_s=100.0, max_batch=3).run(
        iter(stream), horizon=1000.0, pad_to=star.max_layers)
    assert [w.size for w in tr.windows] == [3, 3]
    assert [w.close_s for w in tr.windows] == [0.2, 0.5]
    assert [w.commit_s for w in tr.windows] == [0.2, 0.5]
    assert len(tr.records) == 2


def test_window_flushes_at_delta(star):
    jobs = _jobs(star, 2)
    stream = [(0.0, [jobs[0]]), (0.3, [jobs[1]])]
    tr = _pipe(star, window_s=1.0, max_batch=100).run(
        iter(stream), horizon=1000.0, pad_to=star.max_layers)
    assert [w.size for w in tr.windows] == [2]
    assert tr.windows[0].open_s == 0.0 and tr.windows[0].close_s == 1.0
    assert [r.wait_s for r in tr.requests] == [1.0, 0.7]


def test_partial_window_flushed_at_horizon_end(star):
    jobs = _jobs(star, 2)
    stream = [(0.2, [jobs[0]]), (0.4, [jobs[1]])]
    tr = _pipe(star, window_s=50.0, max_batch=100).run(
        iter(stream), horizon=1.0, pad_to=star.max_layers)
    assert [w.size for w in tr.windows] == [2]
    assert tr.windows[0].close_s == 1.0
    assert all(r.commit_s == 1.0 for r in tr.requests)


def test_empty_windows_skipped(star):
    jobs = _jobs(star, 2)
    stream = [(0.0, jobs), (1.0, [])]
    tr = _pipe(star, window_s=5.0, max_batch=2).run(
        iter(stream), horizon=100.0, pad_to=star.max_layers)
    assert [w.size for w in tr.windows] == [2]
    assert len(tr.records) == 1


def test_sequential_mode_commits_serial_plans(star):
    jobs = _jobs(star, 5)
    seq = OnlineScheduler(star.topology)
    seq.trace = StreamTrace()
    got = seq.submit_window(2.0, jobs, pad_to=star.max_layers,
                            solve_mode="sequential")
    serial = OnlineScheduler(star.topology)
    want = [p for j in jobs
            for p in serial.submit_jobs(2.0, [j], pad_to=star.max_layers)]
    assert [p.job_name for p in got] == [p.job_name for p in want]
    assert [p.bound_s for p in got] == [p.bound_s for p in want]
    assert [p.assign.tolist() for p in got] == \
        [p.assign.tolist() for p in want]
    assert len(seq.trace.records) == 1
    rec = seq.trace.records[0]
    assert rec.latencies == tuple(
        x for r in serial.trace.records for x in r.latencies)
    assert rec.solve_s > 0 and seq.last_solve_s == rec.solve_s
    with pytest.raises(ValueError, match="solve_mode"):
        seq.submit_window(3.0, jobs[:1], solve_mode="fused")
    with pytest.raises(ValueError, match="solve_mode"):
        StreamConfig(solve_mode="fused")


def test_sequential_pipeline_matches_serial_at_b1():
    rate = make_scenario("star", seed=0, device="cpu").nominal_rate(0.5)
    kw = dict(horizon=8 / rate, seed=6, rate=rate, window_s=0.0,
              max_batch=1, solver_latency=0.0)
    a = run_stream(make_scenario("star", seed=0, device="cpu"),
                   solve_mode="batched", **kw)
    b = run_stream(make_scenario("star", seed=0, device="cpu"),
                   solve_mode="sequential", **kw)
    assert len(a.records) == len(b.records) >= 4
    for ra, rb in zip(a.records, b.records):
        assert dataclasses.replace(ra, solve_s=0.0) == \
            dataclasses.replace(rb, solve_s=0.0)


def test_solver_latency_delays_commits(star):
    jobs = _jobs(star, 2)
    stream = [(0.0, [jobs[0]]), (0.1, [jobs[1]])]
    tr = _pipe(star, window_s=0.0, max_batch=1, solver_latency=0.5).run(
        iter(stream), horizon=10.0, pad_to=star.max_layers)
    assert [w.commit_s for w in tr.windows] == [0.5, 1.0]
    assert [r.wait_s for r in tr.requests] == [0.5, 0.9]
    assert [r.queue_s for r in tr.requests] == pytest.approx([0.0, 0.4])
    assert [r.time for r in tr.records] == [0.5, 1.0]


def test_latency_is_wait_plus_service():
    jsc, sc = scenario_pair("star", seed=0)
    rate = jsc.nominal_rate(0.5)
    sc.nominal_rate(0.5)
    kw = dict(horizon=12 / rate, seed=3, rate=rate, window_s=1.0 / rate,
              max_batch=4, solver_latency=0.01)
    tr = run_stream(sc, **kw)
    assert tr.requests
    assert trace_json(tr) == trace_json(JST.run_stream(jsc, **kw))
    np.testing.assert_allclose(np.sort(tr.latencies),
                               np.sort([r.latency_s for r in tr.requests]),
                               rtol=1e-12)


# -- backpressure ---------------------------------------------------------------

def test_defer_never_reorders_arrivals(star):
    jobs = _jobs(star, 10)
    stream = [(0.1 * i, [j]) for i, j in enumerate(jobs)]
    tr = _pipe(star, window_s=0.0, max_batch=1, solver_latency=0.5,
               max_pending=2, policy="defer").run(
        iter(stream), horizon=1.0, pad_to=star.max_layers)
    assert [r.name for r in tr.requests] == [j.name for j in jobs]
    assert tr.deferred == 8 and not tr.shed
    deferred = [r for r in tr.requests if r.admit_s > r.arrival_s]
    assert len(deferred) == 8
    assert all(r.wait_s >= r.admit_s - r.arrival_s for r in deferred)
    assert all(w.size <= 2 for w in tr.windows)


def test_shed_policy_accounting(star):
    jobs = _jobs(star, 10)
    stream = [(0.1 * i, [j]) for i, j in enumerate(jobs)]
    tr = _pipe(star, window_s=0.0, max_batch=1, solver_latency=0.5,
               max_pending=2, policy="shed").run(
        iter(stream), horizon=1.0, pad_to=star.max_layers)
    committed = {r.name for r in tr.requests}
    shed = {s["name"] for s in tr.shed}
    assert committed | shed == {j.name for j in jobs}
    assert committed.isdisjoint(shed)
    assert len(shed) == 7 and tr.deferred == 0
    s = tr.summary()
    assert s["shed"] == 7 and s["requests"] == 3


def test_backlog_bounded_under_subcapacity_window(star):
    rate = star.nominal_rate(0.5)
    tr = run_stream(star, horizon=60 / rate, seed=4, process="bursty",
                    rate=rate, window_s=0.2 / rate, max_batch=4)
    assert len(tr.records) >= 10
    assert tr.backlog_growth() <= 1.3, tr.summary()


# -- trace ----------------------------------------------------------------------

def test_stream_trace_serialization_roundtrips():
    jsc, sc = scenario_pair("star", seed=0)
    rate = jsc.nominal_rate(0.4)
    sc.nominal_rate(0.4)
    kw = dict(horizon=10 / rate, seed=5, rate=rate, window_s=0.5 / rate,
              max_batch=3, solver_latency=0.01, drain="exact", finish=True)
    tr = run_stream(sc, **kw)
    assert_same_trace(JST.run_stream(jsc, **kw), tr)
    blob = trace_json(tr)
    assert blob["windows"] == len(tr.windows)
    assert len(blob["requests"]) == len(tr.requests)
    assert blob["requests"][0]["latency_s"] == pytest.approx(
        tr.requests[0].latency_s)
    assert blob["completions"] == tr.completions
    assert "p99_actual_s" in blob and "p99_wait_s" in blob
    assert blob["sustained_arr_s"] == pytest.approx(tr.sustained_arr_s())


def test_pipeline_rejects_backwards_stream(star):
    jobs = _jobs(star, 2)
    with pytest.raises(ValueError, match="backwards"):
        _pipe(star, window_s=0.0, max_batch=1).run(
            iter([(1.0, [jobs[0]]), (0.5, [jobs[1]])]),
            pad_to=star.max_layers)


def test_measured_latency_uses_observed_walls(star):
    jobs = _jobs(star, 4)
    stream = [(float(i), [j]) for i, j in enumerate(jobs)]
    tr = _pipe(star, window_s=0.0, max_batch=1,
               solver_latency="measured").run(
        iter(stream), horizon=10.0, pad_to=star.max_layers)
    assert tr.windows[0].solve_model_s == 0.0
    assert all(w.solve_wall_s > 0 for w in tr.windows)
    assert all(w.solve_model_s > 0 for w in tr.windows[1:])
    assert tr.summary()["compile_solves"] == 0
