"""The port's online serving loop (``repro_torch.serving.online``) against
the JAX package's, on the CPU.

Both packages drain, solve and commit with the same rounding, so every
trajectory below equals the reference's bit for bit: backlogs, latencies,
ledgers, completions and ``to_dict()`` JSON.  Solver wall times
(``ArrivalRecord.solve_s``) are the only fields left out of a comparison.
The fluid trajectory equals ``FLUID_GOLD_*`` with ``==``.  The rest
mirrors ``tests/test_online.py``, each run on the port and, where it makes
a trajectory, held to the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as RS  # noqa: E402
from repro.core import arrivals as JA  # noqa: E402
from repro.serving import online as JO  # noqa: E402
from repro_torch.core import arrivals as A, schedule  # noqa: E402
from repro_torch.scenarios import make_scenario  # noqa: E402
from repro_torch.serving.online import (ArrivalRecord, OnlineScheduler,  # noqa: E402
                                        OnlineTrace, run_online)


# -- helpers shared by the port's serving tests --------------------------------

def scenario_pair(family, **kw):
    """Fresh (reference, port-on-CPU) scenarios: job names come from a
    per-scenario counter, so each comparison starts from untouched ones."""
    return (RS.make_scenario(family, **kw),
            make_scenario(family, device="cpu", **kw))


def trace_json(tr) -> dict:
    """``to_dict()`` through JSON, wall-time fields taken out: the port has
    no jit, so the stream's compile accounting and window walls are its
    own."""
    d = json.loads(json.dumps(tr.to_dict()))
    for k in ("compile_solves", "compile_wall_s"):
        d.pop(k, None)
    for w in d.get("window_records", ()):
        w.pop("solve_wall_s")
    return d


def record_rows(tr) -> list[tuple]:
    """Every :class:`ArrivalRecord` field but the solve wall."""
    return [(r.time, r.names, r.latencies, r.backlog_before,
             r.backlog_after) for r in tr.records]


def assert_same_trace(want, got) -> None:
    assert record_rows(got) == record_rows(want)
    assert trace_json(got) == trace_json(want)
    assert got.completions == want.completions
    assert got.replay_completions == want.replay_completions
    assert got.lost == want.lost
    assert got.arrivals_by_name == want.arrivals_by_name
    assert got.deadlines_by_name == want.deadlines_by_name


def run_both(family, load, n, *, scenario_kw=None, **kw):
    """``run_online`` on a fresh scenario in each package, at ``load`` of
    nominal for ``n`` mean inter-arrival times; returns (ref, port)."""
    jsc, tsc = scenario_pair(family, **(scenario_kw or {}))
    rate = jsc.nominal_rate(load)
    assert tsc.nominal_rate(load) == rate
    return (JO.run_online(jsc, horizon=n / rate, rate=rate, **kw),
            run_online(tsc, horizon=n / rate, rate=rate, **kw))


# -- the fluid gold and the exact path, against the reference ------------------

def test_fluid_trajectory_equals_gold():
    from benchmarks.common import (FLUID_GOLD_ARRIVALS, FLUID_GOLD_BACKLOGS,
                                   FLUID_GOLD_LATENCIES, FLUID_GOLD_LOAD,
                                   FLUID_GOLD_SCENARIO, FLUID_GOLD_SEED)
    sc = make_scenario(FLUID_GOLD_SCENARIO, seed=0, device="cpu")
    rate = sc.nominal_rate(FLUID_GOLD_LOAD)
    tr = run_online(sc, horizon=FLUID_GOLD_ARRIVALS / rate,
                    seed=FLUID_GOLD_SEED, rate=rate)
    assert tr.backlogs.tolist() == FLUID_GOLD_BACKLOGS
    assert tr.latencies.tolist() == FLUID_GOLD_LATENCIES


@pytest.mark.parametrize("family,engine", [("edge-cloud", "indexed"),
                                           ("paper-small", "ref")])
def test_exact_online_trace_equals_reference(family, engine):
    """Exact drain with a commit log, batches of two, finished: records,
    ledger completions and the piecewise replay equal the reference's."""
    want, got = run_both(family, 0.9, 10, seed=3, batch_size=2,
                         drain="exact", track_commits=True, finish=True,
                         sim_engine=engine)
    assert len(got.records) >= 5 and got.completions
    assert_same_trace(want, got)
    for name, t in got.completions.items():
        assert abs(got.replay_completions[name] - t) <= 1e-9 * abs(t)


# -- arrival processes ---------------------------------------------------------

def test_poisson_times_rate_and_sorted():
    t = A.poisson_times(np.random.default_rng(0), rate=5.0, horizon=200.0)
    assert t.tolist() == JA.poisson_times(np.random.default_rng(0), rate=5.0,
                                          horizon=200.0).tolist()
    assert (np.diff(t) >= 0).all() and (t >= 0).all() and (t < 200.0).all()
    assert 700 <= t.size <= 1300


def test_bursty_times_long_run_rate():
    t = A.bursty_times(np.random.default_rng(1), rate=8.0, horizon=100.0,
                       burst_size=4)
    assert t.tolist() == JA.bursty_times(
        np.random.default_rng(1), rate=8.0, horizon=100.0,
        burst_size=4).tolist()
    assert (np.diff(t) >= 0).all()
    assert 550 <= t.size <= 1050
    assert (np.diff(t) < 1e-3).sum() > t.size / 3


def test_diurnal_times_peak_heavier_than_base():
    kw = dict(base_rate=0.5, peak_rate=8.0, horizon=100.0, period=100.0)
    t = A.diurnal_times(np.random.default_rng(2), **kw)
    assert t.tolist() == JA.diurnal_times(np.random.default_rng(2),
                                          **kw).tolist()
    mid = ((t > 35) & (t < 65)).sum()
    edges = ((t < 15) | (t > 85)).sum()
    assert mid > 2 * max(edges, 1)


def test_make_process_registry():
    assert set(A.available()) >= {"poisson", "bursty", "diurnal"}
    fn = A.make_process("poisson", rate=2.0)
    assert fn(np.random.default_rng(0), 10.0).size > 0
    with pytest.raises(ValueError, match="unknown arrival process"):
        A.make_process("nope")


# -- drain bounded, no-drain diverges ------------------------------------------

def test_online_backlog_bounded_iff_draining():
    jsc, tsc = scenario_pair("star", seed=0)
    rate = jsc.nominal_rate(0.5)
    tsc.nominal_rate(0.5)
    kw = dict(horizon=80 / rate, seed=1, rate=rate)
    drain = run_online(tsc, drain_queues=True, **kw)
    nodrain = run_online(tsc, drain_queues=False, **kw)
    want = JO.run_online(jsc, drain_queues=False, **kw)
    # the names differ: the port's scenario served the drained run first
    assert [r[:1] + r[2:] for r in record_rows(nodrain)] == \
        [r[:1] + r[2:] for r in record_rows(want)]
    assert len(drain.records) == len(nodrain.records) >= 40
    assert drain.backlog_growth() <= 1.3, drain.summary()
    nb = nodrain.backlogs
    assert (np.diff(nb) >= -1e-6).all()
    assert nodrain.backlog_growth() >= 1.7, nodrain.summary()
    assert nodrain.percentile(99) > drain.percentile(99)


def test_online_drained_latency_matches_fresh_solve_at_low_rate():
    want, got = run_both("star", 0.01, 20, seed=3, scenario_kw={"seed": 0})
    assert got.records
    assert record_rows(got) == record_rows(want)
    empty = [r.backlog_before == 0.0 for r in got.records[1:]]
    assert np.mean(empty) >= 0.7, got.summary()


# -- events on the clock -------------------------------------------------------

def _edge_cloud_pair(**kw):
    jsc, tsc = scenario_pair("edge-cloud", traffic="synthetic", seed=0)
    return (jsc, JO.OnlineScheduler(jsc.topology, **kw),
            tsc, OnlineScheduler(tsc.topology, **kw))


def _edge_cloud_sched(**kw):
    sc = make_scenario("edge-cloud", traffic="synthetic", seed=0,
                       device="cpu")
    return sc, OnlineScheduler(sc.topology, **kw)


def _same_plan(js, ts):
    np.testing.assert_array_equal(ts.last_plan.assign, js.last_plan.assign)
    assert ts.last_plan.bounds.tolist() == \
        np.asarray(js.last_plan.bounds).tolist()
    for name in ("q_node", "q_link"):
        np.testing.assert_array_equal(getattr(ts.state, name).numpy(),
                                      np.asarray(getattr(js.state, name)))


def test_slowdown_and_replan_are_clock_events():
    jsc, js, tsc, ts = _edge_cloud_pair()
    for sc, sched in ((jsc, js), (tsc, ts)):
        rng = np.random.default_rng(0)
        sched.submit_jobs(1.0, sc.sample_jobs(rng, 2), pad_to=sc.max_layers)
    _same_plan(js, ts)
    before = ts.last_plan
    victim = int(before.assign[int(before.order[0]), 0])
    for sched in (js, ts):
        sched.report_slowdown(victim, 100.0, at=2.5)
    assert ts.now == 2.5 and ts.clock == pytest.approx(2.5)
    js.replan_last()
    replans = ts.replan_last()
    assert replans is not None
    _same_plan(js, ts)
    for p in replans:
        assert victim not in p.nodes_used
    assert [e["event"] for e in ts.trace.events] == ["slowdown", "replan"]
    assert ts.trace.events == js.trace.events
    assert ts.trace.events[0]["time"] == 2.5


def test_nodrain_clock_still_advances():
    sc, sched = _edge_cloud_sched(drain_queues=False)
    sched.submit_jobs(0.0, sc.sample_jobs(np.random.default_rng(2), 1),
                      pad_to=sc.max_layers)
    q0 = sched.state.q_node.clone()
    sched.advance_to(5.0)
    assert sched.clock == pytest.approx(5.0)
    assert torch.equal(sched.state.q_node, q0)


def test_replan_drains_elapsed_time_from_rollback():
    jsc, js, tsc, ts = _edge_cloud_pair()
    for sc, sched in ((jsc, js), (tsc, ts)):
        rng = np.random.default_rng(3)
        sched.submit_jobs(0.0, sc.sample_jobs(rng, 2), pad_to=sc.max_layers)
        sched.submit_jobs(0.0, sc.sample_jobs(rng, 2), pad_to=sc.max_layers)
    assert float(ts._last[2].q_node.sum()) > 0
    bound0 = ts.last_plan.bound()
    for sched in (js, ts):
        sched.advance_to(1e9)
        sched.replan_last()
    _same_plan(js, ts)
    assert ts.last_plan.bound() < bound0
    assert ts.clock == pytest.approx(1e9)


def test_inherited_advance_shares_the_one_clock():
    sc, sched = _edge_cloud_sched()
    sched.submit_jobs(0.0, sc.sample_jobs(np.random.default_rng(5), 1),
                      pad_to=sc.max_layers)
    sched.advance(5.0)
    assert sched.now == pytest.approx(5.0)
    q_after_advance = sched.state.q_node.clone()
    sched.advance_to(5.0)
    assert torch.equal(sched.state.q_node, q_after_advance)
    assert sched.clock == pytest.approx(5.0)


def test_time_cannot_go_backwards():
    _, sched = _edge_cloud_sched()
    sched.advance_to(5.0)
    with pytest.raises(ValueError, match="backwards"):
        sched.advance_to(4.0)


def test_slowdown_slows_draining():
    sc, fast = _edge_cloud_sched()
    _, slow = _edge_cloud_sched()
    jobs = sc.sample_jobs(np.random.default_rng(1), 2)
    for s in (fast, slow):
        s.submit_jobs(0.0, list(jobs), pad_to=sc.max_layers)
    q = fast.state.q_node.numpy().astype(np.float64)
    mu = sc.topology.mu_node.numpy().astype(np.float64)
    waits = np.where(mu > 0, q / np.maximum(mu, 1e-30), 0.0)
    hot = int(np.argmax(waits))
    slow.report_slowdown(hot, 10.0)
    dt = 0.25 * waits[hot]
    assert dt > 0
    fast.advance_to(dt)
    slow.advance_to(dt)
    assert float(slow.state.q_node[hot]) > float(fast.state.q_node[hot])


# -- regressions ---------------------------------------------------------------

def test_backlog_growth_flat_zero_run_is_one():
    tr = OnlineTrace(records=[
        ArrivalRecord(time=float(i), names=(f"r{i}",), latencies=(0.1,),
                      backlog_before=0.0, backlog_after=0.0, solve_s=0.0)
        for i in range(8)])
    assert tr.backlog_growth() == 1.0
    tr.records[-1] = dataclasses.replace(tr.records[-1], backlog_after=5.0)
    assert tr.backlog_growth() > 1e6


def test_run_online_rate_scales_diurnal():
    sc = make_scenario("star", seed=0, device="cpu")
    rate = sc.nominal_rate(0.4)
    lo = run_online(sc, horizon=10 / rate, seed=5, process="diurnal",
                    rate=rate)
    hi = run_online(sc, horizon=10 / rate, seed=5, process="diurnal",
                    rate=4 * rate)
    assert len(hi.records) > len(lo.records) >= 1
    explicit = run_online(sc, horizon=10 / rate, seed=5, process="diurnal",
                          rate=4 * rate,
                          process_params={"peak_rate": rate,
                                          "base_rate": rate / 5})
    assert len(explicit.records) == len(lo.records)


def test_run_online_rate_rejected_for_unknown_mapping():
    @A.register_process("every-second")
    def _every_second(gap: float = 1.0):
        return lambda rng, horizon: np.arange(0.0, horizon, gap)

    sc = make_scenario("star", seed=0, device="cpu")
    try:
        with pytest.raises(ValueError, match="no defined mapping"):
            run_online(sc, horizon=3.0, process="every-second", rate=2.0)
        tr = run_online(sc, horizon=3.0, process="every-second",
                        process_params={"gap": 1.0})
        assert len(tr.records) == 3
    finally:
        A._PROCESSES.pop("every-second", None)


def test_report_slowdown_rejects_nonpositive_factor():
    _, sched = _edge_cloud_sched()
    sched.advance_to(1.0)
    for bad in (0.0, -2.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="slowdown factor"):
            sched.report_slowdown(0, bad, at=5.0)
    assert sched.now == pytest.approx(1.0)
    assert sched.trace.events == []
    sched.report_slowdown(0, 2.0, at=5.0)
    assert sched.now == pytest.approx(5.0)


def test_trace_to_dict_roundtrips_json():
    want, got = run_both("random-geometric", 0.3, 10, seed=4,
                         scenario_kw={"seed": 2})
    blob = trace_json(got)
    assert blob == trace_json(want)
    assert blob["arrivals"] == len(got.records)
    assert len(blob["backlogs"]) == len(got.records)


def test_trace_to_dict_keeps_exact_drain_results():
    want, got = run_both("paper-small", 0.6, 6, seed=7,
                         scenario_kw={"seed": 0}, drain="exact",
                         track_commits=True, finish=True)
    assert got.completions and got.replay_completions
    assert_same_trace(want, got)
    blob = json.loads(json.dumps(got.to_dict()))
    assert blob["completions"] == got.completions
    assert blob["replay_completions"] == got.replay_completions
    assert len(blob["actual_latencies"]) == len(got.actual_latencies())
    assert "p99_actual_s" in blob and "p50_actual_s" in blob
    assert blob["names"] == [list(r.names) for r in got.records]


def test_advance_to_guard_is_relative_at_large_clocks():
    _, sched = _edge_cloud_sched()
    big = 1e12
    sched.advance_to(big)
    jitter = big - 0.25 * schedule.time_eps(big)
    assert jitter < big
    sched.advance_to(jitter)
    assert sched.now == big
    with pytest.raises(ValueError, match="backwards"):
        sched.advance_to(big - 10 * schedule.time_eps(big))
