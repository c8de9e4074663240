"""The port's admission control and SLO-guarded re-planning
(``repro_torch.serving.admission`` and its use in the online loop and the
pipeline) against the JAX package's, on the CPU.

Gated runs equal the reference's traces bit for bit (sheds, deferrals,
counters, completions), and admitted predictions are exact: every admitted
request meets its SLO.  The rest mirrors ``tests/test_admission.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import online as JO, stream as JST  # noqa: E402
from repro_torch.core import jobs as J  # noqa: E402
from repro_torch.scenarios import make_scenario  # noqa: E402
from repro_torch.serving.admission import (AdmissionController,  # noqa: E402
                                           AdmissionPolicy, ReplanMonitor,
                                           ReplanPolicy)
from repro_torch.serving.faults import FaultEvent  # noqa: E402
from repro_torch.serving.online import OnlineScheduler, run_online  # noqa: E402
from repro_torch.serving.stream import (StreamConfig, StreamingPipeline,  # noqa: E402
                                        run_stream)
from test_torch_online import assert_same_trace, scenario_pair  # noqa: E402


@pytest.fixture(scope="module")
def scenario():
    return make_scenario("paper-small", seed=0, device="cpu")


def _overload_pair(load):
    """Fresh paper-small scenarios in both packages, the rate at ``load``
    and the scenario's mean service time."""
    jsc, sc = scenario_pair("paper-small", seed=0)
    rate = jsc.nominal_rate(load)
    assert sc.nominal_rate(load) == rate
    assert sc.mean_service_s == jsc.mean_service_s
    return jsc, sc, rate, sc.mean_service_s


# -- validation ---------------------------------------------------------------

def test_admission_policy_validation():
    with pytest.raises(ValueError, match="admission policy"):
        AdmissionPolicy(policy="bogus")
    with pytest.raises(ValueError, match="margin_s"):
        AdmissionPolicy(policy="reject", margin_s=-1.0)
    ctl = AdmissionController("defer")
    assert ctl.policy.policy == "defer" and ctl.gating
    assert not AdmissionController().gating


def test_replan_policy_validation():
    for bad in (dict(threshold=-0.1), dict(cooldown_s=-1.0),
                dict(backoff=0.5), dict(budget=-1),
                dict(min_improvement=1.0),
                dict(cooldown_s=10.0, max_cooldown_s=1.0)):
        with pytest.raises(ValueError):
            ReplanPolicy(**bad)


def test_job_deadline_field():
    job = J.synthetic_job("d0", 0, 1, 3)
    assert job.deadline_s == float("inf")
    tight = job.with_deadline(0.25)
    assert tight.deadline_s == 0.25 and job.deadline_s == float("inf")
    with pytest.raises(ValueError, match="deadline_s"):
        J.InferenceJob("d1", 0, 1, job.comp, job.data, deadline_s=0.0)
    with pytest.raises(ValueError, match="deadline_s"):
        job.with_deadline(float("nan"))


# -- predicted-miss gating ----------------------------------------------------

def test_reject_policy_beats_admit_all_under_overload():
    jsc, sc, rate, svc = _overload_pair(2.5)
    kw = dict(horizon=12 / rate, seed=3, rate=rate, batch_size=2,
              drain="exact", finish=True, deadline_s=1.2 * svc)
    base = run_online(sc, admission="admit_all", **kw).summary()
    gated_tr = run_online(sc, admission="reject", **kw)
    gated = gated_tr.summary()
    # the reference on a scenario whose name counter sits where the port's
    # did before the gated run
    JO.run_online(jsc, admission="admit_all", **kw)
    assert_same_trace(JO.run_online(jsc, admission="reject", **kw), gated_tr)
    assert gated["slo"]["slo_miss_rate"] < base["slo"]["slo_miss_rate"]
    assert gated["slo"]["goodput"] >= base["slo"]["goodput"]
    assert gated["shed_by_reason"].get("admission_reject", 0) > 0
    assert gated["admission"]["rejected"] == \
        gated["shed_by_reason"]["admission_reject"]
    assert gated["slo"]["late"] == 0


def test_defer_then_expire_charged_from_original_arrival(scenario):
    sched = OnlineScheduler(scenario.topology, drain="exact",
                            admission="defer")
    rng = np.random.default_rng(4)
    filler = scenario.sample_jobs(rng, 3)
    (victim,) = scenario.sample_jobs(rng, 1)
    victim = victim.with_deadline(1e-3)
    sched.submit_jobs(0.0, filler + [victim], pad_to=scenario.max_layers)
    assert [j.name for j, _ in sched.admission.deferred] == [victim.name]
    later = scenario.sample_jobs(rng, 1)
    sched.submit_jobs(0.5, later, pad_to=scenario.max_layers)
    (rec,) = [s for s in sched.trace.shed if s["name"] == victim.name]
    assert rec["reason"] == "deadline_miss"
    assert rec["arrival"] == 0.0 and rec["time"] == 0.5
    assert sched.trace.arrivals_by_name[victim.name] == 0.0
    assert sched.admission.counters["expired"] == 1


def test_flush_deferred_drains_out(scenario):
    sched = OnlineScheduler(scenario.topology, drain="exact",
                            admission="defer")
    rng = np.random.default_rng(6)
    jobs = [j.with_deadline(1e-3) for j in scenario.sample_jobs(rng, 2)]
    filler = scenario.sample_jobs(rng, 2)
    sched.submit_jobs(0.0, filler + jobs, pad_to=scenario.max_layers)
    assert len(sched.admission.deferred) == 2
    placed = sched.flush_deferred(at=0.25, pad_to=scenario.max_layers)
    assert placed == [] and not sched.admission.deferred
    assert not sched.admission.final
    assert sched.trace.shed_by_reason().get("deadline_miss", 0) == 2


def test_submit_windows_rejects_gating_admission(scenario):
    sched = OnlineScheduler(scenario.topology, drain="exact",
                            admission="reject")
    rng = np.random.default_rng(8)
    with pytest.raises(ValueError, match="one at a time"):
        sched.submit_windows(0.0, [scenario.sample_jobs(rng, 1)])


def test_streaming_defer_preserves_original_arrival():
    jsc, sc, rate, svc = _overload_pair(2.5)
    kw = dict(horizon=8 / rate, seed=3, rate=rate, batch_size=2,
              window_s=0.5 / rate, max_batch=4, drain="exact", finish=True,
              deadline_s=1.2 * svc, admission="defer")
    tr = run_stream(sc, **kw)
    assert_same_trace(JST.run_stream(jsc, **kw), tr)
    misses = [s for s in tr.shed if s["reason"] == "deadline_miss"]
    assert misses, "overloaded defer run must eventually shed"
    for s in misses:
        assert s["time"] >= s["arrival"]
        assert tr.arrivals_by_name[s["name"]] == s["arrival"]
    s = tr.summary()
    assert s["slo"]["pending"] == 0
    assert s["slo"]["offered"] == (s["slo"]["met"] + s["slo"]["late"]
                                   + s["slo"]["shed"])


# -- measured-EMA cold start --------------------------------------------------

def test_seed_latency_fixes_ema_cold_start(scenario):
    cfg = StreamConfig(solver_latency="measured")
    pipe = StreamingPipeline(scenario.topology, cfg, drain="exact")
    assert pipe._model_latency() == 0.0
    pipe.seed_latency(0.02)
    assert pipe._model_latency() == 0.02
    pipe.seed_latency(0.5)
    assert pipe._model_latency() == 0.02
    pipe._observe_solve(0.04)
    assert pipe._model_latency() == pytest.approx(0.03)


def test_warmup_seeds_measured_latency_model(scenario):
    rate = scenario.nominal_rate(0.5)
    tr = run_stream(scenario, horizon=4 / rate, seed=3, rate=rate,
                    solver_latency="measured", warmup=True, drain="exact")
    assert tr.windows[0].solve_model_s > 0.0
    assert tr.windows[0].commit_s > tr.windows[0].close_s


def test_warmup_reports_solve_wall_without_compiles(scenario):
    """The port has no jit: warmup counts no compile, and its warm solve
    wall is part of its total wall."""
    sched = OnlineScheduler(scenario.topology, drain="exact")
    rng = np.random.default_rng(5)
    q0 = sched.state.q_node.clone()
    info = sched.warmup(scenario.sample_jobs(rng, 2),
                        pad_to=scenario.max_layers, window_counts=(3,))
    assert info["compiles"] == 0
    assert info["warm_solve_s"] > 0.0
    assert info["warm_solve_s"] < info["wall_s"]
    assert torch.equal(sched.state.q_node, q0)
    assert not sched.ledger.jobs and sched.last_plan is None


# -- replan reasons & monitor hysteresis -------------------------------------

def test_replan_reasons_recorded():
    jsc, sc = scenario_pair("paper-small", seed=0)
    js = JO.OnlineScheduler(jsc.topology, drain="exact")
    sched = OnlineScheduler(sc.topology, drain="exact")
    assert sched.replan_last() is None
    assert sched.last_replan_reason == "no_batch"
    js.replan_last()
    for s, scn in ((js, jsc), (sched, sc)):
        s.submit_jobs(0.0, scn.sample_jobs(np.random.default_rng(12), 2),
                      pad_to=scn.max_layers)
    js.replan_last(min_improvement=0.25)
    assert sched.replan_last(min_improvement=0.25) is None
    assert sched.last_replan_reason == "no_improvement"
    js.replan_last()
    assert sched.replan_last() is not None
    assert sched.last_replan_reason == "replanned"
    assert_same_trace(js.trace, sched.trace)
    assert sched.trace.events == js.trace.events
    events = [e["event"] for e in sched.trace.events]
    assert events.count("replan_skipped") == 2
    assert events.count("replan") == 1
    s = sched.trace.summary()
    assert s["replans"] == 1
    assert s["replans_skipped"] == {"no_batch": 1, "no_improvement": 1}


def _fake_sched(divergences):
    """Minimal stand-in for the monitor's scheduler surface."""
    sched = types.SimpleNamespace(
        now=0.0, trace=types.SimpleNamespace(events=[]), committed=0)
    seq = iter(divergences)

    def plan_divergence():
        return next(seq)

    def replan_last(*, min_improvement=None):
        sched.committed += 1
        return ["placement"]

    sched.plan_divergence = plan_divergence
    sched.replan_last = replan_last
    return sched


def test_monitor_threshold_and_calm_reset():
    mon = ReplanMonitor(ReplanPolicy(threshold=0.5, cooldown_s=1.0,
                                     backoff=2.0, max_cooldown_s=8.0))
    sched = _fake_sched([0.2, None, 0.8])
    assert not mon.check(sched)
    assert not mon.check(sched)
    assert mon.check(sched)
    assert mon.triggers == 1 and sched.committed == 1


def test_monitor_cooldown_and_exponential_backoff():
    mon = ReplanMonitor(ReplanPolicy(threshold=0.1, cooldown_s=1.0,
                                     backoff=2.0, max_cooldown_s=8.0))
    sched = _fake_sched([1.0] * 6)
    for now, fires in ((0.0, True), (0.5, False), (1.0, True), (2.5, False),
                       (3.0, True)):
        sched.now = now
        assert mon.check(sched) is fires
    assert mon.triggers == 3 and sched.committed == 3
    calm = _fake_sched([0.0, 1.0])
    calm.now = 10.0
    mon2 = ReplanMonitor(ReplanPolicy(threshold=0.1, cooldown_s=1.0,
                                      backoff=4.0, max_cooldown_s=64.0))
    mon2._cool = 16.0
    assert not mon2.check(calm)
    assert mon2._cool == 1.0
    assert mon2.check(calm)


def test_monitor_budget_bounds_replans():
    mon = ReplanMonitor(ReplanPolicy(threshold=0.1, cooldown_s=0.0,
                                     budget=2))
    sched = _fake_sched([1.0] * 5)
    fired = sum(mon.check(sched) for _ in range(5))
    assert fired == 2 and mon.triggers == 2 and sched.committed == 2


def test_auto_replan_under_fault():
    from repro.serving.admission import ReplanPolicy as JReplanPolicy
    from repro.serving.faults import FaultEvent as JFaultEvent
    jsc, sc, rate, _ = _overload_pair(2.0)
    horizon = 10 / rate
    pol = dict(threshold=0.1, cooldown_s=horizon / 20, budget=3)
    kw = dict(horizon=horizon, seed=3, rate=rate, batch_size=2,
              drain="exact", finish=True)
    tr = run_online(sc, fault_schedule=[FaultEvent(
        0.4 * horizon, "rescale", node=0, factor=0.2)],
        auto_replan=ReplanPolicy(**pol), **kw)
    want = JO.run_online(jsc, fault_schedule=[JFaultEvent(
        0.4 * horizon, "rescale", node=0, factor=0.2)],
        auto_replan=JReplanPolicy(**pol), **kw)
    assert_same_trace(want, tr)
    s = tr.summary()
    assert 1 <= s.get("auto_replan_triggers", 0) <= 3
    resolved = s.get("replans", 0) + sum(
        s.get("replans_skipped", {}).values())
    assert resolved >= s.get("auto_replan_triggers", 0)


def test_admission_counters_live_on_trace(scenario):
    sched = OnlineScheduler(scenario.topology, drain="exact",
                            admission="reject")
    rng = np.random.default_rng(21)
    jobs = [j.with_deadline(1e-3) for j in scenario.sample_jobs(rng, 2)]
    sched.submit_jobs(0.0, jobs, pad_to=scenario.max_layers)
    s = sched.trace.summary()
    assert s["admission"]["assessed"] == 2
    assert s["admission"]["rejected"] + s["admission"]["expired"] == 2
    assert s["shed"] == 2


def test_admit_all_matches_no_admission_trajectory(scenario):
    rate = scenario.nominal_rate(1.0)
    kw = dict(horizon=6 / rate, seed=9, rate=rate, drain="exact",
              finish=True, deadline_s=2 * scenario.mean_service_s)
    a = run_online(scenario, admission=None, **kw)
    b = run_online(scenario, admission="admit_all", **kw)
    assert sorted(a.completions.values()) == sorted(b.completions.values())
    assert a.latencies.tolist() == b.latencies.tolist()
    assert not b.shed and b.admission["rejected"] == 0
