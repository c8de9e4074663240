"""The port's serving path against the JAX reference on the CPU: LM cost
profiles and the routed scheduler's plans bit for bit (fluid drain), and
the decode engine's tokens equal in float32 (the cluster is
``tests/test_serving.py``'s)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import network as JN  # noqa: E402
from repro.launch import route as jroute  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import network as TN  # noqa: E402
from repro_torch.launch import route as troute  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

G, GB = 1e12, 1e9
EDGES = [(0, 1, 10 * GB), (1, 2, 40 * GB), (2, 3, 40 * GB), (3, 4, 40 * GB),
         (4, 5, 10 * GB), (1, 3, 40 * GB), (2, 4, 40 * GB)]
CAPS = [0, 50 * G, 50 * G, 50 * G, 50 * G, 0]


def _schedulers(method="greedy"):
    return (jsched.RoutedScheduler(JN.make_network(6, EDGES, CAPS),
                                   method=method),
            tsched.RoutedScheduler(TN.make_network(6, EDGES, CAPS,
                                                   device="cpu"),
                                   method=method))


def _same_placements(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (b.priority, b.job_name, b.num_layers) == \
            (a.priority, a.job_name, a.num_layers)
        np.testing.assert_array_equal(b.assign, a.assign)
        assert b.bound_s == a.bound_s
        assert b.nodes_used == a.nodes_used


def _same_state(js, ts):
    for name in ("q_node", "q_link"):
        np.testing.assert_array_equal(getattr(ts.state, name).numpy(),
                                      np.asarray(getattr(js.state, name)))
    assert ts.clock == js.clock
    assert float(ts.state.clock) == float(js.state.clock)


@pytest.mark.parametrize("arch", ["smollm_135m", "olmo_1b"])
def test_cost_profiles_bit_equal(arch):
    for seq_len, batch in ((2048, 1), (1024, 4), (7, 3)):
        want = jreg.cost_profile(arch, seq_len=seq_len, batch=batch)
        got = treg.cost_profile(arch, seq_len=seq_len, batch=batch)
        for a, b in zip(want, got):
            assert b.dtype == np.float64
            np.testing.assert_array_equal(b, a)
    for name in ("vgg19", "resnet34"):
        for a, b in zip(jreg.cost_profile(name, batch=2),
                        treg.cost_profile(name, batch=2)):
            np.testing.assert_array_equal(b, a)


def test_route_driver_builds_lm_jobs_as_reference():
    spec = "smollm_135m:2,vgg19:1,olmo_1b:1,synthetic:1"
    for a, b in zip(jroute.build_jobs(spec, 6, 3),
                    troute.build_jobs(spec, 6, 3)):
        assert (b.name, b.src, b.dst) == (a.name, a.src, a.dst)
        np.testing.assert_array_equal(b.comp, a.comp)
        np.testing.assert_array_equal(b.data, a.data)


@pytest.mark.parametrize("method", ["greedy", "lazy"])
@pytest.mark.parametrize("arch,n,seq_len", [
    ("smollm_135m", 4, 1024), ("smollm_135m", 3, 2048),
    ("olmo_1b", 2, 2048), ("olmo_1b", 8, 2048)])
def test_scheduler_plans_bit_equal(arch, n, seq_len, method):
    """Placements, bounds and committed queues equal the reference's, then
    again after the clock runs (fluid drain) and a second batch lands on
    the drained queues.  olmo_1b x 8 is the queue-aware spreading case."""
    js, ts = _schedulers(method)
    reqs = [jsched.Request(arch, 0, 5, seq_len=seq_len, name=f"r{i}")
            for i in range(n)]
    treqs = [tsched.Request(**dataclasses.asdict(r)) for r in reqs]
    _same_placements(js.schedule(reqs), ts.schedule(treqs))
    np.testing.assert_array_equal(ts.last_plan.bounds, js.last_plan.bounds)
    np.testing.assert_array_equal(ts.last_plan.assign, js.last_plan.assign)
    assert ts.last_plan.solver == js.last_plan.solver == method
    _same_state(js, ts)
    for sched in (js, ts):
        sched.advance(2e-3)
    _same_state(js, ts)
    _same_placements(js.schedule(reqs[:2]), ts.schedule(treqs[:2]))
    _same_state(js, ts)
    if n == 8:
        assert len({m for p in ts.schedule(treqs) for m in p.nodes_used}) >= 2


def test_straggler_avoidance_bit_equal():
    """The reference's straggler case: a slice reported 10x slow after a
    drain receives no new placements, in both packages alike."""
    js, ts = _schedulers()
    warm = [jsched.Request("olmo_1b", 0, 5, name="warm")]
    hot = js.schedule(warm)[0].nodes_used[0]
    assert ts.schedule([tsched.Request("olmo_1b", 0, 5, name="warm")]
                       )[0].nodes_used[0] == hot
    for sched in (js, ts):
        sched.drain()
        sched.report_slowdown(hot, 10.0)
    reqs = [jsched.Request("olmo_1b", 0, 5, name=f"r{i}") for i in range(4)]
    got = ts.schedule([tsched.Request(**dataclasses.asdict(r))
                       for r in reqs])
    _same_placements(js.schedule(reqs), got)
    assert all(hot not in p.nodes_used for p in got)
    _same_state(js, ts)
    for sched in (js, ts):
        sched.report_recovery(hot)
        sched.set_node_availability(2, False)
        sched.set_link_availability(3, 4, False)
    _same_placements(js.schedule(reqs[:2]), ts.schedule(
        [tsched.Request(**dataclasses.asdict(r)) for r in reqs[:2]]))
    _same_state(js, ts)


def test_scheduler_validates_and_refuses_unported_modes():
    """Every mode is ported now: what is refused is what the reference
    refuses -- bad slowdowns, nodes, links and times, a bogus drain or
    event engine -- and a replan with nothing to re-place declines with
    the reference's reason."""
    _, ts = _schedulers()
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="slowdown factor"):
            ts.report_slowdown(1, bad)
    with pytest.raises(ValueError, match="out of range"):
        ts.report_slowdown(99, 2.0)
    assert (ts._slowdown == 1.0).all()
    ts.report_slowdown(1, 2.0)
    assert ts._slowdown[1] == 2.0
    with pytest.raises(ValueError, match="does not exist"):
        ts.set_link_availability(0, 5, False)
    with pytest.raises(ValueError, match="dt must be"):
        ts.advance(-1.0)
    net = TN.make_network(6, EDGES, CAPS, device="cpu")
    with pytest.raises(ValueError, match="drain must be"):
        tsched.RoutedScheduler(net, drain="bogus")
    with pytest.raises(ValueError, match="sim_engine must be"):
        tsched.RoutedScheduler(net, drain="exact", sim_engine="bogus")
    fresh = tsched.RoutedScheduler(net, drain="exact", track_commits=True,
                                   sim_engine="ref")
    assert fresh.replan_last() is None
    assert fresh.last_replan_reason == "no_batch"
    assert fresh.stats() == {} and fresh.schedule_windows([]) == []
    assert fresh.warmup([])["compiles"] == 0


def _requests(arch, n, **kw):
    return [tsched.Request(arch, 0, 5, name=f"r{i}", **kw) for i in range(n)]


def _jrequests(arch, n, **kw):
    return [jsched.Request(arch, 0, 5, name=f"r{i}", **kw) for i in range(n)]


def test_placements_valid_and_prioritized():
    _, ts = _schedulers()
    plans = ts.schedule(_requests("smollm_135m", 4, seq_len=1024))
    assert [p.priority for p in plans] == [0, 1, 2, 3]
    for p in plans:
        assert all(n in (1, 2, 3, 4) for n in p.nodes_used)
        assert p.bound_s > 0


def test_placements_are_views_over_stored_plan():
    import json
    from repro_torch.core.plan import Plan

    _, ts = _schedulers()
    plans = ts.schedule(_requests("smollm_135m", 3))
    stored = ts.last_plan
    assert stored is not None and stored.solver == "greedy"
    for p in plans:
        assert p.plan is stored
        assert p.bound_s == float(stored.bounds[p.job])
    rt = Plan.from_dict(json.loads(json.dumps(stored.to_dict())),
                        device="cpu")
    np.testing.assert_array_equal(rt.assign, stored.assign)
    np.testing.assert_array_equal(rt.priority, stored.priority)


def test_scheduler_method_flag():
    by_method = {}
    for method in ("greedy", "lazy"):
        _, ts = _schedulers(method)
        ts.schedule(_requests("smollm_135m", 3))
        by_method[method] = ts.last_plan
        assert ts.stats()["method"] == method
    np.testing.assert_allclose(by_method["greedy"].bounds,
                               by_method["lazy"].bounds, rtol=1e-6)


def test_replan_last_routes_around_straggler():
    """report_slowdown + replan_last re-places the same batch, as the
    reference's scheduler does, bit for bit."""
    js, ts = _schedulers()
    _same_placements(js.schedule(_jrequests("olmo_1b", 2)),
                     ts.schedule(_requests("olmo_1b", 2)))
    victim = ts.last_plan.assign[int(ts.last_plan.order[0]), 0]
    for sched in (js, ts):
        sched.report_slowdown(int(victim), 50.0)
    replans = ts.replan_last()
    _same_placements(js.replan_last(), replans)
    _same_state(js, ts)
    assert replans is not None and len(replans) == 2
    assert ts.last_replan_reason == "replanned"
    for p in replans:
        assert victim not in p.nodes_used, (victim, p.nodes_used)


def test_scheduler_exact_drain_end_to_end():
    js = jsched.RoutedScheduler(JN.make_network(6, EDGES, CAPS),
                                drain="exact")
    ts = tsched.RoutedScheduler(TN.make_network(6, EDGES, CAPS,
                                                device="cpu"), drain="exact")
    plans = ts.schedule(_requests("smollm_135m", 3))
    _same_placements(js.schedule(_jrequests("smollm_135m", 3)), plans)
    assert [p.priority for p in plans] == [0, 1, 2]
    assert len(ts.ledger.jobs) == 3
    q0 = float(ts.state.q_node.sum())
    assert q0 > 0
    for sched in (js, ts):
        sched.advance(1e-3)
    _same_state(js, ts)
    assert float(ts.state.q_node.sum()) < q0
    for sched in (js, ts):
        sched.advance(1e9)
    assert ts.ledger.completed == js.ledger.completed
    assert not ts.ledger.jobs and len(ts.ledger.completed) == 3
    assert float(ts.state.q_node.max()) == 0.0
    assert float(ts.state.q_link.max()) == 0.0


def test_scheduler_advance_drains_queues():
    _, ts = _schedulers()
    ts.schedule(_requests("olmo_1b", 1))
    q0 = float(ts.state.q_node.sum())
    assert q0 > 0
    ts.advance(1e-3)
    assert float(ts.state.q_node.sum()) < q0
    ts.advance(1e9)
    assert float(ts.state.q_node.max()) == 0.0
    assert float(ts.state.q_link.max()) == 0.0
    assert ts.clock > 0


def test_serve_driver_plans_bit_equal():
    """``launch.serve``'s routed plan on the CPU equals the reference
    scheduler's on the reference's default cluster."""
    sched, plans, res = tserve.run("smollm_135m", requests=3, gen=4,
                                   prompt_len=4, device="cpu", verbose=False)
    js = jsched.RoutedScheduler(jserve.default_cluster())
    _same_placements(js.schedule([
        jsched.Request("smollm_135m", src=0, dst=5, seq_len=2048,
                       name=f"req{i}") for i in range(3)]), plans)
    assert res.tokens.shape == (3, 4)


def _engines(arch, max_len=64):
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return (jengine.DecodeEngine(jcfg, params, max_len=max_len),
            tengine.DecodeEngine(tcfg, tparams, max_len=max_len,
                                 device="cpu"))


@pytest.mark.parametrize("arch", ["smollm_135m", "olmo_1b"])
def test_engine_tokens_equal_reference(arch):
    jeng, teng = _engines(arch)
    prompts = np.random.default_rng(0).integers(0, 512, (3, 5)).astype(
        np.int32)
    want = jeng.generate(prompts, gen_len=8)
    got = teng.generate(prompts, gen_len=8)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (3, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens_per_s > 0 and got.prefill_s >= 0


def test_engine_modes_agree_and_bogus_mode_raises():
    _, teng = _engines("smollm_135m")
    prompts = np.full((3, 4), 7, np.int32)
    res = teng.generate(prompts, gen_len=8)
    np.testing.assert_array_equal(
        res.tokens, teng.generate(prompts, gen_len=8).tokens)
    np.testing.assert_array_equal(
        res.tokens,
        teng.generate(prompts, gen_len=8, prefill_mode="per_token").tokens)
    with pytest.raises(ValueError, match="prefill_mode"):
        teng.generate(prompts, gen_len=8, prefill_mode="bogus")
    with pytest.raises(ValueError, match="max_len"):
        teng.generate(prompts, gen_len=61)
