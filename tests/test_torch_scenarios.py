"""The port's scenario catalog (``repro_torch.scenarios``) against the JAX
package's, and the catalog gate of the main path.

``make_scenario`` is equal for every topology family x traffic mix at seeds
0-2: capacity tensors bit for bit, names, ingress/egress, sampled jobs and
``mean_service_s``.  The catalog gate: on every family (and on a 48-node
random-geometric mesh), ``solve(method="greedy" | "lazy" | "greedy_ref")``
gives the reference's plans, dedupe-plan closures and layer DP bit for
bit, at the fresh state and at the queued state left by a committed,
exactly drained first window.  The rest mirrors ``tests/test_scenarios.py``
on the port.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as RS  # noqa: E402
from repro.core import (completions as JC, jobs as JJ, routing as JR,  # noqa: E402
                        shortest_path as JSP, solve as jsolve)
from repro_torch.core import (completions as TC, jobs as TJ,  # noqa: E402
                              routing as TR, shortest_path as TSP,
                              solve as tsolve)
from repro_torch.scenarios import (FAMILIES, MIXES,  # noqa: E402
                                   available_scenarios, make_scenario,
                                   make_traffic)

METHODS = ("greedy", "lazy", "greedy_ref")
# (family, family options): the five families at their defaults, and a
# metro edge mesh of 48 nodes (V > 32: the CUDA path closes it through the
# product loop instead of the one-launch closure kernel).
CATALOG = {f: (f, {}) for f in sorted(FAMILIES)}
CATALOG["random-geometric-48"] = ("random-geometric", {"num_nodes": 48})
WINDOW = 6


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cpu(name, seed=0, **kw):
    return make_scenario(name, seed, device="cpu", **kw)


# -- make_scenario against the reference --------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_make_scenario_matches_reference(family, mix, seed):
    j = RS.make_scenario(f"{family}:{mix}", seed)
    t = _cpu(f"{family}:{mix}", seed)
    assert t.name == j.name and t.seed == j.seed
    for f in ("mu_node", "mu_link"):
        got, want = _np(getattr(t.topology, f)), np.asarray(
            getattr(j.topology, f))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert (t.node_names, t.ingress, t.egress) == \
        (j.node_names, j.ingress, j.egress)
    assert t.max_layers == j.max_layers
    assert t.traffic.mean_flops() == j.traffic.mean_flops()
    rt, rj = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    for n in (3, 2):    # the per-instance name counter carries over
        for a, b in zip(t.sample_jobs(rt, n), j.sample_jobs(rj, n)):
            assert (a.name, a.src, a.dst) == (b.name, b.src, b.dst)
            np.testing.assert_array_equal(a.comp, b.comp)
            np.testing.assert_array_equal(a.data, b.data)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)   # same rng stream
    assert t.mean_service_s == j.mean_service_s
    assert t.nominal_rate(0.8) == j.nominal_rate(0.8)


def test_family_options_and_us_backbone_seed():
    for fam, kw in (("edge-cloud", dict(n_edge=4, n_agg=3)),
                    ("random-geometric", dict(num_nodes=48, radius=0.3)),
                    ("star", dict(num_leaves=5))):
        t = _cpu(fam, 4, **kw)
        j = RS.make_scenario(fam, 4, **kw)
        np.testing.assert_array_equal(_np(t.topology.mu_link),
                                      np.asarray(j.topology.mu_link))
        assert (t.ingress, t.egress) == (j.ingress, j.egress)
    # the backbone is fixed: the seed is accepted and ignored
    np.testing.assert_array_equal(_np(_cpu("us-backbone", 0).topology.mu_link),
                                  _np(_cpu("us-backbone", 9).topology.mu_link))


# -- the catalog gate ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _catalog(entry):
    """Both packages' scenario, two sampled windows, and the queued state a
    committed first window leaves after an exact drain of half its bound:
    ``(ref, port)`` dicts with keys sc, b1, b2, plan1, ledger, qs."""
    family, opts = CATALOG[entry]
    out = []
    for pkg, mk, J, C, solve, kw in (
            ("ref", RS.make_scenario, JJ, JC, jsolve, {}),
            ("port", make_scenario, TJ, TC, tsolve, {"device": "cpu"})):
        sc = mk(family, 0, **opts, **kw)
        rng = np.random.default_rng(5)
        jobs1, jobs2 = sc.sample_jobs(rng, WINDOW), sc.sample_jobs(rng, WINDOW)
        b1 = J.batch_jobs(jobs1, pad_to=sc.max_layers, **kw)
        b2 = J.batch_jobs(jobs2, pad_to=sc.max_layers, **kw)
        plan1 = solve(sc.topology, b1, method="greedy",
                      state=sc.topology.empty_state(), extract_paths=True)
        ledger = C.CommittedWork.empty(sc.num_nodes).commit(
            b1, plan1, names=[j.name for j in jobs1])
        ledger = C.drain_exact(sc.topology, ledger,
                               0.5 * plan1.makespan_bound)
        qs = ledger.queue_state(**kw)
        out.append(dict(sc=sc, b1=b1, b2=b2, plan1=plan1, ledger=ledger,
                        qs=qs))
    return tuple(out)


def _nets(entry, state):
    ref, port = _catalog(entry)
    if state == "fresh":
        return (ref["sc"].topology.view(), ref["b1"],
                port["sc"].topology.view(), port["b1"])
    return (ref["sc"].topology.view(ref["qs"]), ref["b2"],
            port["sc"].topology.view(port["qs"]), port["b2"])


@pytest.mark.parametrize("entry", sorted(CATALOG))
def test_catalog_queued_state_matches_reference(entry):
    """The first window's plan, its ledger after the exact drain, and the
    queued state built from it."""
    ref, port = _catalog(entry)
    assert port["plan1"].bounds.tolist() == ref["plan1"].bounds.tolist()
    assert port["plan1"].paths == ref["plan1"].paths
    assert port["ledger"].completed == ref["ledger"].completed
    assert port["ledger"].clock == ref["ledger"].clock
    assert [(j.name, j.ptr, j.remaining, j.arrived)
            for j in port["ledger"].jobs] == \
        [(j.name, j.ptr, j.remaining, j.arrived) for j in ref["ledger"].jobs]
    for f in ("q_node", "q_link", "clock"):
        got, want = _np(getattr(port["qs"], f)), np.asarray(
            getattr(ref["qs"], f))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert float(_np(port["qs"].q_node).sum()) > 0   # the state is queued


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("state", ["fresh", "queued"])
@pytest.mark.parametrize("entry", sorted(CATALOG))
def test_catalog_solve_matches_reference(entry, state, method):
    jnet, jb, tnet, tb = _nets(entry, state)
    want = jsolve(jnet, jb, method=method, extract_paths=True)
    got = tsolve(tnet, tb, method=method, extract_paths=True)
    assert got.order.tolist() == want.order.tolist()
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.bounds.tolist() == want.bounds.tolist()
    assert got.paths == want.paths
    for f in ("q_node", "q_link"):
        np.testing.assert_array_equal(_np(getattr(got.net, f)),
                                      np.asarray(getattr(want.net, f)))
    assert got.makespan_bound < 1e29          # every job is routable
    sim = got.simulate(tnet, tb)
    assert sim.makespan <= got.makespan_bound * (1 + 1e-5)


@pytest.mark.parametrize("state", ["fresh", "queued"])
@pytest.mark.parametrize("entry", sorted(CATALOG))
def test_catalog_closures_and_dp_match_reference(entry, state):
    """The dedupe plan, the closure stack and the layer DP (costs, totals,
    backpointers, assignments) of the window's batch."""
    jnet, jb, tnet, tb = _nets(entry, state)
    jplan, tplan = JSP.dedupe_plan(jb), TSP.dedupe_plan(tb)
    for name in ("uniq", "inv", "d_vals", "d_idx"):
        np.testing.assert_array_equal(_np(getattr(tplan, name)),
                                      np.asarray(getattr(jplan, name)))
    jcl = JSP.closures_for_dedup(jnet, jplan)
    tcl = TSP.closures_for_dedup(tnet, tplan)
    np.testing.assert_array_equal(_np(tcl.t), np.asarray(jcl.t))
    jc, jt, jbp = JR.route_batch_fwd(jnet, jb, closures=jcl)
    tc, tt, tbp = TR.route_batch_fwd(tnet, tb, closures=tcl)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    np.testing.assert_array_equal(_np(tbp), np.asarray(jbp))
    np.testing.assert_array_equal(TR.route_batch(tnet, tb, closures=tcl).assign,
                                  np.asarray(JR.route_batch(
                                      jnet, jb, closures=jcl).assign))


# -- mirror of tests/test_scenarios.py ----------------------------------------

def test_catalog_covers_required_families():
    names = available_scenarios()
    assert {"paper-small", "us-backbone", "edge-cloud", "random-geometric",
            "star"} <= set(names)
    assert names == RS.available_scenarios()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_family_builds_and_routes(name):
    sc = _cpu(name)
    assert sc.num_nodes >= 2
    assert sc.ingress and sc.egress
    assert all(0 <= i < sc.num_nodes for i in sc.ingress + sc.egress)
    assert float(sc.topology.mu_node.max()) > 0
    assert sc.topology.device.type == "cpu"
    rng = np.random.default_rng(0)
    jobs = sc.sample_jobs(rng, 2)
    assert all(j.num_layers <= sc.max_layers for j in jobs)
    plan = tsolve(sc.topology,
                  TJ.batch_jobs(jobs, pad_to=sc.max_layers, device="cpu"),
                  method="greedy", state=sc.topology.empty_state())
    assert plan.makespan_bound < 1e29  # routable: src reaches dst
    assert sc.mean_service_s > 0 and np.isfinite(sc.mean_service_s)
    assert sc.nominal_rate(0.5) > 0


def test_scenarios_deterministic_in_seed():
    for name in ("random-geometric", "edge-cloud", "star"):
        a, b = _cpu(name, 7), _cpu(name, 7)
        assert torch.equal(a.topology.mu_link, b.topology.mu_link)
        ja = a.sample_jobs(np.random.default_rng(1), 3)
        jb = b.sample_jobs(np.random.default_rng(1), 3)
        for x, y in zip(ja, jb):
            assert (x.src, x.dst) == (y.src, y.dst)
            np.testing.assert_array_equal(x.comp, y.comp)
    assert not torch.equal(_cpu("random-geometric", 7).topology.mu_link,
                           _cpu("random-geometric", 8).topology.mu_link)


def test_traffic_selection_by_name_and_kwarg():
    assert _cpu("us-backbone:lm").traffic.name == "lm"
    assert _cpu("us-backbone", traffic="lm").traffic.name == "lm"
    assert _cpu("us-backbone").traffic.name == "paper"
    with pytest.raises(ValueError, match="either in the name"):
        _cpu("us-backbone:lm", traffic="paper")
    with pytest.raises(ValueError, match="unknown scenario family"):
        _cpu("not-a-family")
    with pytest.raises(ValueError, match="unknown traffic mix"):
        make_traffic("not-a-mix")


def test_traffic_mixes_cost_profiles():
    assert set(MIXES) >= {"paper", "lm", "synthetic", "conv"}
    rng = np.random.default_rng(0)
    for mix_name in MIXES:
        mix = make_traffic(mix_name)
        job = mix.sample(rng, "j", 0, 1)
        assert job.num_layers <= mix.max_layers
        assert mix.mean_flops() > 0
        assert mix.mean_flops() == RS.make_traffic(mix_name).mean_flops()


def test_src_dst_distinct_when_possible():
    sc = _cpu("star")
    rng = np.random.default_rng(0)
    for _ in range(20):
        s, d = sc.sample_src_dst(rng)
        assert s != d
