"""The port's solvers, plans and simulator against the JAX package's, bit
for bit: order, assignments, bounds, committed queues, paths and simulated
completions, on the quickstart instance (whose golden bounds and order are
``benchmarks/common.py``'s) and on the §V large instance (US backbone,
6 VGG19 + 2 ResNet34 + 2 hand-made models) at two capacity scales, at a
fresh and at a queued state.  Reference plans are computed once per
instance and method.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks import common  # noqa: E402
from repro.core import (Plan as JPlan, jobs as JJ, network as JN,  # noqa: E402
                        schedule as JSch, solve as jsolve)
from repro.launch import route as jroute  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (Plan as TPlan, schedule as TSch,  # noqa: E402
                              solve as tsolve, solvers as TS)
from repro_torch.launch import route as troute  # noqa: E402

METHODS = ("greedy", "lazy", "greedy_ref")
INSTANCES = ("quick", "large-1e-4", "large-1e-2", "quick-queued",
             "large-1e-4-queued")


def _port(net, batch):
    """The port's (net, batch) on the CPU from the reference's arrays."""
    tnet = interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")
    tbatch = interop.batch_from_numpy(
        *(np.asarray(x) for x in (batch.src, batch.dst, batch.comp,
                                  batch.data, batch.num_layers)),
        device="cpu")
    return tnet, tbatch


def _arr(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _instance(name):
    """(JAX net, JAX batch, port net, port batch)."""
    if name.startswith("quick"):
        net, batch = common.quickstart_instance()
    else:
        scale = float(name.split("-")[1] + "-" + name.split("-")[2])
        net, _ = JN.us_backbone(capacity_scale=scale)
        batch = JJ.batch_jobs(common.paper_jobs_large(0))
    if name.endswith("queued"):
        rng = np.random.default_rng(3)
        v = net.num_nodes
        mu_n, mu_l = np.asarray(net.mu_node), np.asarray(net.mu_link)
        qn = (rng.uniform(0, 1, v) * mu_n).astype(np.float32)
        ql = (rng.uniform(0, 1, (v, v)) * mu_l * (mu_l > 0)).astype(np.float32)
        net = net.with_queues(jnp.asarray(qn), jnp.asarray(ql))
    return (net, batch) + _port(net, batch)


@functools.lru_cache(maxsize=None)
def _ref_plan(name, method):
    net, batch, _, _ = _instance(name)
    return jsolve(net, batch, method=method, extract_paths=True)


def _assert_plans_equal(t, j):
    assert t.order.tolist() == j.order.tolist()
    np.testing.assert_array_equal(t.assign, j.assign)
    assert t.bounds.tolist() == j.bounds.tolist()
    for f in ("q_node", "q_link"):
        np.testing.assert_array_equal(_arr(getattr(t.net, f)),
                                      _arr(getattr(j.net, f)))
    assert t.paths == j.paths


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", INSTANCES)
def test_solve_matches_reference(name, method):
    net, batch, tnet, tbatch = _instance(name)
    plan = tsolve(tnet, tbatch, method=method, extract_paths=True)
    _assert_plans_equal(plan, _ref_plan(name, method))
    assert plan.meta["closure_builds"] == plan.meta["rounds"] == batch.num_jobs
    assert plan.meta["kernel_launches"] == 0     # CPU tensors: plain path
    if name == "quick":
        assert plan.bounds.tolist() == common.QUICKSTART_BOUNDS
        assert plan.order.tolist() == common.QUICKSTART_ORDER


@pytest.mark.parametrize("name", ["quick", "large-1e-4", "quick-queued"])
def test_simulate_and_replay_match_reference(name):
    net, batch, tnet, tbatch = _instance(name)
    jplan = _ref_plan(name, "greedy")
    tplan = tsolve(tnet, tbatch, method="greedy", extract_paths=True)
    jsim, tsim = jplan.simulate(net, batch), tplan.simulate(tnet, tbatch)
    np.testing.assert_array_equal(tsim.completion, jsim.completion)
    assert tsim.makespan == jsim.makespan <= tplan.bound()
    jb, jp, jfinal = JSch.replay_solution(net, batch, jplan.assign,
                                          jplan.order)
    tb, tp, tfinal = TSch.replay_solution(tnet, tbatch, tplan)
    assert tb.tolist() == jb.tolist()
    assert tp == jp
    np.testing.assert_array_equal(tfinal.q_link.numpy(),
                                  np.asarray(jfinal.q_link))
    np.testing.assert_array_equal(tfinal.q_node.numpy(),
                                  np.asarray(jfinal.q_node))
    # without stored paths, simulate replays against the reset queues
    np.testing.assert_array_equal(
        TSch.simulate(tnet, tbatch, tplan.assign, tplan.order).completion,
        JSch.simulate(net, batch, jplan.assign, jplan.order).completion)


def test_plan_json_crosses_both_ways():
    name = "quick-queued"
    jplan = _ref_plan(name, "lazy")
    _, _, tnet, tbatch = _instance(name)
    tplan = tsolve(tnet, tbatch, method="lazy", extract_paths=True)
    from_port = JPlan.from_dict(json.loads(json.dumps(
        interop.plan_to_dict(tplan))))
    from_ref = interop.plan_from_dict(json.loads(json.dumps(
        jplan.to_dict())), device="cpu")
    for a, b in ((from_port, jplan), (tplan, from_ref)):
        _assert_plans_equal(a, b)
        for f in ("mu_node", "mu_link", "clock"):
            np.testing.assert_array_equal(_arr(getattr(a.net, f)),
                                          _arr(getattr(b.net, f)))
    assert isinstance(from_ref, TPlan)
    assert TPlan.from_dict(tplan.to_dict(), device="cpu").to_dict() \
        == tplan.to_dict()


def test_route_cli_matches_reference():
    args = ("us", "vgg19:2,resnet34:1,synthetic:1", 1e-4, "greedy,lazy", 0)
    want = jroute.run(*args, verbose=False)
    got = troute.run(*args, verbose=False, device="cpu")
    timing = lambda d: {k: v for k, v in d.items() if not k.endswith("_s")}
    assert timing(got) == timing(want)
    assert set(got) == set(want)


def test_registry_lists_only_ported_solvers():
    assert TS.available() == ("greedy", "greedy_ref", "lazy")
    _, _, tnet, tbatch = _instance("quick")
    with pytest.raises(ValueError, match="available: greedy, greedy_ref, lazy"):
        tsolve(tnet, tbatch, method="sa")
    # every registry arch builds the reference's jobs; unknown ones raise
    spec = "gemma3_1b:1,deepseek_v2_236b:1,vgg19:1"
    for got, want in zip(troute.build_jobs(spec, 5, 0),
                         jroute.build_jobs(spec, 5, 0)):
        assert (got.name, got.src, got.dst) == (want.name, want.src, want.dst)
        np.testing.assert_array_equal(got.comp, want.comp)
        np.testing.assert_array_equal(got.data, want.data)
    with pytest.raises(KeyError, match="unknown arch"):
        troute.build_jobs("llama_70b:1", 5, 0)


@pytest.mark.parametrize("seed,num_jobs,with_queues", [
    (0, 5, False), (1, 5, True), (2, 7, True), (3, 3, False), (4, 8, True)])
def test_random_instances_match_reference(seed, num_jobs, with_queues):
    """Random connected networks with compute-less nodes (INF compute
    rates), at fresh and queued states: every ported solver equals the
    reference's host-loop solver."""
    from util import random_instance
    rng = np.random.default_rng(seed)
    net, jobs = random_instance(rng, num_jobs=num_jobs,
                                with_queues=with_queues)
    batch = JJ.batch_jobs(jobs)
    want = jsolve(net, batch, method="greedy_ref", extract_paths=True)
    tnet, tbatch = _port(net, batch)
    for method in METHODS:
        _assert_plans_equal(tsolve(tnet, tbatch, method=method,
                                   extract_paths=True), want)


def test_unroutable_job_never_double_commits():
    """A job whose destination has no links costs the finite INF; routed
    jobs are masked with true inf, so it is placed last, exactly once."""
    edges = [(0, 1, 2.0), (1, 2, 1.0), (0, 2, 0.5)]
    caps = [1.0, 2.0, 1.5, 1.0]
    jnet = JN.make_network(4, edges, caps)
    rng = np.random.default_rng(0)
    jobs = [JJ.InferenceJob(f"j{i}", s, d, rng.uniform(0.5, 2, 3),
                            rng.uniform(0.5, 2, 4))
            for i, (s, d) in enumerate([(0, 3), (0, 2), (2, 1)])]
    batch = JJ.batch_jobs(jobs)
    tnet, tbatch = _port(jnet, batch)
    for method in METHODS:
        want = jsolve(jnet, batch, method=method, extract_paths=True)
        got = tsolve(tnet, tbatch, method=method, extract_paths=True)
        _assert_plans_equal(got, want)
        assert got.order.tolist()[-1] == 0
        assert sorted(got.order.tolist()) == [0, 1, 2]
