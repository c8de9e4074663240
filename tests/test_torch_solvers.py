"""The port's solver registry against the JAX reference's, and the plan API
over every method: the mirror of the ``sa`` and ``exact`` cases of
``tests/test_plan_api.py``, plus ``launch/route.py`` running Algorithm 2
on the CPU."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import solvers as JS  # noqa: E402
from repro.launch import route as jroute  # noqa: E402
from repro_torch.core import Plan, jobs as TJ, solve, solvers as TS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import route as troute  # noqa: E402
from util import random_instance  # noqa: E402

METHODS = ["greedy", "lazy", "sa", "exact"]


def _instance(seed, num_jobs=4):
    net, jobs = random_instance(np.random.default_rng(seed),
                                num_jobs=num_jobs)
    tnet = interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")
    tjobs = [TJ.InferenceJob(j.name, j.src, j.dst, j.comp, j.data)
             for j in jobs]
    return tnet, TJ.batch_jobs(tjobs, device="cpu")


def test_available_equals_reference():
    """The port registers every built-in solver of the reference.  Other
    test modules register throwaway solvers into the reference's registry
    (in the same worker process), so the reference's set is read from the
    solvers its own modules registered."""
    builtin = {name for name, fn in JS._REGISTRY.items()
               if fn.__module__.startswith("repro.")}
    assert set(TS.available()) == builtin
    assert {"greedy", "lazy", "sa", "exact"} <= builtin


@pytest.mark.parametrize("method", METHODS)
def test_solve_returns_plan_for_every_method(method):
    net, batch = _instance(0, num_jobs=3)
    opts = {"d": 0.9, "num_chains": 1} if method == "sa" else {}
    plan = solve(net, batch, method=method, **opts)
    assert isinstance(plan, Plan)
    assert plan.solver == method
    assert plan.meta["method"] == method
    assert plan.meta["solve_s"] >= 0
    assert plan.assign.shape == (batch.num_jobs, batch.max_layers)
    assert sorted(plan.priority.tolist()) == list(range(batch.num_jobs))
    assert np.all(plan.bounds > 0)


@pytest.mark.parametrize("method", ["greedy", "sa", "exact"])
def test_json_round_trip_lossless(method):
    net, batch = _instance(3)
    opts = {"d": 0.9, "num_chains": 1} if method == "sa" else {}
    plan = solve(net, batch, method=method, **opts)
    rt = Plan.from_dict(json.loads(json.dumps(plan.to_dict())),
                        device="cpu")
    np.testing.assert_array_equal(rt.assign, plan.assign)
    np.testing.assert_array_equal(rt.priority, plan.priority)
    assert rt.bounds.tolist() == plan.bounds.tolist()  # bit-exact f64
    assert rt.solver == plan.solver
    if plan.net is not None:
        for f in ("q_node", "q_link"):
            np.testing.assert_array_equal(getattr(rt.net, f).numpy(),
                                          getattr(plan.net, f).numpy())
    if plan.paths is not None:
        assert rt.paths == plan.paths
    if method == "sa":
        assert rt.meta["history"] == plan.meta["history"].tolist()


def test_sa_warm_start_never_worse_than_greedy():
    net, batch = _instance(5)
    g = solve(net, batch, method="greedy")
    sa = solve(net, batch, method="sa", seed=2, d=0.97, num_chains=2,
               init="greedy", block_move_prob=0.3)
    assert sa.bound() <= g.bound() * (1 + 1e-5)


def test_route_cli_runs_sa_and_exact():
    """``--methods greedy,sa,exact --device cpu`` on the small topology:
    the same keys as the reference's run; greedy and exact equal it (SA
    draws from another generator, so only its plan's soundness holds)."""
    args = ("small", "vgg19:1,resnet34:2", 1e-3, "greedy,sa,exact", 0)
    want = jroute.run(*args, sa_iters_d=0.9, verbose=False)
    got = troute.run(*args, sa_iters_d=0.9, verbose=False, device="cpu")
    assert set(got) == set(want)
    for k in ("greedy_bound", "greedy_sim", "exact_bound", "exact_sim"):
        assert got[k] == want[k], k
    assert got["sa_sim"] <= got["sa_bound"] * (1 + 1e-5)
    assert got["exact_bound"] <= got["greedy_bound"] * (1 + 1e-5)
