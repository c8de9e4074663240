"""The exact oracles in the port (``repro_torch.core.exact``) against the
JAX reference on the CPU: the bitmask ILP oracle's cost and assignment,
the port's routing DP against the oracle (the mirror of
``tests/test_routing.py::test_dp_matches_ilp_oracle``, rtol 2e-5), and
``solve(method="exact")`` bit for bit (order, assignments, bounds,
``n_routings``), never worse than greedy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import exact as JE, jobs as JJ, solve as jsolve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import (exact as TE, jobs as TJ, routing as TR,  # noqa: E402
                              solve as tsolve)
from repro_torch.core.shortest_path import closure_build_count  # noqa: E402
from util import random_instance  # noqa: E402

SEEDS = list(range(12))


def _port(net, jobs):
    tnet = interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")
    tjobs = [TJ.InferenceJob(j.name, j.src, j.dst, j.comp, j.data)
             for j in jobs]
    return tnet, tjobs


@pytest.mark.parametrize("with_queues", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_bitmask_oracle_equals_reference(seed, with_queues):
    net, jobs = random_instance(np.random.default_rng(seed), num_jobs=1,
                                with_queues=with_queues)
    tnet, tjobs = _port(net, jobs)
    job = jobs[0]
    want = JE.exact_route_bitmask(net, job.comp, job.data, job.src, job.dst)
    got = TE.exact_route_bitmask(tnet, job.comp, job.data, job.src, job.dst)
    assert got == want


@pytest.mark.parametrize("with_queues", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_dp_matches_ilp_oracle(seed, with_queues):
    """Theorem 1, constructively: the port's DP value equals the exact ILP
    optimum (once-per-node z_u waiting semantics)."""
    net, jobs = random_instance(np.random.default_rng(seed), num_jobs=1,
                                with_queues=with_queues)
    tnet, tjobs = _port(net, jobs)
    job = tjobs[0]
    r = TR.route_single(tnet, job.comp, job.data, job.src, job.dst,
                        job.num_layers)
    c_exact, _ = TE.exact_route_bitmask(tnet, job.comp, job.data, job.src,
                                        job.dst)
    got = float(r.cost)
    if c_exact >= 1e29:
        assert got >= 1e29
    else:
        np.testing.assert_allclose(got, c_exact, rtol=2e-5)


@pytest.mark.parametrize("seed,num_jobs,with_queues", [
    (0, 3, False), (1, 3, True), (2, 4, False), (3, 2, True), (4, 4, True)])
def test_exact_plan_equals_reference(seed, num_jobs, with_queues):
    net, jobs = random_instance(np.random.default_rng(seed),
                                num_jobs=num_jobs, with_queues=with_queues)
    tnet, tjobs = _port(net, jobs)
    want = jsolve(net, JJ.batch_jobs(jobs), method="exact")
    n0 = closure_build_count()
    got = tsolve(tnet, TJ.batch_jobs(tjobs, device="cpu"), method="exact")
    assert got.order.tolist() == want.order.tolist()
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.bounds.tolist() == want.bounds.tolist()
    for key in ("n_routings", "orders_tried"):
        assert got.meta[key] == want.meta[key]
    assert got.solver == "exact" and got.meta["method"] == "exact"
    # one counted closure build per job routed (one closure launch each on
    # the card)
    assert closure_build_count() - n0 == got.meta["n_routings"]


def test_exact_refuses_large_instances():
    net, jobs = random_instance(np.random.default_rng(0), num_jobs=8)
    tnet, tjobs = _port(net, jobs)
    with pytest.raises(ValueError, match="<= 7 jobs"):
        tsolve(tnet, TJ.batch_jobs(tjobs, device="cpu"), method="exact")


@pytest.mark.parametrize("seed", [80, 81, 82])
def test_exact_never_worse_than_greedy(seed):
    net, jobs = random_instance(np.random.default_rng(seed), num_jobs=3)
    tnet, tjobs = _port(net, jobs)
    batch = TJ.batch_jobs(tjobs, device="cpu")
    g = tsolve(tnet, batch, method="greedy")
    e = tsolve(tnet, batch, method="exact")
    assert e.bound() <= g.bound() * (1 + 1e-5)
