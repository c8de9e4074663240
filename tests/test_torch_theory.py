"""Theorem 1 (the ILP's constraint matrices) and Theorem 2 (the
approximation ratio) in the port, against the JAX reference on the CPU:
the mirror of ``tests/test_theory.py``.

``layered_graph.build_ilp`` must give the reference's matrices exactly
(``np.array_equal``); ``bounds.alpha``, ``corollary1_factor`` and
``service_lower_bounds`` the reference's values exactly, the port
computing its graph quantities without ``networkx`` where the reference
asks ``networkx`` for them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import (bounds as JB, exact as JE, jobs as JJ,  # noqa: E402
                        layered_graph as JL, network as JN)
from repro_torch import interop  # noqa: E402
from repro_torch.core import (bounds as TB, exact as TE,  # noqa: E402
                              greedy as TG, jobs as TJ, layered_graph as TL,
                              schedule as TSch)
from util import random_instance  # noqa: E402

SEEDS = [0, 1, 2, 3, 4, 5, 6, 7]


def _port_net(net):
    return interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")


def _port_jobs(jobs):
    return [TJ.InferenceJob(j.name, j.src, j.dst, j.comp, j.data)
            for j in jobs]


def _instance(seed, num_jobs=1, with_queues=False):
    """(reference net, reference jobs, port net, port jobs)."""
    net, jobs = random_instance(np.random.default_rng(seed),
                                num_jobs=num_jobs, with_queues=with_queues)
    return net, jobs, _port_net(net), _port_jobs(jobs)


def _disconnected():
    """Two components ({0, 1, 2} and {3, 4}); the jobs stay inside the
    first, so alpha is defined and the edge connectivity is 0."""
    edges = [(0, 1, 2.0), (1, 2, 1.5), (0, 2, 0.7), (3, 4, 3.0)]
    net = JN.make_network(5, edges, [1.0, 2.0, 0.0, 1.5, 0.5])
    rng = np.random.default_rng(11)
    jobs = [JJ.InferenceJob(f"j{i}", s, d, rng.uniform(0.3, 3.0, 2),
                            rng.uniform(0.1, 2.0, 3))
            for i, (s, d) in enumerate([(0, 2), (2, 1)])]
    return net, jobs, _port_net(net), _port_jobs(jobs)


@pytest.mark.parametrize("with_queues", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_ilp_matrices_equal_reference(seed, with_queues):
    net, jobs, tnet, tjobs = _instance(seed, with_queues=with_queues)
    job, tjob = jobs[0], tjobs[0]
    want = JL.build_ilp(net, job.num_layers, job.src, job.dst, job.comp,
                        job.data)
    got = TL.build_ilp(tnet, tjob.num_layers, tjob.src, tjob.dst, tjob.comp,
                       tjob.data)
    for f in ("a1", "a2", "b2", "c"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.edges == want.edges
    assert (got.num_nodes, got.num_layers) == (want.num_nodes,
                                               want.num_layers)
    assert got.cross_var(1, 1) == want.cross_var(1, 1)
    assert got.intra_var(0, 0) == want.intra_var(0, 0)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_constraint_matrix_is_tu(seed):
    """Random square submatrices of [A1; A2] have det in {-1, 0, 1}, and
    the spot-check draws the reference's submatrices."""
    net, jobs, tnet, tjobs = _instance(seed)
    tjob = tjobs[0]
    ilp = TL.build_ilp(tnet, tjob.num_layers, tjob.src, tjob.dst, tjob.comp,
                       tjob.data)
    mat = np.vstack([ilp.a1, ilp.a2])
    dets = TL.random_square_submatrix_dets(mat, trials=150, max_k=8,
                                           seed=seed)
    np.testing.assert_allclose(dets, np.round(dets), atol=1e-7)
    assert np.all(np.abs(np.round(dets)) <= 1)
    assert np.array_equal(dets, JL.random_square_submatrix_dets(
        mat, trials=150, max_k=8, seed=seed))


def test_b2_is_unit_flow():
    _, _, tnet, tjobs = _instance(0)
    job = tjobs[0]
    ilp = TL.build_ilp(tnet, job.num_layers, job.src, job.dst, job.comp,
                       job.data)
    assert ilp.b2.sum() == 0
    assert sorted(np.unique(ilp.b2)) in ([-1.0, 0.0, 1.0], [-1.0, 1.0])


@pytest.mark.parametrize("case", [f"random-{s}" for s in SEEDS]
                         + ["disconnected", "paper-small", "us-backbone"])
def test_alpha_and_lower_bounds_equal_reference(case):
    """alpha, corollary1_factor and Lemma 8's bounds: the port's values,
    computed without networkx, equal the reference's exactly (V = 6 and 5
    enumerate simple paths; the 24-node backbone takes the |V| - 1
    bound)."""
    if case == "disconnected":
        net, jobs, tnet, tjobs = _disconnected()
    elif case in ("paper-small", "us-backbone"):
        from repro.configs import registry as jreg
        net, _ = (JN.small_topology(capacity_scale=1e-3)
                  if case == "paper-small"
                  else JN.us_backbone(capacity_scale=1e-4))
        rng = np.random.default_rng(0)
        jobs = [jreg.get(kind).make_job(f"{kind}-{i}", *map(int, rng.choice(
            net.num_nodes, 2, replace=False)))
            for i, kind in enumerate(["vgg19"] * 2 + ["resnet34"] * 3)]
        tnet, tjobs = _port_net(net), _port_jobs(jobs)
    else:
        net, jobs, tnet, tjobs = _instance(int(case.split("-")[1]),
                                           num_jobs=3, with_queues=True)
    assert TB.alpha(tnet, tjobs) == JB.alpha(net, jobs)
    assert TB.corollary1_factor(tnet) == JB.corollary1_factor(net)
    want_s, want_avg = JB.service_lower_bounds(net, JJ.batch_jobs(jobs))
    got_s, got_avg = TB.service_lower_bounds(
        tnet, TJ.batch_jobs(tjobs, device="cpu"))
    assert got_s.tolist() == np.asarray(want_s).tolist()
    assert got_avg == want_avg


def test_graph_quantities_equal_networkx():
    """The hop counts and the edge connectivity the port computes itself,
    against networkx on random graphs: connected, disconnected, with
    isolated nodes, and one node."""
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(5)
    for trial in range(40):
        v = int(rng.integers(1, 10))
        mu = (rng.random((v, v)) < rng.uniform(0.1, 0.6)).astype(np.float32)
        np.fill_diagonal(mu, 0)
        net = interop.network_from_numpy(np.ones(v), mu, np.zeros(v),
                                         np.zeros((v, v)), device="cpu")
        adj, n_e = TB._graph(net)
        g = nx.Graph()
        g.add_nodes_from(range(v))
        g.add_edges_from(zip(*np.nonzero(mu > 0)))
        assert n_e == g.number_of_edges()
        assert TB.edge_connectivity(adj) == nx.edge_connectivity(g), trial
        for s in range(v):
            for t in range(v):
                want = max((len(p) - 1 for p in nx.all_simple_paths(g, s, t)),
                           default=0)
                assert TB._longest_simple_path_len(adj, s, t) == want
                if nx.has_path(g, s, t):
                    assert TB._shortest_path_len(adj, s, t) == \
                        nx.shortest_path_length(g, s, t)
                else:
                    with pytest.raises(ValueError, match="No path"):
                        TB._shortest_path_len(adj, s, t)


def test_theorem2_alpha_bound_tiny():
    """Greedy completion <= alpha * T* on a brute-forced tiny instance, with
    the port's T* equal to the reference's."""
    G = 1.0
    edges = [(0, 1, 10.0), (1, 2, 10.0), (0, 2, 10.0)]
    caps = [2 * G, 1 * G, 0]
    mk = [("a", 0, 2, [2.0], [1.0, 1.0]), ("b", 2, 0, [3.0], [1.0, 0.5])]
    net = JN.make_network(3, edges, caps)
    jobs = [JJ.InferenceJob(n, s, d, np.array(c, np.float32),
                            np.array(x, np.float32)) for n, s, d, c, x in mk]
    tnet, tjobs = _port_net(net), _port_jobs(jobs)
    batch = TJ.batch_jobs(tjobs, device="cpu")
    sol = TG.greedy_route(tnet, batch)
    sim = sol.simulate(tnet, batch)
    tstar = TE.brute_force_makespan(tnet, batch)
    assert tstar == JE.brute_force_makespan(net, JJ.batch_jobs(jobs))
    a = TB.alpha(tnet, tjobs)
    assert sim.makespan <= a * tstar * (1 + 1e-6), (sim.makespan, a, tstar)
    assert sol.makespan_bound <= a * tstar * (1 + 1e-6)


def test_corollary1_zero_delay_identical_caps():
    """Zero network delay + identical caps: greedy <= (2 - 1/|V|) T*."""
    big = 1e12
    edges = [(0, 1, big), (1, 2, big), (2, 3, big), (3, 0, big)]
    net = JN.make_network(4, edges, [1.0, 1.0, 1.0, 1.0])
    rng = np.random.default_rng(2)
    jobs = [JJ.InferenceJob(f"j{i}", int(rng.integers(4)),
                            int(rng.integers(4)),
                            np.array([rng.uniform(0.5, 2)], np.float32),
                            np.array([1e-9, 1e-9], np.float32))
            for i in range(3)]
    tnet = _port_net(net)
    batch = TJ.batch_jobs(_port_jobs(jobs), device="cpu")
    sol = TG.greedy_route(tnet, batch)
    sim = sol.simulate(tnet, batch)
    tstar = TE.brute_force_makespan(tnet, batch)
    assert tstar == JE.brute_force_makespan(net, JJ.batch_jobs(jobs))
    assert sim.makespan <= TB.corollary1_factor(tnet) * tstar * (1 + 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_lemma8_lower_bounds(seed):
    """Lemma 8: S_j^SS and the component average lower-bound T*."""
    _, _, tnet, tjobs = _instance(seed, num_jobs=2)
    batch = TJ.batch_jobs(tjobs, device="cpu")
    s_ss, avg_lb = TB.service_lower_bounds(tnet, batch)
    if np.any(s_ss >= 1e29):
        return
    sol = TG.greedy_route(tnet, batch)
    sim = TSch.simulate(tnet, batch, sol.assign, sol.order)
    assert sim.makespan >= max(s_ss.max(), avg_lb) * (1 - 1e-5)
