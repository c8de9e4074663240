"""The port's network state, jobs, closures and layer DP against the JAX
package's, bit for bit.

Each case runs on the paper's two topologies (the 5-node small topology and
the 24-node US backbone) at a fresh and at a random queued state.  Inputs
are made with numpy from a seed and handed to both packages.

The DP line ``min(g, moved) + c_l * cinv`` is where the contraction
question lives: XLA:CPU contracts it into one fused multiply-add on an FMA
host, and the port rounds it once to match (``core.numerics.fma_f32``);
``test_route_batch_fwd_matches_reference`` holds costs and backpointers to
the reference bit for bit.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks import common  # noqa: E402
from repro.core import (jobs as JJ, network as JN, routing as JR,  # noqa: E402
                        shortest_path as JSP, state as JS)
from repro_torch import interop  # noqa: E402
from repro_torch.core import (jobs as TJ, network as TN,  # noqa: E402
                              routing as TR, shortest_path as TSP,
                              state as TS)
from repro_torch.core.numerics import fma_f32  # noqa: E402


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_net(net):
    return interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")


def _port_batch(batch):
    return interop.batch_from_numpy(
        *(np.asarray(x) for x in (batch.src, batch.dst, batch.comp,
                                  batch.data, batch.num_layers)),
        device="cpu")


def _instance(topology, queued):
    """(JAX net, JAX batch, port net, port batch) on one topology."""
    if topology == "small":
        net, _ = JN.small_topology(capacity_scale=1e-3)
        jobs = common.paper_jobs_small(0)
    else:
        net, _ = JN.us_backbone(capacity_scale=1e-4)
        jobs = common.paper_jobs_large(0)
    if queued:
        rng = np.random.default_rng(7)
        v = net.num_nodes
        mu_n, mu_l = np.asarray(net.mu_node), np.asarray(net.mu_link)
        qn = (rng.uniform(0, 2, v) * mu_n).astype(np.float32)
        ql = (rng.uniform(0, 2, (v, v)) * mu_l * (mu_l > 0)).astype(np.float32)
        net = net.with_queues(jnp.asarray(qn), jnp.asarray(ql))
    batch = JJ.batch_jobs(jobs)
    return net, batch, _port_net(net), _port_batch(batch)


CASES = [(t, q) for t in ("small", "us") for q in (False, True)]


@pytest.mark.parametrize("scale", [1e-4, 1e-2])
@pytest.mark.parametrize("topology", ["small", "us"])
def test_topology_builders_match_reference(topology, scale):
    if topology == "small":
        jnet, jnames = JN.small_topology(capacity_scale=scale)
        tnet, tnames = TN.small_topology(capacity_scale=scale, device="cpu")
    else:
        jnet, jnames = JN.us_backbone(capacity_scale=scale)
        tnet, tnames = TN.us_backbone(capacity_scale=scale, device="cpu")
    assert tnames == jnames
    for name in ("mu_node", "mu_link", "q_node", "q_link", "clock"):
        got, want = _np(getattr(tnet, name)), np.asarray(getattr(jnet, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert np.float32(TN.INF) == np.asarray(JN.INF)


@pytest.mark.parametrize("pad_to", [None, 40])
def test_batch_jobs_match_reference(pad_to):
    jjobs = common.paper_jobs_large(0)
    jb = JJ.batch_jobs(jjobs, pad_to=pad_to)
    tjobs = [TJ.InferenceJob(j.name, j.src, j.dst, j.comp, j.data)
             for j in jjobs]
    tb = TJ.batch_jobs(tjobs, pad_to=pad_to, device="cpu")
    for name in ("src", "dst", "comp", "data", "num_layers"):
        got, want = _np(getattr(tb, name)), np.asarray(getattr(jb, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    syn_j = JJ.synthetic_job("s", 1, 2, 7, seed=3)
    syn_t = TJ.synthetic_job("s", 1, 2, 7, seed=3)
    np.testing.assert_array_equal(syn_t.comp, syn_j.comp)
    np.testing.assert_array_equal(syn_t.data, syn_j.data)


def test_job_validation_matches_reference():
    for comp, data in (([1.0, -1.0], [1.0, 1.0, 1.0]), ([1.0], [1.0]),
                       ([np.nan], [1.0, 1.0])):
        with pytest.raises(ValueError):
            JJ.InferenceJob("x", 0, 1, comp, data)
        with pytest.raises(ValueError):
            TJ.InferenceJob("x", 0, 1, comp, data)


@pytest.mark.parametrize("topology,queued", CASES)
def test_rates_waits_and_edge_weights_match_reference(topology, queued):
    jnet, jb, tnet, tb = _instance(topology, queued)
    for fn in ("link_invrate", "link_wait", "node_invrate", "node_wait"):
        np.testing.assert_array_equal(_np(getattr(TN, fn)(tnet)),
                                      np.asarray(getattr(JN, fn)(jnet)))
    np.testing.assert_array_equal(
        _np(TSP.layer_edge_weights(tnet, tb.data)),
        np.asarray(JSP.layer_edge_weights(jnet, jb.data)))


@pytest.mark.parametrize("topology,queued", CASES)
def test_dedup_closures_match_reference(topology, queued):
    jnet, jb, tnet, tb = _instance(topology, queued)
    jplan, tplan = JSP.dedupe_plan(jb), TSP.dedupe_plan(tb)
    for name in ("uniq", "inv", "d_vals", "d_idx"):
        np.testing.assert_array_equal(_np(getattr(tplan, name)),
                                      np.asarray(getattr(jplan, name)))
    got = TSP.closures_for_dedup(tnet, tplan).t
    np.testing.assert_array_equal(
        _np(got), np.asarray(JSP.closures_for_dedup(jnet, jplan).t))
    one = TSP.closures_for(tnet, tb.data[0])
    np.testing.assert_array_equal(_np(one.t), _np(got[0]))
    n0 = TSP.closure_build_count()
    TSP.build_closures_batch(tnet, tb, dplan=tplan)
    TSP.build_closures(tnet, tb.data[0])
    assert TSP.closure_build_count() == n0 + 2


@pytest.mark.parametrize("topology,queued", CASES)
def test_route_batch_fwd_matches_reference(topology, queued):
    jnet, jb, tnet, tb = _instance(topology, queued)
    jcl = JSP.closures_for_dedup(jnet, JSP.dedupe_plan(jb))
    tcl = TSP.closures_for_dedup(tnet, TSP.dedupe_plan(tb))
    jc, jt, jbp = JR.route_batch_fwd(jnet, jb, closures=jcl)
    tc, tt, tbp = TR.route_batch_fwd(tnet, tb, closures=tcl)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert tbp.dtype == torch.int32
    np.testing.assert_array_equal(_np(tbp), np.asarray(jbp))
    jr = JR.route_batch(jnet, jb, closures=jcl)
    tr = TR.route_batch(tnet, tb, closures=tcl)
    np.testing.assert_array_equal(tr.assign, np.asarray(jr.assign))
    np.testing.assert_array_equal(_np(tr.cost), np.asarray(jr.cost))
    for j in range(tb.num_jobs):
        np.testing.assert_array_equal(
            TR.assign_from_backpointers(tt[j], tbp[j]), np.asarray(jr.assign[j]))
    single = TR.route_single(tnet, tb.comp[1], tb.data[1], tb.src[1],
                             tb.dst[1], tb.num_layers[1])
    assert float(single.cost) == float(jr.cost[1])
    np.testing.assert_array_equal(single.assign, np.asarray(jr.assign[1]))


@pytest.mark.parametrize("topology,queued", CASES)
def test_commit_paths_and_fixed_cost_match_reference(topology, queued):
    jnet, jb, tnet, tb = _instance(topology, queued)
    jr = JR.route_batch(jnet, jb)
    rng = np.random.default_rng(11)
    for j in range(jb.num_jobs):
        # the DP's own assignment, then one with repeated nodes and moves
        for a in (np.asarray(jr.assign[j]),
                  np.sort(rng.integers(0, jnet.num_nodes, jb.max_layers))
                  .astype(np.int32)):
            jargs = (jb.comp[j], jb.data[j], jb.src[j], jb.dst[j],
                     jb.num_layers[j])
            targs = (tb.comp[j], tb.data[j], tb.src[j], tb.dst[j],
                     tb.num_layers[j])
            jn = JR.commit_assignment(jnet, *jargs, jnp.asarray(a))
            tn = TR.commit_assignment(tnet, *targs, a)
            np.testing.assert_array_equal(_np(tn.q_node), np.asarray(jn.q_node))
            np.testing.assert_array_equal(_np(tn.q_link), np.asarray(jn.q_link))
            assert (TR.extract_paths(tnet, *targs, a)
                    == JR.extract_paths(jnet, *jargs, jnp.asarray(a)))
            got = TR.cost_given_assignment(tnet, *targs, a)
            want = JR.cost_given_assignment(jnet, *jargs, jnp.asarray(a))
            assert got.dtype == np.float32 and got == np.asarray(want)


@pytest.mark.parametrize("topology", ["small", "us"])
def test_reconstruct_path_matches_reference(topology):
    jnet, jb, tnet, tb = _instance(topology, True)
    w = JSP.layer_edge_weights(jnet, jb.data[0])
    t = JSP.transfer_closure(jnet, jb.data[0])
    tw, tt = _np(w), _np(t)
    v = jnet.num_nodes
    starts = np.arange(tw.shape[0]) % v
    ends = (starts * 7 + 3) % v
    got = TSP.reconstruct_path(torch.tensor(tw), torch.tensor(tt),
                               torch.tensor(starts), torch.tensor(ends),
                               max_hops=v).numpy()
    for l in range(tw.shape[0]):
        want = JSP.reconstruct_path(w[l], t[l], jnp.int32(starts[l]),
                                    jnp.int32(ends[l]), max_hops=v)
        np.testing.assert_array_equal(got[l], np.asarray(want))


def test_advance_matches_reference():
    jnet, _, tnet, _ = _instance("us", True)
    topo_j, st_j = jnet.topology, jnet.state
    topo_t, st_t = tnet.topology, tnet.state
    for dt in (0.0, 1e-3, 0.37, 1.5, 40.0):
        jn, tn = JS.advance(topo_j, st_j, dt), TS.advance(topo_t, st_t, dt)
        for name in ("q_node", "q_link", "clock"):
            np.testing.assert_array_equal(_np(getattr(tn, name)),
                                          np.asarray(getattr(jn, name)))
        st_j, st_t = jn, tn
    slow = np.linspace(1.0, 3.0, jnet.num_nodes).astype(np.float32)
    avail = np.arange(jnet.num_nodes) % 5 != 0
    for kw in ({}, {"avail_node": avail}):
        ej = JS.effective_topology(topo_j, slow, **kw)
        et = TS.effective_topology(topo_t, slow, **kw)
        np.testing.assert_array_equal(_np(et.mu_node), np.asarray(ej.mu_node))
        np.testing.assert_array_equal(_np(et.mu_link), np.asarray(ej.mu_link))
    assert (TS.backlog_seconds(topo_t, st_t)
            == JS.backlog_seconds(topo_j, st_j))
    assert TS.total_backlog(st_t) == JS.total_backlog(st_j)


def _round_f32(exact: Fraction) -> np.float32:
    """Correctly rounded (nearest, ties to even) float32 of a rational."""
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - exact),
                                     int(np.float32(y).view(np.uint32)) & 1))


def test_fma_f32_rounds_once():
    """``fma_f32`` equals exact rational a*b + c rounded once to float32,
    including a sum whose float64 rounding lands on a float32 midpoint,
    where rounding twice goes the wrong way."""
    rng = np.random.default_rng(0)
    n = 400
    a = rng.uniform(-4, 4, n).astype(np.float32)
    b = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-40, 40, n)) \
        .astype(np.float32)
    c = (rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-40, 40, n)) \
        .astype(np.float32)
    # (1 + 2^-15) * -(1 - 2^-15) 2^-24 + (1 + 2^-23) is exactly
    # 1 + 2^-24 + 2^-54: float64 rounds it onto the float32 midpoint
    # 1 + 2^-24, and rounding that again goes to even (1.0) instead of up
    a[:4] = np.float32(1 + 2.0 ** -15)
    b[:4] = np.float32(-(1 - 2.0 ** -15) * 2.0 ** -24)
    c[:4] = np.float32(1 + 2.0 ** -23)
    twice = np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))
    assert twice == np.float32(1.0)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for i in range(n):
        exact = (Fraction(float(a[i])) * Fraction(float(b[i]))
                 + Fraction(float(c[i])))
        assert got[i] == _round_f32(exact), i
