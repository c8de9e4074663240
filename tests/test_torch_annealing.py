"""Algorithm 2 in the port (``repro_torch.core.annealing``) against the JAX
reference on the CPU.

``evaluate_solution`` must equal the reference's bit for bit.  The
reference draws from ``jax.random`` (threefry), so the whole-run test
builds the reference's own draws -- splitting keys exactly as
``repro.core.annealing.anneal`` and ``_anneal_chain`` do -- into a
:class:`~repro_torch.core.annealing.DrawTape` and hands it to the port:
assignments, order, bounds, ``meta["history"]`` and ``chain_cost`` must
then be equal, which holds only if every Metropolis decision of every
chain was the same.  On torch's own generator the test holds the plan's
validity and its bound against the simulated makespan."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common  # noqa: E402
from repro.core import annealing as JA, jobs as JJ  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import annealing as TA, solve as tsolve  # noqa: E402
from repro_torch.core import shortest_path as SP  # noqa: E402
from util import random_instance  # noqa: E402


def _port(net, batch):
    tnet = interop.network_from_numpy(
        *(np.asarray(x) for x in (net.mu_node, net.mu_link, net.q_node,
                                  net.q_link, net.clock)), device="cpu")
    tbatch = interop.batch_from_numpy(
        *(np.asarray(x) for x in (batch.src, batch.dst, batch.comp,
                                  batch.data, batch.num_layers)),
        device="cpu")
    return tnet, tbatch


@functools.lru_cache(maxsize=None)
def _instance(name):
    """(reference net, batch, port net, batch): the quickstart instance
    (paper-small: the 5-node topology, 2 VGG19 + 6 ResNet34) or a random
    6-node mesh with 4 jobs, fresh or at a queued state."""
    if name.startswith("paper-small"):
        net, batch = common.quickstart_instance()
    else:
        net, jobs = random_instance(np.random.default_rng(21), num_jobs=4)
        batch = JJ.batch_jobs(jobs)
    if name.endswith("queued"):
        rng = np.random.default_rng(3)
        mu_n, mu_l = np.asarray(net.mu_node), np.asarray(net.mu_link)
        qn = (rng.uniform(0, 1, mu_n.shape) * mu_n).astype(np.float32)
        ql = (rng.uniform(0, 1, mu_l.shape) * mu_l).astype(np.float32)
        net = net.with_queues(jnp.asarray(qn), jnp.asarray(ql))
    return (net, batch) + _port(net, batch)


def reference_tape(batch, n_comp, *, seed, num_chains, iters):
    """The reference's draws for ``anneal(seed=, num_chains=)``: the same
    key splits as ``anneal`` (one key per chain) and ``_anneal_chain``
    (init / tape, per iteration six keys)."""
    J, lmax, nl = batch.num_jobs, batch.max_layers, batch.num_layers

    def one(k):
        kj, kl, kw, ks, ku, kb = jax.random.split(k, 6)
        j = jax.random.randint(kj, (), 0, J)
        return (j, jax.random.randint(kl, (), 0, jnp.maximum(nl[j], 1)),
                jax.random.randint(kw, (), 0, n_comp),
                jax.random.randint(ks, (2,), 0, J),
                jax.random.uniform(kb), jax.random.uniform(ku))

    fields = {k: [] for k in ("init_idx", "init_perm", "j", "l", "w_idx",
                              "p12", "u_block", "u_accept")}
    for key in jax.random.split(jax.random.PRNGKey(seed), num_chains):
        k_init, k_tape = jax.random.split(key)
        ka, kp = jax.random.split(k_init)
        fields["init_idx"].append(jax.random.randint(ka, (J, lmax), 0,
                                                     n_comp))
        fields["init_perm"].append(jax.random.permutation(
            kp, jnp.arange(J, dtype=jnp.int32)))
        draws = jax.vmap(one)(jax.random.split(k_tape, iters))
        for name, x in zip(("j", "l", "w_idx", "p12", "u_block", "u_accept"),
                           draws):
            fields[name].append(x)
    return TA.DrawTape(**{k: np.stack([np.asarray(x) for x in v])
                          for k, v in fields.items()})


def _comp_nodes(net):
    return np.nonzero(np.asarray(net.mu_node) > 0)[0]


@pytest.mark.parametrize("name", ["paper-small", "paper-small-queued",
                                  "mesh", "mesh-queued"])
def test_evaluate_solution_bitwise(name):
    net, batch, tnet, tbatch = _instance(name)
    rng = np.random.default_rng(4)
    nodes = _comp_nodes(net)
    for _ in range(4):
        assign = rng.choice(nodes, (batch.num_jobs, batch.max_layers))
        prio = rng.permutation(batch.num_jobs)
        want = JA.evaluate_solution(net, batch, jnp.asarray(assign, jnp.int32),
                                    jnp.asarray(prio, jnp.int32))
        got = TA.evaluate_solution(tnet, tbatch, assign, prio)
        assert isinstance(got, np.float32)
        assert got == np.float32(want), (got, want)


@pytest.mark.parametrize("t0,t_lim,d", [(1.0, 1e-3, 0.9), (1.0, 1e-3, 0.995),
                                        (2.0, 1e-2, 0.97), (1.0, 0.5, 0.1)])
def test_num_iters_equals_reference(t0, t_lim, d):
    assert TA._num_iters(t0, t_lim, d) == JA._num_iters(t0, t_lim, d)


def check_run_on_reference_tape(num_chains, init, block_move_prob):
    """The port's SA on the reference's draws equals the reference's run:
    assignments, order, bounds, history, chain cost, paths and queues."""
    # paper-small (8 jobs, 34 layers) for two single-chain runs, the
    # queued 4-job mesh for the rest (the reference compiles each case)
    name = ("paper-small" if num_chains == 1 and
            (init, block_move_prob) in (("random", 0.0), ("greedy", 0.3))
            else "mesh-queued")
    net, batch, tnet, tbatch = _instance(name)
    opts = dict(seed=num_chains, d=0.9, num_chains=num_chains, init=init,
                block_move_prob=block_move_prob)
    want = JA.anneal(net, batch, **opts)
    tape = reference_tape(batch, len(_comp_nodes(net)), seed=opts["seed"],
                          num_chains=num_chains,
                          iters=JA._num_iters(1.0, 1e-3, 0.9))
    got = tsolve(tnet, tbatch, method="sa", tape=tape, **opts)
    assert got.order.tolist() == want.order.tolist()
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.bounds.tolist() == want.bounds.tolist()
    hist = got.meta["history"]
    assert hist.dtype == np.float32
    assert hist.tolist() == np.asarray(want.meta["history"]).tolist()
    for key in ("chain_cost", "iters", "num_chains", "n_routings"):
        assert got.meta[key] == want.meta[key], key
    assert got.paths == want.paths
    for f in ("q_node", "q_link"):
        np.testing.assert_array_equal(getattr(got.net, f).numpy(),
                                      np.asarray(getattr(want.net, f)))


@pytest.mark.parametrize("block_move_prob", [0.0, 0.3])
@pytest.mark.parametrize("init", ["random", "greedy"])
def test_anneal_on_reference_tape_equals_reference(init, block_move_prob):
    """One chain (four chains: ``test_torch_annealing_chains.py``)."""
    check_run_on_reference_tape(1, init, block_move_prob)


def test_closure_builds_follow_the_formula(monkeypatch):
    """K x (iters + 1) x J closure stacks for the chains' evaluations and J
    for the replay (on the card one closure-kernel launch each)."""
    _, batch, tnet, tbatch = _instance("mesh")
    calls = []
    real = TA.closures_for
    monkeypatch.setattr(TA, "closures_for",
                        lambda *a: calls.append(1) or real(*a))
    n0 = SP.closure_build_count()
    plan = TA.anneal(tnet, tbatch, seed=0, d=0.8, num_chains=2)
    iters, J = TA._num_iters(1.0, 1e-3, 0.8), batch.num_jobs
    assert len(calls) == 2 * (iters + 1) * J
    assert SP.closure_build_count() - n0 == J
    assert plan.meta["n_routings"] == 2 * iters


@pytest.mark.parametrize("init", ["random", "greedy"])
def test_torch_generator_plan_is_valid(init):
    """On torch's own draws: a valid plan whose bound dominates the
    simulated makespan, a non-increasing history, the same plan from the
    same seed, and a tape of the wrong size refused."""
    _, batch, tnet, tbatch = _instance("mesh")
    opts = dict(seed=5, d=0.9, num_chains=2, init=init, block_move_prob=0.3)
    plan = tsolve(tnet, tbatch, method="sa", **opts)
    nodes = set(np.nonzero(tnet.mu_node.numpy() > 0)[0].tolist())
    nl = tbatch.num_layers.numpy()
    for j in range(batch.num_jobs):
        assert set(plan.assign[j, :nl[j]].tolist()) <= nodes
    assert sorted(plan.order.tolist()) == list(range(batch.num_jobs))
    hist = plan.meta["history"]
    assert np.all(np.diff(hist) <= 0)
    assert plan.meta["chain_cost"] == float(hist[-1])
    assert plan.bound() == plan.meta["chain_cost"]   # the replay's max
    sim = plan.simulate(tnet, tbatch)
    assert sim.makespan <= plan.bound() * (1 + 1e-5)
    again = tsolve(tnet, tbatch, method="sa", **opts)
    assert again.bounds.tolist() == plan.bounds.tolist()
    with pytest.raises(ValueError, match="tape holds"):
        TA.anneal(tnet, tbatch, d=0.9, num_chains=1, tape=TA.draw_tape(
            nl, len(nodes), batch.max_layers, seed=0, num_chains=1,
            iters=3))
