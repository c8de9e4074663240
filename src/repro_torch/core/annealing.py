"""Algorithm 2: simulated annealing over (node assignment, job priority).

Counterpart of ``repro.core.annealing``.  Faithful to the paper: odd
iterations re-assign a random layer of a random job to a random
compute-capable node; even iterations swap two priorities; Metropolis
acceptance with temperature T <- T * d until T_lim.

The completion-time evaluator replays jobs in priority order against the
fictitious-system queues, exactly like the greedy commit path, with
transfers taking min-cost paths under the current queues: per job one
closure stack (on the card one launch of the closure kernel for V <= 32)
shared by the cost and the commit.

The draws.  The reference draws from ``jax.random`` (threefry), which
PyTorch does not reproduce, so every draw of a run lives on a
:class:`DrawTape`: per chain the initial assignment and priorities, per
iteration the move's job, layer, node, swapped slots and two uniforms.
A tape depends on the batch's layer counts and the number of compute
nodes only, never on a chain's state, so a caller can build one from any
generator -- the parity tests build the reference's own -- and pass it as
``tape=``; without one, :func:`draw_tape` draws from a ``torch.Generator``
seeded with ``seed``.

Where the work runs.  The reference vmaps K chains over one jitted scan;
here the chains run one after another, each iteration one evaluation on
the network's device.  The Metropolis test runs on the host in float32
(the reference's dtype for the costs, the temperature and the uniforms),
so a run on the card and a run on the CPU take the same decisions.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .network import ComputeNetwork
from .jobs import JobBatch
from .plan import Plan
from . import routing
from .shortest_path import closures_for

# Deprecated alias, as in the reference: anneal returns the canonical Plan.
SAResult = Plan


@dataclasses.dataclass(frozen=True)
class DrawTape:
    """Every random draw of an annealing run of K chains x T iterations.

    Node draws are indices into the compute-capable nodes (ascending node
    ids); ``l`` lies below ``max(num_layers[j], 1)`` of its iteration's
    ``j``.  The initial fields are unused when ``init="greedy"``.
    """

    init_idx: np.ndarray   # [K, J, Lmax] initial assignment (node indices)
    init_perm: np.ndarray  # [K, J] initial priority vector (slot -> job)
    j: np.ndarray          # [K, T] job of the odd move
    l: np.ndarray          # [K, T] layer of the odd move
    w_idx: np.ndarray      # [K, T] node index of the odd move
    p12: np.ndarray        # [K, T, 2] slots the even move swaps
    u_block: np.ndarray    # [K, T] float32: whole-job move if < block_move_prob
    u_accept: np.ndarray   # [K, T] float32: Metropolis uniform

    @property
    def num_chains(self) -> int:
        return self.j.shape[0]

    @property
    def iters(self) -> int:
        return self.j.shape[1]


def draw_tape(num_layers, num_comp: int, max_layers: int, *, seed: int,
              num_chains: int, iters: int) -> DrawTape:
    """A :class:`DrawTape` from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same tape on every device)."""
    g = torch.Generator().manual_seed(seed)
    nl = np.maximum(np.asarray(num_layers, np.int64), 1)
    k, t, n_jobs = num_chains, iters, nl.shape[0]

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=g).numpy()

    init_idx = ints(num_comp, (k, n_jobs, max_layers))
    init_perm = np.stack([torch.randperm(n_jobs, generator=g).numpy()
                          for _ in range(k)])
    j = ints(n_jobs, (k, t))
    u_l = torch.rand((k, t), dtype=torch.float64, generator=g).numpy()
    l = np.floor(u_l * nl[j]).astype(np.int64)
    return DrawTape(init_idx=init_idx, init_perm=init_perm, j=j, l=l,
                    w_idx=ints(num_comp, (k, t)), p12=ints(n_jobs, (k, t, 2)),
                    u_block=torch.rand((k, t), generator=g).numpy(),
                    u_accept=torch.rand((k, t), generator=g).numpy())


def _evaluate(net: ComputeNetwork, batch: JobBatch, host: dict,
              assign: np.ndarray, prio: np.ndarray) -> np.float32:
    cur = net
    worst = None
    for p in range(batch.num_jobs):
        j = int(prio[p])
        args = (host["comp"][j], batch.data[j], host["src"][j],
                host["dst"][j], host["num_layers"][j], assign[j])
        cl = closures_for(cur, batch.data[j])
        cost = routing.cost_given_assignment(cur, *args, closures=cl)
        cur = routing.commit_assignment(cur, *args, closures=cl)
        worst = cost if worst is None else max(worst, cost)
    return np.float32(worst)


def evaluate_solution(net: ComputeNetwork, batch: JobBatch, assign,
                      prio) -> np.float32:
    """Fictitious-system makespan bound of a full solution (float32).

    Each replay step builds the job's closure stack once and shares it
    between the cost evaluation and the queue commit.  ``prio`` is slot ->
    job.
    """
    return _evaluate(net, batch, batch.to_numpy(),
                     np.asarray(assign, np.int32), np.asarray(prio))


def _num_iters(t0: float, t_lim: float, d: float) -> int:
    return max(1, int(math.ceil(math.log(t_lim / t0) / math.log(d))))


def _anneal_chain(net: ComputeNetwork, batch: JobBatch, host: dict,
                  comp_nodes: np.ndarray, tape: DrawTape, c: int, t0: float,
                  d: float, init_assign, init_prio, *, k_boltz: float,
                  block_move_prob: float):
    """One chain on tape row ``c``: (best assign, best prio, best cost,
    [T] float32 history of the best cost)."""
    if init_assign is None:
        assign = comp_nodes[tape.init_idx[c]].astype(np.int32)
    else:
        assign = np.array(init_assign, np.int32)
    prio = (np.array(tape.init_perm[c], np.int32) if init_prio is None
            else np.array(init_prio, np.int32))
    cost = _evaluate(net, batch, host, assign, prio)
    best_a, best_p, best_c = assign, prio, cost
    temp, d32 = np.float32(t0), np.float32(d)
    kb, bmp = np.float32(k_boltz), np.float32(block_move_prob)
    hist = np.empty((tape.iters,), np.float32)
    for it in range(tape.iters):
        if it % 2 == 0:    # the first iteration is the paper's "odd" move
            j, w = tape.j[c, it], comp_nodes[tape.w_idx[c, it]]
            cand_a, cand_p = assign.copy(), prio
            if tape.u_block[c, it] < bmp:
                cand_a[j] = w
            else:
                cand_a[j, tape.l[c, it]] = w
        else:
            p0, p1 = tape.p12[c, it]
            cand_a, cand_p = assign, prio.copy()
            cand_p[p0], cand_p[p1] = prio[p1], prio[p0]
        cand_c = _evaluate(net, batch, host, cand_a, cand_p)
        with np.errstate(over="ignore"):
            ratio = np.exp((cost - cand_c) / (kb * temp))
        if tape.u_accept[c, it] < min(np.float32(1.0), ratio):
            assign, prio, cost = cand_a, cand_p, cand_c
        if cost < best_c:
            best_a, best_p, best_c = assign, prio, cost
        hist[it] = best_c
        temp = temp * d32
    return best_a, best_p, best_c, hist


def anneal(net: ComputeNetwork, batch: JobBatch, *, seed: int = 0,
           t0: float = 1.0, t_lim: float = 1e-3, d: float = 0.995,
           k_boltz: float = 1.0, num_chains: int = 1,
           init: str = "random", block_move_prob: float = 0.0,
           tape: DrawTape | None = None) -> Plan:
    """Run Algorithm 2.

    Defaults are paper-faithful.  Beyond-paper knobs, as in the reference:
    ``num_chains`` (independent multi-start chains, the best one wins),
    ``init='greedy'`` (warm start from Algorithm 1 -- SA then only
    refines) and ``block_move_prob`` (whole-job moves).  ``tape`` supplies
    every draw (:class:`DrawTape`); without it :func:`draw_tape` draws
    from ``seed``.

    Closure launches on the card: ``num_chains * (iters + 1) * J`` for the
    chains' evaluations, ``J`` for the winning chain's replay, and the
    greedy solve's own when ``init='greedy'``.
    """
    from . import greedy, schedule

    iters = _num_iters(t0, t_lim, d)
    comp_nodes = np.nonzero(net.mu_node.cpu().numpy() > 0)[0].astype(np.int32)
    host = batch.to_numpy()
    if tape is None:
        tape = draw_tape(host["num_layers"], comp_nodes.shape[0],
                         batch.max_layers, seed=seed, num_chains=num_chains,
                         iters=iters)
    if (tape.num_chains, tape.iters) != (num_chains, iters):
        raise ValueError(f"tape holds {tape.num_chains} chains x "
                         f"{tape.iters} iterations; the run needs "
                         f"{num_chains} x {iters}")
    init_assign = init_prio = None
    if init == "greedy":
        sol = greedy.greedy_route(net, batch)
        init_assign, init_prio = sol.assign, sol.order
    elif init != "random":
        raise ValueError(f"init must be 'random' or 'greedy', got {init!r}")
    runs = [_anneal_chain(net, batch, host, comp_nodes, tape, c, t0, d,
                          init_assign, init_prio, k_boltz=k_boltz,
                          block_move_prob=block_move_prob)
            for c in range(num_chains)]
    best_c = np.array([r[2] for r in runs], np.float32)
    i = int(np.argmin(best_c))
    assign, order = runs[i][0], runs[i][1]  # SA's "priority" is slot -> job
    # Replay the winning chain to recover per-job bounds, explicit transfer
    # paths, and the final queue state (the chain cost is only the max).
    bounds, paths, final = schedule.replay_solution(net, batch, assign, order)
    hist = np.stack([r[3] for r in runs])
    return Plan.from_order(
        assign, order, bounds, solver="sa", paths=paths, net=final,
        meta={"history": np.min(hist, axis=0), "iters": iters,
              "num_chains": num_chains, "chain_cost": float(best_c[i]),
              "n_routings": int(iters) * int(num_chains)})
