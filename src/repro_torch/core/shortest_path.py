"""Shortest-path machinery on the physical network, per DNN layer.

Counterpart of ``repro.core.shortest_path``.  For layer l, every intra-layer
edge (u, v) of the layered graph costs

    w_l(u, v) = (d_l + Q_uv) / mu_uv        (service + waiting, paper §III-B)

and T_l = closure(w_l) is the min-plus closure: T[l, u, v] is the cheapest
way to move layer-l output from u to v.  The closures are the kernel
hot-spot (:mod:`repro_torch.kernels.minplus`).

:class:`Closures` bundles (w, T) for one queue state so the stack is built
once and shared by routing, commit, cost evaluation and path extraction.
``build_closures``/``build_closures_batch`` are the counted builders (the
greedy solvers call one per round); ``closures_for``/``closures_for_dedup``
are the uncounted pure builders.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from .network import INF, ComputeNetwork, link_invrate


@dataclasses.dataclass(frozen=True)
class Closures:
    """Per-layer edge weights and their min-plus closures for one queue state.

    ``w``/``t`` are [Lmax+1, V, V] for one data-size vector, or carry a
    leading [J] axis when built for a batch.  ``w`` may be ``None``: it is
    elementwise-cheap to recompute from (net, data), so batch-stacked
    closures omit it and consumers rebuild it from the job's data.
    """

    w: torch.Tensor | None  # layer edge weights w_l(u, v), or None
    t: torch.Tensor         # min-plus closure T_l = closure(w_l)

    def job(self, j: int) -> "Closures":
        """Slice one job's closures out of a batch-stacked artifact."""
        return Closures(w=None if self.w is None else self.w[j], t=self.t[j])


_n_builds = 0


def closure_build_count() -> int:
    """Counted closure builds since the last reset (one per
    ``build_closures``/``build_closures_batch`` call)."""
    return _n_builds


def reset_closure_build_count() -> None:
    global _n_builds
    _n_builds = 0


def layer_edge_weights(net: ComputeNetwork,
                       data_sizes: torch.Tensor) -> torch.Tensor:
    """[..., L+1, V, V] per-layer intra-layer edge weights.

    data_sizes: [..., L+1] bytes (d_0 .. d_L; leading batch dims allowed).
    Absent edges get INF; the diagonal is 0 (staying put is free).

    The paper's literal form (d_l + Q_uv) * inv_uv: the multiply is the
    last rounding, so there is no multiply feeding an add that a compiler
    could contract into an FMA, and the weights equal the reference's bit
    for bit on every device.
    """
    inv = link_invrate(net)
    w = (data_sizes[..., :, None, None] + net.q_link) * inv
    return torch.clamp(w, max=INF)


def closures_for(net: ComputeNetwork, data_sizes: torch.Tensor) -> Closures:
    """Uncounted :class:`Closures` builder."""
    w = layer_edge_weights(net, data_sizes)
    return Closures(w=w, t=ops.minplus_closure(w))


def build_closures(net: ComputeNetwork, data_sizes: torch.Tensor) -> Closures:
    """Counted :class:`Closures` build for one data-size vector."""
    global _n_builds
    _n_builds += 1
    return closures_for(net, data_sizes)


def dedupe_data(batch) -> tuple[torch.Tensor, torch.Tensor]:
    """(unique [U, Lmax+1] data rows, [J] int32 inverse index), on the
    batch's device.  Queue-state independent, so solvers hoist it."""
    data = batch.data.cpu().numpy()
    uniq, inv = np.unique(data, axis=0, return_inverse=True)
    dev = batch.device
    return (torch.from_numpy(uniq).to(dev),
            torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(dev))


@dataclasses.dataclass(frozen=True)
class DedupePlan:
    """Two-level dedupe structure for one job batch.

    Row level: ``uniq [U, Lmax+1]`` unique data rows with ``inv [J]``
    mapping jobs back (exactly :func:`dedupe_data`).  Scalar level: w_l
    depends on the data-size *scalar* d_l only, so (row, layer) slots
    sharing a d value have bitwise-identical weight matrices and closures
    under every queue state.  ``d_vals [D]`` are the unique scalars and
    ``d_idx [U, Lmax+1]`` gathers them back, so a round closes [D, V, V]
    matrices instead of [U, Lmax+1, V, V].
    """

    uniq: torch.Tensor    # [U, Lmax+1] unique data rows
    inv: torch.Tensor     # [J] int32: job -> row in uniq
    d_vals: torch.Tensor  # [D] unique data-size scalars
    d_idx: torch.Tensor   # [U, Lmax+1] int32: (row, layer) -> slot in d_vals


def dedupe_plan(batch) -> DedupePlan:
    """Build the two-level :class:`DedupePlan` for a job batch (host-level)."""
    uniq, inv = dedupe_data(batch)
    uniq_h = uniq.cpu().numpy()
    d_vals, d_idx = np.unique(uniq_h, return_inverse=True)
    dev = batch.device
    return DedupePlan(
        uniq=uniq, inv=inv, d_vals=torch.from_numpy(d_vals).to(dev),
        d_idx=torch.from_numpy(
            d_idx.reshape(uniq_h.shape).astype(np.int32)).to(dev))


def closures_for_dedup(net: ComputeNetwork, plan: DedupePlan) -> Closures:
    """Uncounted batch-stacked closure build through a :class:`DedupePlan`.

    Closes the [D, V, V] unique-scalar stack (on CUDA one launch of the
    closure kernel for V <= 32, else one product launch per squaring) and
    gathers back to [J, Lmax+1, V, V]; each matrix's closure
    is computed independently, so the gathered stack is bitwise identical
    to closing every job's stack on its own.  ``w`` is dropped.
    """
    t_d = ops.minplus_closure(layer_edge_weights(net, plan.d_vals))
    t_u = t_d[plan.d_idx.long()]                      # [U, Lmax+1, V, V]
    return Closures(w=None, t=t_u[plan.inv.long()])   # [J, ...]


def build_closures_batch(net: ComputeNetwork, batch, *,
                         dplan: DedupePlan | None = None) -> Closures:
    """Counted [J, Lmax+1, V, V] :class:`Closures` for a job batch.

    Jobs and layers sharing a data size share one closure computation
    (:func:`closures_for_dedup`).  ``dplan`` takes a precomputed
    :func:`dedupe_plan` (queue-state independent, so round loops hoist it).
    """
    global _n_builds
    _n_builds += 1
    return closures_for_dedup(net, dedupe_plan(batch) if dplan is None
                              else dplan)


def transfer_closure(net: ComputeNetwork,
                     data_sizes: torch.Tensor) -> torch.Tensor:
    """[L+1, V, V] min-cost transfer tensor T_l = closure(w_l)."""
    return closures_for(net, data_sizes).t


def reconstruct_path(w: torch.Tensor, t: torch.Tensor, src: torch.Tensor,
                     dst: torch.Tensor, max_hops: int) -> torch.Tensor:
    """Explicit paths from src to dst under edge weights w and closure t.

    ``w``/``t`` are [..., V, V] with matching ``src``/``dst`` [...] (the
    reference vmaps its single-path form; here the batch is written out).
    Returns hops [..., max_hops, 2] int32 (u, v) pairs, padded with
    (-1, -1) once dst is reached.  From ``cur`` the next hop is
    argmin_w w[cur, w] + t[w, dst], excluding the zero-cost self-loop;
    argmin takes the first index on ties, as the reference's does.
    """
    lead = w.shape[:-2]
    v = w.shape[-1]
    w2 = w.reshape(-1, v, v)
    t2 = t.reshape(-1, v, v)
    rows = torch.arange(w2.shape[0], device=w.device)
    cur = src.reshape(-1).long()
    end = dst.reshape(-1).long()
    to_end = t2[rows, :, end]                          # [P, V] t[:, dst]
    done = torch.zeros_like(cur, dtype=torch.bool)
    hops = []
    for _ in range(max_hops):
        cand = w2[rows, cur] + to_end
        cand[rows, cur] = INF
        nxt = torch.argmin(cand, dim=1)
        dead = done | (cur == end)
        hops.append(torch.stack([torch.where(dead, -1, cur),
                                 torch.where(dead, -1, nxt)], dim=-1))
        cur = torch.where(dead, cur, nxt)
        done = dead
    return torch.stack(hops, dim=-2).to(torch.int32).reshape(
        lead + (max_hops, 2))
