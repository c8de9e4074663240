"""Explicit layered-graph construction and the ILP matrices of §III-B.

Counterpart of ``repro.core.layered_graph``: host-side numpy, the same
matrices as the reference's (``np.array_equal``).

The routing DP never materializes the layered graph (it works on per-layer
closures), but the explicit construction is needed to (a) state the ILP
(1)-(5) in matrix form [A1; A2] and test Theorem 1's total-unimodularity
claim, and (b) cross-check the DP against path enumeration on tiny graphs.

Variable order matches Appendix A: y = [z (|V|); r_cross (L*|V|);
r_intra ((L+1)*|E_dir|)].
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .network import ComputeNetwork, edge_list


@dataclasses.dataclass(frozen=True)
class LayeredILP:
    a1: np.ndarray       # [L*V, n_y]   constraint (2):  r_cross - z <= 0
    a2: np.ndarray       # [(L+1)*V, n_y] flow conservation (3)
    b2: np.ndarray       # [(L+1)*V]
    c: np.ndarray        # [n_y] objective coefficients (1)
    num_nodes: int
    num_layers: int
    edges: list[tuple[int, int]]

    @property
    def n_z(self) -> int:
        return self.num_nodes

    @property
    def n_cross(self) -> int:
        return self.num_layers * self.num_nodes

    def cross_var(self, u: int, l: int) -> int:
        """Index of r_{u_{l-1} u_l}, l in 1..L."""
        return self.n_z + (l - 1) * self.num_nodes + u

    def intra_var(self, e: int, l: int) -> int:
        """Index of r_{(u_l, v_l)} for directed edge e, l in 0..L."""
        return self.n_z + self.n_cross + l * len(self.edges) + e


def build_ilp(net: ComputeNetwork, num_layers: int, src: int, dst: int,
              comp: np.ndarray, data: np.ndarray) -> LayeredILP:
    v = net.num_nodes
    L = num_layers
    edges = edge_list(net)
    E = len(edges)
    n_y = v + L * v + (L + 1) * E

    mu_n, mu_l, q_n, q_l = (x.cpu().numpy().astype(np.float64) for x in (
        net.mu_node, net.mu_link, net.q_node, net.q_link))

    ilp = LayeredILP(a1=np.zeros((L * v, n_y)), a2=np.zeros(((L + 1) * v, n_y)),
                     b2=np.zeros(((L + 1) * v,)), c=np.zeros((n_y,)),
                     num_nodes=v, num_layers=L, edges=edges)

    # --- constraint (2): r_{u_{l-1}u_l} - z_u <= 0, grouped per node (Fig. 6)
    row = 0
    for u in range(v):
        for l in range(1, L + 1):
            ilp.a1[row, ilp.cross_var(u, l)] = 1.0
            ilp.a1[row, u] = -1.0
            row += 1

    # --- constraint (3): flow conservation at u_l, rows ordered u0..uL per node
    def fc_row(u: int, l: int) -> int:
        return u * (L + 1) + l

    for e, (a, b) in enumerate(edges):
        for l in range(L + 1):
            ilp.a2[fc_row(a, l), ilp.intra_var(e, l)] += 1.0   # out of a_l
            ilp.a2[fc_row(b, l), ilp.intra_var(e, l)] -= 1.0   # into b_l
    for u in range(v):
        for l in range(1, L + 1):
            ilp.a2[fc_row(u, l - 1), ilp.cross_var(u, l)] += 1.0  # out of u_{l-1}
            ilp.a2[fc_row(u, l), ilp.cross_var(u, l)] -= 1.0      # into u_l
    ilp.b2[fc_row(src, 0)] = 1.0
    ilp.b2[fc_row(dst, L)] = -1.0

    # --- objective (1)
    big = 1e30
    for u in range(v):
        ilp.c[u] = q_n[u] / mu_n[u] if mu_n[u] > 0 else 0.0  # z term
    for u in range(v):
        for l in range(1, L + 1):
            ilp.c[ilp.cross_var(u, l)] = (
                comp[l - 1] / mu_n[u] if mu_n[u] > 0 else big)
    for e, (a, b) in enumerate(edges):
        for l in range(L + 1):
            ilp.c[ilp.intra_var(e, l)] = (data[l] + q_l[a, b]) / mu_l[a, b]
    return ilp


def random_square_submatrix_dets(mat: np.ndarray, trials: int, max_k: int,
                                 seed: int = 0) -> np.ndarray:
    """Determinants of random square submatrices (TU spot-check, Thm 1)."""
    rng = np.random.default_rng(seed)
    m, n = mat.shape
    out = np.zeros((trials,))
    for i in range(trials):
        k = int(rng.integers(1, min(max_k, m, n) + 1))
        rows = rng.choice(m, size=k, replace=False)
        cols = rng.choice(n, size=k, replace=False)
        out[i] = np.linalg.det(mat[np.ix_(rows, cols)])
    return out
