"""Plain PyTorch versions of the tropical (min, +) kernels.

Counterpart of ``repro.kernels.ref``.  These are the semantic references the
CUDA kernel (:mod:`repro_torch.kernels.minplus`) is held against on the
card, and the path a CPU tensor takes.  Each candidate ``a + b`` is one
rounded float32 add and ``min`` is exact, so any correct kernel equals these
bit for bit.
"""
from __future__ import annotations

import math

import torch


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = min_k A[i, k] + B[k, j]   (tropical semiring matmul).

    Supports leading batch dims on both operands (broadcast like matmul).
    """
    return torch.amin(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def minplus_matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[i] = min_k A[i, k] + x[k]."""
    return torch.amin(a + x[..., None, :], dim=-1)


def force_zero_diagonal(w: torch.Tensor) -> torch.Tensor:
    """Copy of ``w`` with ``d[..., u, u] = min(w[..., u, u], 0)``
    (``w.at[..., eye, eye].min(0.0)`` in the reference)."""
    d = w.clone()
    diag = d.diagonal(dim1=-2, dim2=-1)
    diag.copy_(torch.clamp(diag, max=0.0))
    return d


def minplus_closure_ref(w: torch.Tensor, *, num_nodes: int | None = None
                        ) -> torch.Tensor:
    """All-pairs shortest path distances: the reflexive-transitive min-plus
    closure of the edge-weight matrix ``w`` (repeated tropical squaring).

    ``w[i, j]`` is the direct edge weight (a large finite INF when absent).
    The diagonal is forced to 0 before squaring.
    """
    n = w.shape[-1] if num_nodes is None else num_nodes
    d = force_zero_diagonal(w)
    steps = max(1, math.ceil(math.log2(max(n - 1, 2))))
    for _ in range(steps):
        d = minplus_matmul_ref(d, d)
    return d
