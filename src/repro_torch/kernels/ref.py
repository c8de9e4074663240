"""Plain PyTorch versions of the port's CUDA kernels.

Counterpart of ``repro.kernels.ref``.  These are the semantic references the
CUDA kernels (:mod:`repro_torch.kernels.minplus`,
:mod:`repro_torch.kernels.flash`) are held against on the card, and the
path a CPU tensor takes.

Min-plus: each candidate ``a + b`` is one rounded float32 add and ``min``
is exact, so any correct kernel equals these bit for bit.  Flash
attention: the plain version repeats the kernel's arithmetic (float32
scores and probabilities, the reference kernel's ``-1e30`` mask and
``1e-30`` floor), not a bit-exact order of summation, so the kernel is
held to it by a tolerance.
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


NEG_INF = -1e30  # the flash kernels' mask value (repro.kernels.flash.NEG_INF)


def flash_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float, causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(O, logsumexp) of ``softmax(scale * q k^T) v`` on [BH, S, d] q/k and
    [BH, S, dv] v, in the flash kernel's arithmetic: operands upcast to
    float32, masked scores set to -1e30, probabilities never rounded to
    the input type, O = (p v) / max(l, 1e-30) cast to q's dtype and
    lse = m + log(max(l, 1e-30)) in float32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(q.shape[-2], device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.matmul(p, vf) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True) -> torch.Tensor:
    """O of :func:`flash_fwd_lse_ref` (no logsumexp)."""
    return flash_fwd_lse_ref(q, k, v, scale=scale, causal=causal)[0]
