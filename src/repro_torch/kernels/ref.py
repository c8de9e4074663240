"""Plain PyTorch versions of the port's CUDA kernels.

Counterpart of ``repro.kernels.ref``.  These are the semantic references the
CUDA kernels (:mod:`repro_torch.kernels.minplus`,
:mod:`repro_torch.kernels.flash`, forward and backward) are held against
on the card, and the path a CPU tensor takes.

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


def minplus_closure_ref(w: torch.Tensor, *, num_nodes: int | None = None,
                        steps: int | None = None) -> torch.Tensor:
    """All-pairs shortest path distances: the reflexive-transitive min-plus
    closure of the edge-weight matrix ``w`` (repeated tropical squaring).

    ``w[i, j]`` is the direct edge weight (a large finite INF when absent).
    The diagonal is forced to 0 before squaring.  ``steps`` squarings, by
    default the reference's ``ceil(log2(n - 1))``.
    """
    n = w.shape[-1] if num_nodes is None else num_nodes
    d = force_zero_diagonal(w)
    if steps is None:
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


def _bwd_probs(q, k, v, do, lse, delta, scale, causal):
    """float32 (q, k, do, p, ds) of the backward kernels: ``p = exp(scale *
    q k^T - lse)`` with masked scores at -1e30, ``ds = p * (do v^T -
    delta) * scale``."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        pos = torch.arange(q.shape[-2], device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    return qf, kf, dof, p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_ref(q, k, v, do, lse, delta, *, scale: float,
                     causal: bool = True) -> torch.Tensor:
    """dq = ds k, cast to q's dtype (the dq kernel's function)."""
    _, kf, _, _, ds = _bwd_probs(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, kf).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, *, scale: float,
                      causal: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk = ds^T q, dv = p^T do), cast to q's dtype (the dk/dv kernel's
    function)."""
    qf, _, dof, p, ds = _bwd_probs(q, k, v, do, lse, delta, scale, causal)
    return (torch.matmul(ds.transpose(-1, -2), qf).to(q.dtype),
            torch.matmul(p.transpose(-1, -2), dof).to(q.dtype))


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in float32 (the reference's, outside its
    kernels)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  scale: float, causal: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_fwd_lse_ref`'s O for the cotangent
    ``do``, in the backward kernels' arithmetic: operands upcast to
    float32, ``delta = rowsum(do * o)``, ``p = exp(scale * q k^T - lse)``
    with masked scores at -1e30, ``ds = p * (do v^T - delta) * scale``,
    ``dq = ds k``, ``dk = ds^T q``, ``dv = p^T do``, each cast to q's
    dtype."""
    qf, kf, dof, p, ds = _bwd_probs(q, k, v, do, lse, flash_bwd_delta(o, do),
                                    scale, causal)
    return (torch.matmul(ds, kf).to(q.dtype),
            torch.matmul(ds.transpose(-1, -2), qf).to(q.dtype),
            torch.matmul(p.transpose(-1, -2), dof).to(q.dtype))
