"""Public min-plus and attention operations on tensors of any device.

Counterpart of ``repro.kernels.ops`` (``minplus_matmul``,
``minplus_closure`` and ``flash_attention`` with its backward).  There is
no size threshold as in the reference's ``_PALLAS_MIN_DIM``: the device
decides.  Every product on CUDA tensors goes through the hand-written
kernels (:func:`repro_torch.kernels.minplus.minplus_matmul_batched`,
:func:`repro_torch.kernels.minplus.minplus_closure_batched`,
:func:`repro_torch.kernels.flash.flash_fwd_lse`,
:func:`repro_torch.kernels.flash.flash_bwd`), whatever its size; a CPU
tensor takes the kernel's plain version inside those wrappers.
"""
from __future__ import annotations

import torch

from . import flash, ref
from .minplus import (closure_steps, closure_variant, minplus_closure_batched,
                      minplus_matmul_batched)


def minplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[..., i, j] = min_k A[..., i, k] + B[..., k, j].

    Leading batch dims broadcast against each other and are flattened onto
    the kernel's one batch axis (a 2-D product is the batch-of-one view).
    """
    m, k = a.shape[-2:]
    n = b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(lead + (m, k)).reshape(-1, m, k).contiguous()
    b3 = b.expand(lead + tuple(b.shape[-2:])).reshape(-1, b.shape[-2], n)
    out = minplus_matmul_batched(a3, b3.contiguous())
    return out.reshape(lead + (m, n))


def minplus_closure(w: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest-path distances by repeated tropical squaring.

    ``w``: [V, V] (or batched [..., V, V]) edge weights, INF-sentinel for
    absent edges.  Returns D with D[u, u] = 0 and D[u, v] = min-cost path.

    Runs a fixed :func:`closure_steps` squarings.  The reference stops
    early once ``d == d (x) d``; squaring a fixed point reproduces it bit
    for bit, so the fixed count gives the same result and saves the host
    sync per squaring that the convergence test would cost on the GPU.
    :func:`closure_variant` picks the way: one launch of the closure
    kernel for the whole stack (CUDA, V <= 32), or one product per
    squaring.
    """
    v = w.shape[-1]
    if closure_variant(v, w.device) == "closure":
        flat = w.reshape(-1, v, v).contiguous()
        return minplus_closure_batched(flat).view(w.shape)
    d = ref.force_zero_diagonal(w)
    for _ in range(closure_steps(v)):
        d = minplus_matmul(d, d)
    return d


class _FlashAttention(torch.autograd.Function):
    """Causal flash attention: the forward kernel saves O and the
    logsumexp, the backward kernels recompute P from them (the
    reference's ``jax.custom_vjp`` around ``flash_fwd_lse``/``flash_bwd``).
    """

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, grad_o):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash.flash_bwd(q, k, v, o, lse, grad_o.contiguous(),
                                     scale=ctx.scale, causal=True)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Causal flash attention on contiguous [BH, S, d] q/k and [BH, S, dv] v
    (see :mod:`repro_torch.kernels.flash`), differentiable: the backward
    runs :func:`repro_torch.kernels.flash.flash_bwd` (the two backward
    kernels on CUDA tensors, their plain version on CPU tensors), never
    autograd of the plain forward.  The reference's ``bq``/``bk`` are the
    TPU's tiling, not part of the function, and have no counterpart here.
    """
    return _FlashAttention.apply(q, k, v, float(scale))
