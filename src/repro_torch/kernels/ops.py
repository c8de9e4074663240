"""Public min-plus and attention operations on tensors of any device.

Counterpart of ``repro.kernels.ops`` (``minplus_matmul``,
``minplus_closure`` and the forward of ``flash_attention``).  There is no
size threshold as in the reference's ``_PALLAS_MIN_DIM``: the device
decides.  Every product on CUDA tensors goes through the hand-written
kernels (:func:`repro_torch.kernels.minplus.minplus_matmul_batched`,
:func:`repro_torch.kernels.flash.flash_fwd_lse`), whatever its size; a CPU
tensor takes the kernel's plain version inside those wrappers.
"""
from __future__ import annotations

import torch

from . import flash, ref
from .minplus import minplus_matmul_batched


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


def closure_steps(n: int) -> int:
    """Squarings that close any ``[n, n]`` weight matrix: after s squarings
    every path of <= 2^s hops is covered, and simple paths have <= n-1."""
    return max(1, (n - 1).bit_length())


def minplus_closure(w: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest-path distances by repeated tropical squaring.

    ``w``: [V, V] (or batched [..., V, V]) edge weights, INF-sentinel for
    absent edges.  Returns D with D[u, u] = 0 and D[u, v] = min-cost path.

    Runs a fixed :func:`closure_steps` squarings.  The reference stops
    early once ``d == d (x) d``; squaring a fixed point reproduces it bit
    for bit, so the fixed count gives the same result and saves the host
    sync per squaring that the convergence test would cost on the GPU.
    """
    d = ref.force_zero_diagonal(w)
    for _ in range(closure_steps(w.shape[-1])):
        d = minplus_matmul(d, d)
    return d


class _FlashAttention(torch.autograd.Function):
    """Causal flash attention whose forward is the flash kernel; the
    backward (the reference's ``flash_bwd``) is not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, _ = flash.flash_fwd_lse(q, k, v, scale=scale, causal=True)
        return o

    @staticmethod
    def backward(ctx, grad_o):
        raise NotImplementedError(
            "the flash attention backward (flash_bwd) is not ported yet: "
            "ROADMAP Queue 2 item 4")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Causal flash attention on contiguous [BH, S, d] q/k and [BH, S, dv] v
    (see :mod:`repro_torch.kernels.flash`).

    Forward only: differentiating it raises ``NotImplementedError`` rather
    than differentiating the plain version.  The reference's ``bq``/``bk``
    are the TPU's tiling, not part of the function, and have no
    counterpart here.
    """
    return _FlashAttention.apply(q, k, v, float(scale))
