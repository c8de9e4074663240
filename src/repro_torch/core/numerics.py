"""Float32 arithmetic that must round exactly as the reference's does.

XLA:CPU contracts a float32 multiply that feeds an add into one fused
multiply-add on hosts whose CPU has FMA (x86-64 with FMA3): the DP line
``min(g, moved) + c_l * cinv`` of ``repro.core.routing``, the segments of
its fixed-assignment cost and the fluid drain ``q - mu * dt`` of
``repro.core.state`` each round once, not twice.  The golden values the
reference is held to (``QUICKSTART_BOUNDS``) carry that single rounding.
PyTorch has no fused multiply-add operator whose rounding it guarantees on
every device, so :func:`fma_f32` builds one from float64 operations that
are exact on any IEEE device.
"""
from __future__ import annotations

import torch


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` for float32 operands, rounded once to float32.

    The product of two float32 values is exact in float64.  The float64 sum
    is made round-to-odd (TwoSum gives its exact error; an inexact sum with
    an even last bit moves one float64 ulp toward the exact value), and
    rounding a round-to-odd value of >= 26 bits to float32's 24 gives the
    correctly rounded result (Boldo & Melquiond, 2008).
    """
    a, b, c = (torch.as_tensor(x).to(torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)
