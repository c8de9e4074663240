"""Gradient compression for cross-pod all-reduces.

Counterpart of ``repro.optim.grad_compress``.  ``Int8Compressor``
quantizes each gradient leaf to int8 with a per-leaf scale and keeps the
quantization residual as error feedback, added back into the next step's
gradient; ``topk_mask`` keeps the largest-magnitude entries of a leaf.
Both are pure transforms of a tree of tensors (nested dicts), on the
tensors' own device.

Every operation is one IEEE-rounded float32 operation, as in the
reference, so the codes, scales and residuals equal the reference's bit
for bit.  The divisions are true divisions by a tensor on the leaf's
device: a CUDA division by a host scalar multiplies by its reciprocal
instead, which rounds differently.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.pytree import leaves, tree_map, unflatten


def _quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale) of a float32 leaf: scale =
    max(max |g|, 1e-12) / 127, codes = clip(round(g / scale), -127, 127)."""
    top = torch.clamp(g.abs().max(), min=1e-12)
    scale = top / torch.full_like(top, 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """int8 codes with a per-leaf scale and error feedback:

        comp, state = compressor.compress(grads, state)
        # all-reduce the codes over the pod axis (4x fewer bytes)
        grads = compressor.decompress(comp)
    """

    def init(self, grads_like) -> Any:
        """A float32 zero residual for each leaf, on the leaf's device."""
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device), grads_like)

    def compress(self, grads, err_state):
        """(tree of (int8 codes, float32 scale) per leaf, new residuals):
        each leaf is taken in float32 plus its residual, quantized, and
        what the codes miss becomes its new residual."""
        comp, new_state = [], []
        for g, e in zip(leaves(grads), leaves(err_state), strict=True):
            g = g.float() + e
            q, scale = _quantize_leaf(g)
            comp.append((q, scale))
            new_state.append(g - _dequantize_leaf(q, scale))
        return unflatten(grads, comp), unflatten(grads, new_state)

    def decompress(self, comp):
        return tree_map(lambda qs: _dequantize_leaf(*qs), comp)

    def roundtrip(self, grads, err_state):
        """compress then decompress, without a collective (one card)."""
        comp, new_state = self.compress(grads, err_state)
        return self.decompress(comp), new_state

    @staticmethod
    def compressed_bytes(grads) -> int:
        return sum(g.numel() for g in leaves(grads))       # 1 byte a value

    @staticmethod
    def raw_bytes(grads) -> int:
        return sum(g.numel() * 4 for g in leaves(grads))


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """``g`` with every entry whose magnitude is below the k-th largest
    (k = max(1, int(frac * numel))) set to 0; entries tied with the k-th
    are all kept."""
    flat = g.reshape(-1).abs()
    k = max(1, int(frac * flat.numel()))
    thresh = torch.topk(flat, k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))
