"""Shared helpers for the LM-family architecture configs.

Counterpart of ``repro.configs._lm_common``.  The stand-in for
``jax.ShapeDtypeStruct`` is a tensor on the ``meta`` device: shape and
dtype, no storage (as :func:`repro_torch.models.model.param_shapes` gives
for the params).
"""
from __future__ import annotations

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.model import ModelConfig


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for the step function's ``batch`` argument."""
    b, s = spec.global_batch, spec.seq_len

    def struct(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if spec.kind == "train":
        batch = {"tokens": struct((b, s)), "labels": struct((b, s))}
    elif spec.kind == "prefill":
        batch = {"tokens": struct((b, s))}
    else:  # decode: one new token against a KV cache of length s
        batch = {"tokens": struct((b, 1)), "pos": struct(())}
    if cfg.family == "encdec":
        frames = struct((b, cfg.num_frames, cfg.d_model), cfg.dtype)
        batch["enc_out" if spec.kind == "decode" else "frames"] = frames
    if cfg.family == "vlm" and spec.kind != "decode":
        batch["patches"] = struct((b, cfg.num_patches, cfg.d_model), cfg.dtype)
    return batch
