"""The assigned input-shape set (applies to every LM-family architecture).

Each shape names the step it lowers: train shapes lower ``train_step``,
decode shapes lower ``serve_step`` (one new token against a KV cache of
``seq_len``), prefill lowers the forward pass.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg, spec: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if spec.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention architecture: 500k-token decode needs "
                       "sub-quadratic attention (see DESIGN.md §4)")
    return True, ""
