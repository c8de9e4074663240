"""--arch registry of the port: the ported LM architectures and the
paper's own evaluation models.

Counterpart of ``repro.configs.registry``.  The LM architectures ported so
far are the dense ones the serving path runs; asking for any other raises
``KeyError`` naming what is ported.
"""
from __future__ import annotations

import importlib

ARCH_IDS = ["olmo_1b", "smollm_135m"]

# paper's own evaluation models (cost profiles only — conv nets)
PAPER_MODELS = ["vgg19", "resnet34"]


def get(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + PAPER_MODELS:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch; "
                       f"ported: {ARCH_IDS + PAPER_MODELS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def cost_profile(arch: str, *, seq_len: int = 2048, batch: int = 1):
    """Per-layer (c_jl FLOPs, d_jl bytes) for any registered arch: the conv
    nets take ``batch`` only, the LM families ``seq_len`` and ``batch``."""
    arch = arch.replace("-", "_").replace(".", "_")
    mod = get(arch)
    if arch in PAPER_MODELS:
        return mod.cost_profile(batch=batch)
    return mod.cost_profile(seq_len=seq_len, batch=batch)


def config(arch: str):
    return get(arch).config()


def smoke_config(arch: str):
    return get(arch).smoke_config()
