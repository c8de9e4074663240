"""--arch registry of the port: the 10 LM architectures and the paper's own
evaluation models.

Counterpart of ``repro.configs.registry``.  Every architecture has its
``config()``, ``smoke_config()`` and ``cost_profile()``; the models of the
non-dense families are not ported yet (``models.model.init_params`` raises
for them).
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "olmo_1b", "smollm_135m", "minicpm_2b", "gemma3_1b", "xlstm_125m",
    "olmoe_1b_7b", "deepseek_v2_236b", "whisper_base", "zamba2_2_7b",
    "phi3_vision_4_2b",
]

# paper's own evaluation models (cost profiles only — conv nets)
PAPER_MODELS = ["vgg19", "resnet34"]


def get(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + PAPER_MODELS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + PAPER_MODELS}")
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
