"""--arch registry of the port: the paper's own evaluation models.

The LM architectures of ``repro.configs.registry`` are not ported yet;
asking for one raises ``KeyError`` naming what is.
"""
from __future__ import annotations

import importlib

# paper's own evaluation models (cost profiles only — conv nets)
PAPER_MODELS = ["vgg19", "resnet34"]


def get(arch: str):
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in PAPER_MODELS:
        raise KeyError(f"arch {arch!r} is not ported to repro_torch; "
                       f"ported: {PAPER_MODELS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")
