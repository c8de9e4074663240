from . import registry, shapes
from .registry import ARCH_IDS, PAPER_MODELS

__all__ = ["registry", "shapes", "ARCH_IDS", "PAPER_MODELS"]
