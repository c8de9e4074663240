from . import convnets, lm

__all__ = ["convnets", "lm"]
