"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible.

    Entry points default to ``"cuda"``; on a machine without a card they
    raise here instead of carrying on silently on the CPU.  Callers that
    want the CPU (the parity tests) ask for it with ``device="cpu"``;
    ``"meta"`` gives shapes and dtypes with no storage (the dry-run).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"device must be 'cuda', 'cpu' or 'meta', got {str(dev)!r}")
    return dev
