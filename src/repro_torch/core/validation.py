"""Shared host-side constructor validation helpers."""
from __future__ import annotations

import numpy as np


def check_finite_nonneg(name: str, arr: np.ndarray) -> None:
    """Raise ``ValueError`` naming ``name`` if ``arr`` has NaN/inf or < 0."""
    if not np.isfinite(arr).all():
        raise ValueError(f"{name} contains non-finite values (NaN/inf)")
    if (arr < 0).any():
        raise ValueError(f"{name} contains negative values")
