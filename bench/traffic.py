"""The one generator every mix's parameters go through.

Every seed gets the same set of sizes and gaps, in its own order, so two
seeds differ in order and not in work.
"""
from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The seed's numpy generator for one named use (``stream``)."""
    return np.random.default_rng([int(seed), int(stream)])


def torch_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the run's seed and a
    stream number."""
    return int(rng(seed, stream).integers(1 << 63))


def poisson_gaps(n: int, seed: int) -> np.ndarray:
    """``n`` inter-arrival gaps of a unit-rate Poisson process: the ``n``
    equal-probability quantiles of the exponential distribution, in the
    seed's order (float64, mean 1)."""
    q = -np.log1p(-(np.arange(n) + 0.5) / n)
    return q[rng(seed, 1).permutation(n)] / q.mean()


def balanced(items: list, n: int, seed: int, stream: int = 2) -> list:
    """``n`` picks from ``items``, each as often as ``n`` allows (the
    first ``n % len(items)`` once more), in the seed's order."""
    reps = [items[i % len(items)] for i in range(n)]
    order = rng(seed, stream).permutation(n)
    return [reps[i] for i in order]


def sample(n_total: int, k: int, seed: int, stream: int = 3,
           always: tuple = ()) -> list[int]:
    """``k`` sorted indices of ``range(n_total)`` drawn from the seed,
    with the indices in ``always`` among them."""
    pool = [i for i in range(n_total) if i not in always]
    k = max(0, min(k - len(always), len(pool)))
    picked = rng(seed, stream).choice(len(pool), size=k, replace=False)
    return sorted(set(always) | {pool[i] for i in picked})
