"""Traffic mixes: what arrives, built from the config registry's cost profiles.

Counterpart of ``repro.scenarios.traffic``; the profiles come from the
port's registry (:mod:`repro_torch.configs.registry`).

A :class:`TrafficMix` is a weighted set of request kinds.  Registry-backed
entries cost-profile a real architecture (``configs/<arch>.cost_profile``);
synthetic entries draw random fixed-shape jobs (fast, one padded shape —
the choice for property tests and smoke benchmarks).  Sampling a job picks
an entry by weight and a (src, dst) pair from the scenario's ingress/egress
sets.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import jobs as J


@functools.lru_cache(maxsize=64)
def _arch_profile(arch: str, seq_len: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    comp, data = registry.cost_profile(arch, seq_len=seq_len, batch=batch)
    return comp.astype(np.float32), data.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TrafficEntry:
    """One request kind: a registry arch, or ``arch="synthetic"``."""

    arch: str
    weight: float = 1.0
    seq_len: int = 1024
    batch: int = 1
    # synthetic-only knobs
    num_layers: int = 6
    flops_scale: float = 1e9
    bytes_scale: float = 1e6

    @property
    def max_layers(self) -> int:
        if self.arch == "synthetic":
            return self.num_layers
        return int(_arch_profile(self.arch, self.seq_len, self.batch)[0].shape[0])

    def mean_flops(self) -> float:
        """Expected total compute of one request (synthetic: uniform mean)."""
        if self.arch == "synthetic":
            # synthetic_job draws comp ~ U(0.2, 2.0) * flops_scale per layer
            return 1.1 * self.flops_scale * self.num_layers
        return float(_arch_profile(self.arch, self.seq_len, self.batch)[0].sum())

    def make_job(self, rng: np.random.Generator, name: str, src: int,
                 dst: int) -> J.InferenceJob:
        if self.arch == "synthetic":
            return J.synthetic_job(
                name, src, dst, self.num_layers,
                seed=int(rng.integers(0, 2**31 - 1)),
                flops_scale=self.flops_scale, bytes_scale=self.bytes_scale)
        comp, data = _arch_profile(self.arch, self.seq_len, self.batch)
        return J.InferenceJob(name, src, dst, comp, data)


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    name: str
    entries: tuple[TrafficEntry, ...]

    def __post_init__(self):
        if not self.entries:
            raise ValueError("TrafficMix needs at least one entry")
        if any(e.weight <= 0 for e in self.entries):
            raise ValueError("entry weights must be positive")

    @property
    def max_layers(self) -> int:
        return max(e.max_layers for e in self.entries)

    def _probs(self) -> np.ndarray:
        w = np.array([e.weight for e in self.entries], np.float64)
        return w / w.sum()

    def mean_flops(self) -> float:
        """Expected compute per request (for offered-load calibration)."""
        return float(sum(p * e.mean_flops()
                         for p, e in zip(self._probs(), self.entries)))

    def sample(self, rng: np.random.Generator, name: str, src: int,
               dst: int) -> J.InferenceJob:
        e = self.entries[int(rng.choice(len(self.entries), p=self._probs()))]
        return e.make_job(rng, name, src, dst)


MIXES: dict[str, TrafficMix] = {
    # The paper's §V evaluation mix (2:6 VGG19:ResNet34).
    "paper": TrafficMix("paper", (
        TrafficEntry("vgg19", weight=0.25),
        TrafficEntry("resnet34", weight=0.75),
    )),
    # LM serving: mostly small models, some big-context requests.
    "lm": TrafficMix("lm", (
        TrafficEntry("smollm_135m", weight=0.7, seq_len=1024),
        TrafficEntry("olmo_1b", weight=0.3, seq_len=2048),
    )),
    # Fixed-shape random jobs: fast + one padded shape (tests, smoke benches).
    "synthetic": TrafficMix("synthetic", (
        TrafficEntry("synthetic", num_layers=6),
    )),
    "conv": TrafficMix("conv", (TrafficEntry("vgg19"),)),
}


def make_traffic(name: str) -> TrafficMix:
    try:
        return MIXES[name]
    except KeyError:
        raise ValueError(f"unknown traffic mix {name!r}; available: "
                         f"{', '.join(sorted(MIXES))}") from None
