"""DNN inference jobs.

Counterpart of ``repro.core.jobs``.  A job j is the feedforward computation
of a DNN model with L_j layers, generated at a source node and whose result
must be delivered to a destination node.  ``comp[l]`` (FLOPs) is the load of
computing layer l+1 (paper's c_{j,l+1}); ``data[l]`` (bytes) is the output
size of layer l (paper's d_{jl}), with ``data[0]`` the input data size and
``data[L]`` the inference-result size.

Jobs are padded to a common max layer count in :class:`JobBatch`; padded
layers have zero compute and zero data and are masked out of every cost
term.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from .validation import check_finite_nonneg


@dataclasses.dataclass(frozen=True)
class InferenceJob:
    name: str
    src: int
    dst: int
    comp: np.ndarray  # [L] FLOPs per layer
    data: np.ndarray  # [L+1] bytes: input, per-layer outputs
    # Relative SLO: the job must complete within deadline_s of its arrival
    # (inf = no deadline).  Host-side metadata only; no solver cost reads it.
    deadline_s: float = float("inf")

    @property
    def num_layers(self) -> int:
        return int(self.comp.shape[0])

    def with_deadline(self, deadline_s: float) -> "InferenceJob":
        return dataclasses.replace(self, deadline_s=float(deadline_s))

    def __post_init__(self):
        # Normalize-then-validate: store the converted arrays so list inputs
        # fail here with a named ValueError, not later with AttributeError.
        comp = np.asarray(self.comp, np.float32)
        data = np.asarray(self.data, np.float32)
        object.__setattr__(self, "comp", comp)
        object.__setattr__(self, "data", data)
        if comp.ndim != 1 or comp.shape[0] < 1:
            raise ValueError(f"comp must be a non-empty [L] vector, got shape {comp.shape}")
        if data.shape != (comp.shape[0] + 1,):
            raise ValueError(
                f"data must have L+1={comp.shape[0] + 1} entries (input + L "
                f"layer outputs), got shape {data.shape}")
        check_finite_nonneg("comp", comp)
        check_finite_nonneg("data", data)
        if self.src < 0 or self.dst < 0:
            raise ValueError(f"src/dst must be >= 0, got ({self.src}, {self.dst})")
        d = float(self.deadline_s)
        if np.isnan(d) or d <= 0:
            raise ValueError(f"deadline_s must be > 0 (inf = none), got {d}")
        object.__setattr__(self, "deadline_s", d)


@dataclasses.dataclass(frozen=True)
class JobBatch:
    """Padded batch of J jobs, as tensors on one device."""

    src: torch.Tensor        # [J] int32
    dst: torch.Tensor        # [J] int32
    comp: torch.Tensor       # [J, Lmax] FLOPs (0 beyond L_j)
    data: torch.Tensor       # [J, Lmax+1] bytes (0 beyond L_j)
    num_layers: torch.Tensor  # [J] int32

    @property
    def num_jobs(self) -> int:
        return self.src.shape[0]

    @property
    def max_layers(self) -> int:
        return self.comp.shape[1]

    @property
    def device(self) -> torch.device:
        return self.comp.device

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field, for the solvers' host-side logic
        (one transfer per field, hoisted out of their round loops)."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def batch_jobs(jobs: Sequence[InferenceJob], *, pad_to: int | None = None,
               device: str | torch.device = "cuda") -> JobBatch:
    """Pad jobs to a common layer count (``pad_to`` pins the padded width)
    and place the batch on ``device`` (``"cuda"`` by default; raises
    ``RuntimeError`` without a card)."""
    dev = resolve_device(device)
    if not jobs:
        raise ValueError("empty job list")
    lmax = max(j.num_layers for j in jobs)
    if pad_to is not None:
        if pad_to < lmax:
            raise ValueError(
                f"pad_to={pad_to} is smaller than the longest job (L={lmax})")
        lmax = pad_to
    J = len(jobs)
    comp = np.zeros((J, lmax), np.float32)
    data = np.zeros((J, lmax + 1), np.float32)
    src = np.zeros((J,), np.int32)
    dst = np.zeros((J,), np.int32)
    nl = np.zeros((J,), np.int32)
    for i, j in enumerate(jobs):
        L = j.num_layers
        comp[i, :L] = j.comp
        data[i, : L + 1] = j.data
        src[i], dst[i], nl[i] = j.src, j.dst, L
    return JobBatch(*(torch.from_numpy(x).to(dev)
                      for x in (src, dst, comp, data, nl)))


def synthetic_job(
    name: str, src: int, dst: int, num_layers: int, *, seed: int = 0,
    flops_scale: float = 1e9, bytes_scale: float = 1e6,
) -> InferenceJob:
    """Random job for property tests / the paper's hand-made third model."""
    rng = np.random.default_rng(seed)
    comp = rng.uniform(0.2, 2.0, size=num_layers).astype(np.float32) * flops_scale
    data = rng.uniform(0.1, 1.5, size=num_layers + 1).astype(np.float32) * bytes_scale
    return InferenceJob(name, src, dst, comp, data)
