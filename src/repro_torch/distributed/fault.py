"""Fault tolerance & straggler handling for long-running training jobs.

Counterpart of ``repro.distributed.fault`` (numpy only; the port keeps its
own copy).  The training loop (``launch/train.py``) checkpoints every
``ckpt_every`` steps and on (re)start resumes from the newest complete
checkpoint; the data pipeline is a pure function of the step, so the
restarted trajectory repeats an uninterrupted run's.

  * ``FailureInjector`` kills the loop at a chosen step to simulate a node
    loss; the restart test then resumes and compares final losses.
  * ``StragglerMonitor`` tracks a robust (median + MAD) step-time estimate
    and reports persistent outliers.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class FailureInjector:
    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step

    def check(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """Robust step-time outlier detector (median + k*MAD)."""
    window: int = 50
    k: float = 5.0
    _times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, dt: float) -> bool:
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 10:
            return False
        med = float(np.median(self._times))
        mad = float(np.median(np.abs(np.asarray(self._times) - med))) + 1e-9
        is_straggler = dt > med + self.k * mad
        if is_straggler:
            self.flagged += 1
        return is_straggler
