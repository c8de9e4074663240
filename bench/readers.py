"""Arithmetic the per-layer readers share.  Each reader in
``bench/metrics/`` is ``read(run) -> float | None``: None where the run
gives it nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

from bench import yardstick


def idle_share(run) -> float | None:
    """Per cent of the traced window in which no operation ran on the card."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_share(run, flops: float) -> float | None:
    """Per cent of the card's bf16 peak that ``flops`` of model work done
    over the traced window is, timed by the host's clock (the tracer
    slows the window's steps a little, so the share reads low by as
    much)."""
    t = run.trace
    if t is None or t.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (t.window_s * yardstick.PEAK_BF16_OPS_PER_S)


def roofline(run, parts: list[tuple[str, float]]) -> float | None:
    """Per cent: the least time of the launches of each kernel named by a
    part of its name, over the time the trace gives them.  ``parts``
    pairs a name part with one launch's least time in s."""
    t = run.trace
    if t is None:
        return None
    least = spent = 0.0
    for part, bound in parts:
        secs, n = t.time_of(part)
        if n == 0:
            return None
        least += n * bound
        spent += secs
    return 100.0 * least / spent
