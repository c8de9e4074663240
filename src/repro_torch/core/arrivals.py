"""Arrival processes: request batches arriving on a clock.

Counterpart of ``repro.core.arrivals`` (plain numpy, the same draws in the
same order, so both packages give the same timestamps from the same rng).
The online serving loop drains the network's
:class:`~repro_torch.core.state.QueueState` to each arrival time before
solving.
This module generates the arrival clocks.  Every process is a host-side
generator of sorted timestamps in ``[0, horizon)`` seconds:

  * :func:`poisson_times` — homogeneous Poisson with rate ``rate`` (1/s):
    the memoryless baseline every stability argument is phrased against.
  * :func:`bursty_times` — compound/batch Poisson: burst *epochs* arrive
    Poisson at ``rate / burst_size`` and each epoch carries ``burst_size``
    arrivals jittered ``within`` seconds apart, so the long-run rate is
    ``rate`` but the short-run load is spiky.
  * :func:`diurnal_times` — nonhomogeneous Poisson via thinning with a
    sinusoidal rate  lam(t) = base + (peak - base) * (1 - cos(2 pi t /
    period)) / 2  — a traffic "day" ramping from ``base_rate`` at t=0 to
    ``peak_rate`` at mid-period and back.

``make_process(name, **params)`` returns a ``(rng, horizon) -> times``
callable from a string name, so scenarios and benchmarks can pick a
process the same way they pick a solver.  :func:`stream_times` is the
*iterator view* over the same processes — the shape the streaming serving
pipeline consumes arrivals in, one at a
time, with an optional chunked mode so very long horizons never
materialize a full timestamp array.
"""
from __future__ import annotations

from typing import Callable, Iterator, Protocol

import numpy as np

ArrivalFn = Callable[[np.random.Generator, float], np.ndarray]


class ArrivalProcess(Protocol):
    """(rng, horizon seconds) -> sorted float64 arrival times in [0, horizon)."""

    def __call__(self, rng: np.random.Generator, horizon: float) -> np.ndarray:
        ...


def poisson_times(rng: np.random.Generator, rate: float,
                  horizon: float) -> np.ndarray:
    """Homogeneous Poisson arrivals: i.i.d. Exp(rate) gaps."""
    if rate <= 0:
        return np.zeros((0,), np.float64)
    # Draw ~horizon*rate + slack gaps in one shot, keep the prefix in range.
    n = max(8, int(horizon * rate * 1.5) + 8)
    times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while times.size and times[-1] < horizon:  # rare under-draw
        extra = np.cumsum(rng.exponential(1.0 / rate, size=n)) + times[-1]
        times = np.concatenate([times, extra])
    return times[times < horizon]


def bursty_times(rng: np.random.Generator, rate: float, horizon: float,
                 *, burst_size: int = 4, within: float = 1e-3) -> np.ndarray:
    """Batch-Poisson bursts: epochs at rate/burst_size, ``burst_size`` each."""
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    epochs = poisson_times(rng, rate / burst_size, horizon)
    offsets = rng.uniform(0.0, within, size=(epochs.size, burst_size))
    offsets[:, 0] = 0.0
    times = (epochs[:, None] + offsets).reshape(-1)
    return np.sort(times[times < horizon])


def diurnal_times(rng: np.random.Generator, base_rate: float, peak_rate: float,
                  horizon: float, *, period: float | None = None) -> np.ndarray:
    """Nonhomogeneous Poisson (thinning) with a sinusoidal daily profile."""
    if peak_rate < base_rate:
        raise ValueError(
            f"peak_rate {peak_rate} must be >= base_rate {base_rate}")
    period = horizon if period is None else period
    lam_max = max(peak_rate, 1e-12)
    cand = poisson_times(rng, lam_max, horizon)
    lam = base_rate + (peak_rate - base_rate) * 0.5 * (
        1.0 - np.cos(2.0 * np.pi * cand / period))
    keep = rng.uniform(0.0, 1.0, size=cand.size) < lam / lam_max
    return cand[keep]


_PROCESSES: dict[str, Callable[..., ArrivalFn]] = {}


def register_process(name: str):
    """Decorator: register an arrival-process factory under ``name``.

    The factory's keyword arguments are its process params — callers pass
    them via ``make_process(name, **params)`` (and, in the online loop,
    ``run_online(process=name, process_params={...})``; the ``rate``
    shorthand there only maps onto the built-ins).
    """
    def deco(factory):
        _PROCESSES[name] = factory
        return factory
    return deco


_register = register_process  # backwards-compatible internal alias


@_register("poisson")
def _poisson(rate: float = 1.0) -> ArrivalFn:
    return lambda rng, horizon: poisson_times(rng, rate, horizon)


@_register("bursty")
def _bursty(rate: float = 1.0, burst_size: int = 4,
            within: float = 1e-3) -> ArrivalFn:
    return lambda rng, horizon: bursty_times(
        rng, rate, horizon, burst_size=burst_size, within=within)


@_register("diurnal")
def _diurnal(base_rate: float = 0.2, peak_rate: float = 1.0,
             period: float | None = None) -> ArrivalFn:
    return lambda rng, horizon: diurnal_times(
        rng, base_rate, peak_rate, horizon, period=period)


def available() -> tuple[str, ...]:
    """Registered process names (built-ins + ``register_process`` extras)."""
    return tuple(sorted(_PROCESSES))


def make_process(name: str, **params) -> ArrivalFn:
    """Build an arrival-time generator by name (poisson | bursty | diurnal)."""
    try:
        factory = _PROCESSES[name]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {name!r}; available: "
            f"{', '.join(available())}") from None
    return factory(**params)


def resolve_rate(process: str, rate: float | None,
                 params: dict | None) -> dict:
    """Map the ``rate`` shorthand onto a named process's own parameters.

    Explicit ``params`` always win over the shorthand.  The mapping is only
    defined for the built-ins — ``poisson`` / ``bursty`` take ``rate``
    directly, ``diurnal`` scales the whole profile (``peak_rate = rate``,
    ``base_rate = peak_rate / 5``, the module defaults' 5:1 ratio) — so any
    other *registered* process rejects ``rate`` with a ``ValueError``
    rather than silently ignoring it.  (An unregistered name passes
    through: :func:`make_process` raises its own "unknown process" error.)
    Shared by the serial online loop and the streaming pipeline so both
    drive bit-identical arrival streams from the same arguments.
    """
    out = dict(params or {})
    if rate is None:
        return out
    if process in ("poisson", "bursty"):
        out.setdefault("rate", rate)
    elif process == "diurnal":
        out.setdefault("peak_rate", rate)
        out.setdefault("base_rate", out["peak_rate"] / 5.0)
    elif process in available():
        raise ValueError(
            f"run_online(rate=...) has no defined mapping onto process "
            f"{process!r}; pass its rate parameters via process_params=")
    return out


def stream_times(process: str, rng: np.random.Generator, horizon: float,
                 *, chunk_s: float | None = None,
                 **params) -> Iterator[float]:
    """Iterator view over an arrival process.

    Materializing a whole horizon of timestamps up front is fine for a
    benchmark but the wrong shape for a serving pipeline that ingests
    arrivals one at a time; this yields them lazily.  By default the named
    process is drawn once (the stream is *identical* to
    ``make_process(process, **params)(rng, horizon)``); with ``chunk_s``
    the horizon is generated chunk-by-chunk — the process restarts at each
    chunk boundary, which is exact for the memoryless ``poisson`` and an
    approximation for processes with cross-boundary structure (a burst or
    diurnal phase does not span chunks) — so unbounded horizons never hold
    more than one chunk of timestamps in memory.
    """
    fn = make_process(process, **params)
    if chunk_s is None:
        yield from (float(t) for t in fn(rng, horizon))
        return
    if chunk_s <= 0:
        raise ValueError(f"chunk_s must be > 0, got {chunk_s}")
    t0 = 0.0
    while t0 < horizon:
        dt = min(chunk_s, horizon - t0)
        for t in fn(rng, dt):
            yield t0 + float(t)
        t0 += dt
