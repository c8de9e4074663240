"""Spans: named, nested host intervals at the port's layer boundaries.

The port's own module: the JAX package has no counterpart.  A span times
the code in its ``with`` block::

    tracing.start()
    with tracing.span("online.submit", rid="job7"):
        with tracing.span("online.drain"):
            ...
    spans = tracing.stop()

Recording is off until :func:`start` and after :func:`stop`; nothing else
turns it on.  While it is off, :func:`span` checks one module global and
returns one preallocated no-op object.  While it is on, each span that
ends appends one :class:`Span` to an in-memory buffer, which :func:`start`
clears and :func:`stop` hands back.

Spans nest per thread: a span's parent is the innermost span open on its
own thread when it began, and a span given no ``rid`` (request id) takes
its parent's.  Readings are ``time.perf_counter_ns``; :func:`stop` maps
them onto the ``time.time_ns`` clock, which ``torch.profiler``'s events
share, by one offset taken at :func:`start`.

``span(name, timed=True)`` takes its two readings whether or not
recording is on, and its caller reads the duration back from
``seconds``: that is how ``core.solvers`` times ``meta["solve_s"]``.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One recorded span.  ``start_ns`` and ``end_ns`` are on the
    ``time.time_ns`` clock; ``parent`` is the index of the parent in the
    list :func:`stop` returned (None for a root, or for a parent that had
    not ended when recording stopped); ``rid`` is the request id."""

    start_ns: int
    end_ns: int
    name: str
    parent: int | None
    rid: object


_on = False
# ended spans while on: (start, end, name, parent seq, rid, seq), the
# readings on the perf_counter_ns clock
_ended: list = []
_offset_ns = 0          # time_ns - perf_counter_ns, taken at start()
_seq = itertools.count()
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Timed:
    """A span that takes its readings; ``seconds`` once it has ended."""

    __slots__ = ("name", "rid", "parent", "seq", "t0", "t1")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self) -> _Timed:
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = None if up is None else up.seq
        if self.rid is None and up is not None:
            self.rid = up.rid
        self.seq = next(_seq)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        if _on:
            _ended.append((self.t0, self.t1, self.name, self.parent,
                           self.rid, self.seq))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


_OFF = contextlib.nullcontext()     # the span handed out while off


def span(name: str, rid=None, *, timed: bool = False):
    """A context manager spanning its block under ``name``: recorded
    while recording is on, a no-op while it is off unless ``timed``."""
    if _on or timed:
        return _Timed(name, rid)
    return _OFF


def start() -> None:
    """Clear the buffer and turn recording on."""
    global _on, _offset_ns
    _ended.clear()
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    _offset_ns = wall - (a + b) // 2
    _on = True


def stop() -> list[Span]:
    """Turn recording off and return the spans that ended since
    :func:`start`, in the order they began, on the ``time.time_ns``
    clock."""
    global _on
    _on = False
    ended = sorted(_ended, key=lambda r: (r[0], -r[1]))
    _ended.clear()
    index = {r[5]: i for i, r in enumerate(ended)}
    return [Span(t0 + _offset_ns, t1 + _offset_ns, name, index.get(up), rid)
            for t0, t1, name, up, rid, _ in ended]
