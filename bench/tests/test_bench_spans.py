"""CPU tests of ``bench/spans.py``: the attribution of launches, device
time and idle gaps to the program's spans, on hand-built events; the
reading of a profile's raw events against ``harness.read_trace`` of the
same events; the readings on hand-built spans; and a traced window that
records the program's spans beside the harness's reduction."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from bench import harness, spans as S  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.tracing import Span  # noqa: E402

MS = 1_000_000


class Event:
    """The part of a kineto event that the readers call."""

    def __init__(self, start, end, name, corr, device=False, thread=1):
        self.s, self.t, self.n, self.c = start, end, name, corr
        self.dev, self.th = device, thread

    def device_type(self):
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def is_async(self):
        return False

    def start_thread_id(self):
        return self.th

    def end_thread_id(self):
        return self.th

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.t

    def name(self):
        return self.n

    def correlation_id(self):
        return self.c


class Profile:
    def __init__(self, evs):
        class Results:
            def events(_):
                return evs

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


# a step at 0-100 ms: forward 5-40 (a launch at 12 whose kernel runs
# 20-30, a copy call at 35 whose copy runs 36-38), backward 40-70 (a
# launch at 50 from autograd's thread, kernel 55-75); an optimizer at
# 70-90 inside the step (a launch at 80, kernel 80-84); a launch at 95 in
# the step's own time (kernel 98-99) and one at 110 outside every span
# (kernel 110-111)
SPANS = [Span(0, 100 * MS, "steps.train", None, 0),
         Span(5 * MS, 40 * MS, "steps.forward", 0, 0),
         Span(40 * MS, 70 * MS, "steps.backward", 0, 0),
         Span(70 * MS, 90 * MS, "adamw.apply", 0, 0)]
EVENTS = [
    Event(12 * MS, 13 * MS, "cudaLaunchKernel", 1),
    Event(20 * MS, 30 * MS, "gemm", 1, device=True),
    Event(35 * MS, 35 * MS + 10, "cudaMemcpyAsync", 2),
    Event(36 * MS, 38 * MS, "Memcpy DtoH", 2, device=True),
    Event(50 * MS, 51 * MS, "cuLaunchKernelEx", 3, thread=2),
    Event(55 * MS, 75 * MS, "index_backward", 3, device=True),
    Event(80 * MS, 81 * MS, "cudaLaunchKernel", 4),
    Event(80 * MS, 84 * MS, "adam", 4, device=True),
    Event(95 * MS, 95 * MS + 10, "cudaLaunchKernel", 5),
    Event(98 * MS, 99 * MS, "add", 5, device=True),
    Event(110 * MS, 110 * MS + 10, "cudaLaunchKernel", 6),
    Event(110 * MS, 111 * MS, "add", 6, device=True),
]
WINDOW = (0, 120 * MS)


def test_by_span_attributes_launches_device_time_and_idle_gaps():
    calls, device, ops = S.events(Profile(EVENTS))
    by = S.by_span(SPANS, calls, device, S.idle_gaps(ops, WINDOW))
    ms = 1e-3
    # idle gaps, each where its middle falls: 0-20 and 30-36 forward,
    # 38-55 backward, 75-80 the optimizer, 84-98 the step, 99-110 and
    # 111-120 outside
    want = {  # name: n, self, launches, device, idle
        "steps.train": (1, 15 * ms, 1, 1 * ms, 14 * ms),
        "steps.forward": (1, 35 * ms, 1, 12 * ms, 26 * ms),
        "steps.backward": (1, 30 * ms, 1, 20 * ms, 17 * ms),
        "adamw.apply": (1, 20 * ms, 1, 4 * ms, 5 * ms),
        "-": (0, 0.0, 1, 1 * ms, 20 * ms)}
    assert set(by) == set(want)
    for name, (n, own, launches, dev, idle) in want.items():
        r = by[name]
        assert r["n"] == n and r["launches"] == launches, name
        for key, v in (("self_s", own), ("device_s", dev), ("idle_s", idle)):
            assert r[key] == pytest.approx(v, abs=1e-12), (name, key)
    assert sum(r["device_s"] for r in by.values()) == pytest.approx(38 * ms)


def test_reading_the_events_agrees_with_the_harness_trace():
    prof = Profile(EVENTS)
    trace = harness.read_trace(prof, WINDOW, [(0, 100 * MS, "bench.step")])
    calls, device, ops = S.events(prof)
    gaps = S.idle_gaps(ops, WINDOW)
    assert sum(g1 - g0 for g0, g1 in gaps) / 1e9 == \
        pytest.approx(trace.window_s - trace.busy_s)
    assert sum(trace.gaps.values()) == pytest.approx(
        sum(g1 - g0 for g0, g1 in gaps) / 1e9)
    assert sum(device.values()) == pytest.approx(
        sum(v[0] for v in trace.kernels.values()))
    assert len(ops) == trace.launches
    assert [c[1] for c in calls if S.is_launch(c[1])] == [
        "cudaLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernel",
        "cudaLaunchKernel", "cudaLaunchKernel"]
    assert S.joined_share(calls, device) == 1.0


def test_innermost_takes_the_latest_begun_span_that_holds_an_instant():
    spans = [(0, 10, "a"), (2, 4, "b"), (6, 9, "c"), (7, 8, "d")]
    assert S.innermost(spans, [11, 1, 3, 5, 7, 8, 9, -1]) == \
        [None, 0, 1, 0, 3, 3, 2, None]


def route_spans(n: int) -> list:
    out = []
    for i in range(n):
        t, rid = i * 100 * MS, f"job{i}"
        root = len(out)
        out.append(Span(t, t + 40 * MS, "online.submit", None, rid))
        out.append(Span(t + 1 * MS, t + 2 * MS, "online.drain", root, rid))
        solve = len(out)
        out.append(Span(t + 5 * MS, t + 35 * MS, "solvers.solve", root, rid))
        out += [Span(t + 6 * MS, t + 10 * MS, "greedy.closures", solve, rid),
                Span(t + 10 * MS, t + (20 + i) * MS, "greedy.dp", solve, rid),
                Span(t + 25 * MS, t + 30 * MS, "greedy.commit", solve, rid)]
    return out


def test_readings_on_hand_built_spans():
    spans = route_spans(3)
    calls = [(i * 100 * MS + 12 * MS, "cudaLaunchKernel", i) for i in range(3)]
    calls += [(15 * MS, "cudaLaunchKernel", 9)]
    by = S.by_span(spans, calls, {}, [])
    got = S.readings(spans, by)
    assert got["drain_ms.route"] == pytest.approx(1.0)
    assert got["closure_ms.route"] == pytest.approx(4.0)
    assert got["dp_ms.route"] == pytest.approx(11.0)   # 10, 11, 12 ms
    assert got["commit_ms.route"] == pytest.approx(5.0)
    assert got["submit_self_ms.route"] == pytest.approx(40 - 1 - 30)
    assert got["dp_launches.route"] == pytest.approx(4 / 3)
    for name in ("forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train"):
        assert got[name] is None
    calls, device, ops = S.events(Profile(EVENTS))
    train = S.readings(SPANS, S.by_span(SPANS, calls, device, []))
    assert train["forward_ms.train"] == pytest.approx(12.0)
    assert train["backward_ms.train"] == pytest.approx(20.0)
    assert train["optimizer_ms.train"] == pytest.approx(4.0)
    assert train["dp_ms.route"] is None and train["dp_launches.route"] is None
    empty = S.readings([], {})
    assert set(empty) == set(got) and all(v is None for v in empty.values())


def test_coverage_of_the_harness_spans_and_of_busy_time():
    spans = route_spans(2)
    harness_spans = [(0, 45 * MS, "bench.submit_jobs"),
                     (100 * MS, 145 * MS, "bench.submit_jobs")]
    calls = [(12 * MS, "cudaLaunchKernel", 1),
             (42 * MS, "cudaLaunchKernel", 2),     # in no program span
             (112 * MS, "cudaLaunchKernel", 3),
             (60 * MS, "cudaLaunchKernel", 4)]     # outside the harness's
    cover = S.coverage(spans, harness_spans, calls, {}, 0.0)
    assert cover["submit_launches_in_spans"] == pytest.approx(2 / 3)
    assert cover["solve_span_median_ms"] == pytest.approx(30.0)
    calls, device, ops = S.events(Profile(EVENTS))
    by = S.by_span(SPANS, calls, device, [])
    cover = S.coverage(SPANS, [], calls, by, 38e-3)
    assert cover["train_phases_of_busy"] == pytest.approx(36 / 38)


def test_a_span_run_records_the_programs_spans_in_its_window():
    cell = harness.resolve("olmoe-route")
    run = S.SpanRun(cell, seed=1, seconds=0.1, trace=True,
                    device=torch.device("cpu"))
    with run.window():
        with run.span("submit_jobs"):
            with tracing.span("online.submit", rid="job0"):
                with tracing.span("online.drain"):
                    torch.ones(8).sum()
    assert [s.name for s in run.program_spans] == ["online.submit",
                                                   "online.drain"]
    w0, w1 = run.window_ns
    assert all(w0 <= s.start_ns <= s.end_ns <= w1
               for s in run.program_spans)
    assert {name for _, _, name in run.spans} == {"bench.submit_jobs"}
    assert run.trace.busy_s == 0 and run.trace.window_s > 0
    assert sum(run.trace.gaps.values()) == pytest.approx(run.trace.window_s)
    with tracing.span("after"):
        pass
    assert tracing.stop() == []
