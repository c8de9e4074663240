"""Where a cell's time goes, by the program's own spans
(``repro_torch.tracing``).

    python3 bench/spans.py --workload <name> --seed <n> --seconds <s>

Runs one cell as ``bench/run.py --trace 1`` does, with the program's
recorder on over the profiled window, and prints one JSON line: the
cell's end-to-end numbers as measured under the tracer, the harness's own
reduction of the same profile (``busy_s``, ``window_s``, ``breakdown``),
the spans by name (:func:`by_span`), the readings the spans give
(:func:`readings`) and the checks that the spans cover the work
(:func:`coverage`).  Exits non-zero, with no line, without a card, or if
the program has no recorder.
"""
from __future__ import annotations

import argparse
import contextlib
import heapq
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

OUTSIDE = "-"      # the key of what falls in no program span


def is_launch(name: str) -> bool:
    """A runtime call that launches device work: ``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cuLaunchKernel(Ex)``, ``cudaGraphLaunch``."""
    return "Launch" in name


def events(prof) -> tuple[list, dict, list]:
    """A CUDA-only profile's raw events, read as ``harness.read_trace``
    reads them: the host's runtime calls ``(start ns, name, correlation
    id)``, the device seconds of each correlation id's ops (kernels,
    copies, sets), and the device ops' ``(start ns, end ns)``."""
    from torch.autograd import DeviceType
    calls, device, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.is_async() \
                    or e.start_thread_id() != e.end_thread_id():
                continue
            s, t = e.start_ns(), e.end_ns()
            c = e.correlation_id()
            device[c] = device.get(c, 0.0) + (t - s) / 1e9
            ops.append((s, t))
        else:
            calls.append((e.start_ns(), e.name(), e.correlation_id()))
    return calls, device, ops


def idle_gaps(ops: list, window: tuple) -> list:
    """The stretches of ``window`` in which no device op ran (the gaps
    ``harness.read_trace`` names)."""
    w0, w1 = window
    gaps, cur = [], w0
    for s, t in sorted(ops):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    return gaps


def innermost(spans: list, instants: list) -> list:
    """For each instant, the index of the innermost span that holds it
    (the latest begun of those that hold it), or None."""
    order = sorted(range(len(spans)), key=lambda i: spans[i][0])
    out: list = [None] * len(instants)
    heap: list = []
    k = 0
    for i in sorted(range(len(instants)), key=instants.__getitem__):
        t = instants[i]
        while k < len(order) and spans[order[k]][0] <= t:
            j = order[k]
            heapq.heappush(heap, (-spans[j][0], spans[j][1], j))
            k += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out[i] = heap[0][2] if heap else None
    return out


def self_ns(spans: list) -> list:
    """Each span's duration less its children's (by ``parent``)."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def by_span(spans: list, calls: list, device: dict, gaps: list) -> dict:
    """For each span name: ``n``, ``self_s``, ``launches`` (the launch
    calls whose host start falls in the span and in none of its children,
    whatever thread made them), ``device_s`` (the device time of the ops
    that the runtime calls so placed enqueued, joined by correlation id)
    and ``idle_s`` (the idle gaps whose middle falls in it, and in none of
    its children).  What falls in no span is kept under ``"-"``."""
    out: dict = {}

    def row(name):
        return out.setdefault(name, {"n": 0, "self_s": 0.0, "launches": 0,
                                     "device_s": 0.0, "idle_s": 0.0})

    for s, own in zip(spans, self_ns(spans)):
        r = row(s.name)
        r["n"] += 1
        r["self_s"] += own / 1e9
    for (_, name, corr), j in zip(calls, innermost(spans,
                                                   [c[0] for c in calls])):
        r = row(OUTSIDE if j is None else spans[j].name)
        r["launches"] += is_launch(name)
        r["device_s"] += device.get(corr, 0.0)
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    for (g0, g1), j in zip(gaps, innermost(spans, mids)):
        row(OUTSIDE if j is None else spans[j].name)["idle_s"] += \
            (g1 - g0) / 1e9
    return out


def per_request(spans: list, name: str) -> list:
    """The self seconds of the spans named ``name``, summed by request
    id, in the order the ids first appear."""
    sums: dict = {}
    for s, own in zip(spans, self_ns(spans)):
        if s.name == name:
            sums[s.rid] = sums.get(s.rid, 0.0) + own / 1e9
    return list(sums.values())


def _median_ms(values: list) -> float | None:
    return statistics.median(values) * 1e3 if values else None


def readings(spans: list, by: dict) -> dict:
    """What the spans read in a cell, in ms: each route layer's median
    self time a placement (by request id), the DP's launches a placement,
    and each train phase's device time a step; a reading whose spans are
    missing is None."""
    def per(name: str, key: str, root: str):
        n = by.get(root, {}).get("n", 0)
        return by[name][key] / n if n and name in by else None

    out = {f"{m}.route": _median_ms(per_request(spans, name))
           for m, name in (("drain_ms", "online.drain"),
                           ("closure_ms", "greedy.closures"),
                           ("dp_ms", "greedy.dp"),
                           ("commit_ms", "greedy.commit"),
                           ("submit_self_ms", "online.submit"))}
    out["dp_launches.route"] = per("greedy.dp", "launches", "online.submit")
    for m, name in (("forward_ms", "steps.forward"),
                    ("backward_ms", "steps.backward"),
                    ("optimizer_ms", "adamw.apply")):
        v = per(name, "device_s", "steps.train")
        out[f"{m}.train"] = None if v is None else v * 1e3
    return out


def coverage(spans: list, harness_spans: list, calls: list, by: dict,
             busy_s: float) -> dict:
    """How much of the work the program's spans hold: the share of the
    launch calls inside the harness's ``bench.submit_jobs`` spans that
    also fall in a program span, the share of the device's busy time that
    the train phases' ``device_s`` accounts for, and the median
    ``solvers.solve`` duration in ms."""
    out: dict = {}
    submit = [s for s in harness_spans if s[2] == "bench.submit_jobs"]
    launches = [c for c in calls if is_launch(c[1])]
    inside = [c for c, j in zip(launches, innermost(
        submit, [c[0] for c in launches])) if j is not None]
    if inside:
        held = innermost(spans, [c[0] for c in inside])
        out["submit_launches_in_spans"] = \
            sum(j is not None for j in held) / len(inside)
    phases = [by[n]["device_s"] for n in ("steps.forward", "steps.backward",
                                          "adamw.apply") if n in by]
    if phases and busy_s > 0:
        out["train_phases_of_busy"] = sum(phases) / busy_s
    solve = [(s.end_ns - s.start_ns) / 1e9 for s in spans
             if s.name == "solvers.solve"]
    if solve:
        out["solve_span_median_ms"] = statistics.median(solve) * 1e3
    return out


def joined_share(calls: list, device: dict) -> float | None:
    """The share of the device's op time that a runtime call in the trace
    enqueued (by correlation id): what ``by_span`` can attribute."""
    total = sum(device.values())
    ids = {c[2] for c in calls}
    return sum(v for c, v in device.items() if c in ids) / total \
        if total else None


class SpanRun(harness.Run):
    """A traced :class:`harness.Run` whose window also records the
    program's spans (``program_spans``) and keeps the profile's raw
    events (``events``).  Its ``trace`` is ``harness.read_trace`` of the
    same profile, window and harness spans."""

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import ProfilerActivity, profile
        from repro_torch import tracing
        self.sync()
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
        w0 = time.time_ns()
        self.window_start = time.perf_counter()
        tracing.start()
        try:
            yield
            self.sync()
        finally:
            self.program_spans = tracing.stop()
            w1 = time.time_ns()
            prof.__exit__(None, None, None)
        self.window_ns = (w0, w1)
        self.trace = harness.read_trace(prof, (w0, w1), self.spans)
        self.events = events(prof)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("bench: spans need a CUDA card", file=sys.stderr)
        return 3
    try:
        from repro_torch import tracing  # noqa: F401
    except ImportError:
        print("bench: the program has no recorder", file=sys.stderr)
        return 3
    run = SpanRun(cell, seed=args.seed, seconds=args.seconds, trace=True,
                  device=torch.device("cuda", 0))
    state = cell.driver.setup(run)
    with run.window():
        e2e = cell.driver.measure(run, state)
    calls, device, ops = run.events
    spans = run.program_spans
    by = by_span(spans, calls, device, idle_gaps(ops, run.window_ns))
    counters = {k: v for k, v in run.counters.items() if k != "errors"}
    solve = counters.pop("solve_s", None)
    cover = coverage(spans, run.spans, calls, by, run.trace.busy_s)
    if solve:
        cover["solve_ms_median"] = statistics.median(solve) * 1e3
    print(json.dumps({
        "workload": cell.name, "seed": args.seed,
        "device": harness.device_info(run.device, cell.chips),
        "end_to_end_traced": e2e, "counters": counters,
        "busy_s": run.trace.busy_s, "window_s": run.trace.window_s,
        "launches": sum(is_launch(c[1]) for c in calls),
        "device_ops": run.trace.launches,
        "device_s_joined": joined_share(calls, device),
        "readings": readings(spans, by), "coverage": cover,
        "by_span": by, "breakdown": run.trace.breakdown()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
