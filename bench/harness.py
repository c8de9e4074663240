"""What every cell shares: the manifest and the files it names, the run
context a driver works in, the device trace of a traced run, and the
result line.

A cell is found by name.  ``BENCHMARK.json`` names its configuration and
traffic mix; ``bench/configs/<config>.json`` holds the widths,
``bench/mixes/<traffic>.json`` the mix's parameters and the name of its
driver, ``bench/drivers/<driver>.py``; each per-layer metric is read by
``bench/metrics/<metric>.py``.  A model's architecture is
``bench/arch/<model_type>.py`` (:func:`bench.models.arch`), and the CPU
tests' small sizes of a cell are ``bench/tiny/<workload>.json``.  Adding
a cell, a mix, a metric or an architecture adds files and manifest
entries; no file here names one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import importlib.util
import json
import pathlib
import re
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level module names that no run may load: JAX, its relatives, and the
# JAX package the port was made from (compared whole: "repro_torch" is not
# "repro")
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """Import the Python file ``path`` as a module named ``name``."""
    if not path.is_file():
        raise BenchError(f"missing file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config: dict          # bench/configs/<config>.json
    mix: dict             # bench/mixes/<traffic>.json
    driver: object        # bench/drivers/<mix["driver"]>.py
    limits: dict          # bench/limits/<workload>.json: what correct needs
    end_to_end: list      # manifest entries this cell reports with --trace 0
    per_layer: list       # ... and with --trace 1


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list, or,
    without one, every cell (end-to-end) or every cell that reports the
    end-to-end metric it moves (per-layer)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def resolve(name: str, manifest: dict | None = None) -> Cell:
    manifest = load_json(MANIFEST) if manifest is None else manifest
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise BenchError(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    driver = load_module(BENCH / "drivers" / f"{mix['driver']}.py",
                         f"bench_driver_{mix['driver']}")
    e2e = [m for m in manifest["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"] if reports(m, name, names)]
    limits = load_json(BENCH / "limits" / f"{name}.json")["limits"]
    return Cell(name=name, chips=w["chips"], config=config, mix=mix,
                driver=driver, limits=limits, end_to_end=e2e, per_layer=per)


def forbidden_modules() -> list[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


# -- the device trace of a traced run ----------------------------------------

@dataclasses.dataclass
class Trace:
    """What a traced window's profile says: device time by kernel name,
    the union of device-busy intervals, the window's length, and the idle
    gaps summed by what the host was doing in the middle of each."""

    kernels: dict          # name -> [seconds, count]
    busy_s: float
    window_s: float
    gaps: dict             # host activity -> idle seconds

    @property
    def launches(self) -> int:
        return sum(n for _, n in self.kernels.values())

    def time_of(self, part: str) -> tuple[float, int]:
        """(seconds, count) summed over the kernels whose name holds
        ``part``."""
        rows = [v for k, v in self.kernels.items() if part in k]
        return sum(r[0] for r in rows), sum(r[1] for r in rows)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def read_trace(prof, window: tuple, spans: list) -> Trace:
    """Reduce a CUDA-only ``torch.profiler`` profile of one window to a
    :class:`Trace`.  Events are read straight from the trace's raw
    events.  Device events are the card's kernels, copies and sets; the
    host events are the CUDA runtime calls the trace holds and the
    harness's own ``spans``.  ``window`` and ``spans`` are on the
    trace's clock (``time.time_ns``)."""
    from torch.autograd import DeviceType
    kernels: dict = {}
    dev, host = [], list(spans)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            # host spans mirrored on the card's timeline are no device work
            if e.is_user_annotation() or e.is_async() \
                    or e.start_thread_id() != e.end_thread_id():
                continue
            s, t = e.start_ns(), e.end_ns()
            row = kernels.setdefault(e.name(), [0.0, 0])
            row[0] += (t - s) / 1e9
            row[1] += 1
            dev.append((s, t))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    w0, w1 = window
    dev.sort()
    busy, gaps, cur = 0, [], w0
    for s, t in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    return Trace(kernels=kernels, busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9,
                 gaps=_name_gaps(gaps, host))


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the host activity at each gap's middle: the
    innermost harness span ("bench.*") and the innermost CUDA runtime
    call that cover it ("-": none, the host was in Python)."""
    host.sort()
    heaps: dict = {"bench": [], "op": []}
    out: dict = {}
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            s, t, name = host[i]
            kind = "bench" if name.startswith("bench.") else "op"
            heapq.heappush(heaps[kind], (-s, t, name))
            i += 1
        names = []
        for kind in ("bench", "op"):
            h = heaps[kind]
            while h and h[0][1] < mid:
                heapq.heappop(h)
            names.append(h[0][2] if h else "-")
        key = f"{names[0]}: {names[1]}"
        out[key] = out.get(key, 0.0) + (g1 - g0) / 1e9
    return out


# -- the run a driver works in -----------------------------------------------

class Run:
    """One run of one cell: its arguments, its configuration and mix, the
    window (traced when asked), the counters a driver keeps for the
    per-layer readers, and the comparisons that decide ``correct``."""

    def __init__(self, cell: Cell, *, seed: int, seconds: float,
                 trace: bool, device):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on, self.device = trace, device
        self.config, self.mix = cell.config, cell.mix
        self.limits = cell.limits
        self.counters: dict = {}
        self.checks: list = []     # (name, value, limit): value <= limit
        self.trace: Trace | None = None
        self.spans: list = []      # (start ns, end ns, name) when traced
        self.window_start: float | None = None

    @contextlib.contextmanager
    def window(self):
        """The measured window.  Marks its start (the end of set-up) and,
        in a traced run, profiles it: CUDA activity alone (the card's
        events and the runtime calls), since recording every host
        operator as well slows a launch-bound step by half."""
        prof = None
        self.sync()
        if self.trace_on:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if self.device.type == "cuda"
                                       else ProfilerActivity.CPU])
            prof.__enter__()
        w0 = time.time_ns()
        self.window_start = time.perf_counter()
        try:
            yield
            self.sync()
        finally:
            w1 = time.time_ns()
            if prof is not None:
                prof.__exit__(None, None, None)
        if prof is not None:
            self.trace = read_trace(prof, (w0, w1), self.spans)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A harness span around a call into the program, kept on the
        trace's clock in a traced run."""
        if not self.trace_on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((t0, time.time_ns(), f"bench.{name}"))

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim
                                         in self.checks)


def device_info(device, count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
