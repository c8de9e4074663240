"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from ``--seed``, warm-up at the cell's own
shapes), then a measured window of ``--seconds``, then the comparison
with the plain reference that decides ``correct``.  With ``--trace 0``
the result line carries the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics read from the profiled window.  The last line of
standard output is the result, as one JSON object; the numbers compared
and their limits are the last lines of standard error and the last key
of the result.  Exits non-zero, with no result, without enough CUDA
cards or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# a library the port uses must not load JAX behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from bench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"bench: {msg}", file=sys.stderr)
    return code


def metric_values(run: harness.Run, cell: harness.Cell, e2e: dict) -> dict:
    """The result's metrics: the end-to-end ones the driver measured, or
    the per-layer ones their readers find (a reader that finds nothing
    returns None, and the metric is left out)."""
    out = {}
    if not run.trace_on:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        reader = harness.load_module(harness.BENCH / "metrics" /
                                     f"{m['name']}.py",
                                     f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0 or args.seconds <= 0:
        return fail("--seed must be >= 0 and --seconds > 0", 2)
    try:
        cell = harness.resolve(args.workload)
    except (harness.BenchError, OSError, KeyError) as exc:
        return fail(str(exc), 2)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"torch sees {torch.cuda.device_count()}", 3)
    device = torch.device("cuda", 0)
    run = harness.Run(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=device)
    state = cell.driver.setup(run)
    with run.window():
        e2e = cell.driver.measure(run, state)
    e2e["setup_s"] = run.window_start - T_START
    device_row = harness.device_info(device, cell.chips)
    if run.trace is not None:
        device_row["busy_s"] = run.trace.busy_s
        device_row["window_s"] = run.trace.window_s
    found = harness.forbidden_modules()
    if found:
        return fail(f"forbidden modules loaded: {', '.join(found)}", 4)
    cell.driver.check(run, state)
    del state
    result = {"correct": run.correct,
              "attempted": run.counters.get("attempted", 0),
              "failed": run.counters.get("failed", 0),
              "metrics": metric_values(run, cell, e2e),
              "device": device_row}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in run.checks}
    found = harness.forbidden_modules()
    if found:
        return fail(f"forbidden modules loaded: {', '.join(found)}", 4)
    sys.stdout.flush()
    counts = {k: v for k, v in run.counters.items()
              if k not in ("solve_s", "errors")}
    print(f"bench: counters {json.dumps(counts)}", file=sys.stderr)
    for err in run.counters.get("errors", [])[:5]:
        print(f"bench: placement failed: {err}", file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
