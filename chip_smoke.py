#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by exception:

  1. report the card (name, power limit) and build the min-plus kernel
     from ``src/repro_torch/kernels/csrc/minplus.cu``;
  2. hold the kernel bit for bit against its plain PyTorch version on the
     card, at the main path's shapes and at ragged and 1e30-laden ones;
  3. drive the main path -- the paper's §V large instance (US backbone at
     capacity scale 1e-4; 6 VGG19, 2 ResNet34, 2 hand-made models) through
     ``solve(method="greedy")`` and ``"lazy"``, then ``Plan.simulate``
     with the plan's paths and with paths re-derived by
     ``replay_solution`` -- with every launch counter set to 0 just before
     and read just after; then check the results bit for bit against the
     same solves run by the port on the CPU, and the quickstart instance
     against its golden bounds and order;
  4. time the kernel, its plain version, one closure and one greedy solve
     (median of repeated runs, after warm-up; CUDA events, host clock for
     the solve), and profile one greedy solve with ``torch.profiler``
     (device busy time by kernel, idle share).

The line before the last is a JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or run from a directory without the repository's ``src/``, it exits with a
nonzero code and prints no result.  It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent

# Golden greedy result on the quickstart instance (small topology at
# capacity scale 1e-3; 2 VGG19 + 6 ResNet34 drawn from default_rng(0)),
# captured from the JAX package's seed solver.
QUICKSTART_BOUNDS = [
    0.9737289547920227, 2.1123697757720947, 0.7822328209877014,
    0.17777971923351288, 0.17777971923351288, 0.334226131439209,
    0.25363287329673767, 0.5179324150085449,
]
QUICKSTART_ORDER = [3, 4, 6, 5, 7, 2, 0, 1]

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def paper_jobs_small(seed, registry):
    rng = np.random.default_rng(seed)
    jobs = []
    for i, kind in enumerate(["vgg19"] * 2 + ["resnet34"] * 6):
        s, d = rng.choice(5, 2, replace=False)
        jobs.append(registry.get(kind).make_job(f"{kind}-{i}", int(s), int(d)))
    return jobs


def paper_jobs_large(seed, registry, J):
    """§V US backbone: 6 VGG19 + 2 ResNet34 + 2 hand-made models."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(6):
        s, d = rng.choice(24, 2, replace=False)
        jobs.append(registry.get("vgg19").make_job(f"v{i}", int(s), int(d)))
    for i in range(2):
        s, d = rng.choice(24, 2, replace=False)
        jobs.append(registry.get("resnet34").make_job(f"r{i}", int(s), int(d)))
    for i in range(2):
        s, d = rng.choice(24, 2, replace=False)
        jobs.append(J.synthetic_job(f"syn{i}", int(s), int(d), num_layers=24,
                                    seed=seed + i, flops_scale=3e9,
                                    bytes_scale=3e6))
    return jobs


def assert_plans_equal(a, b, what: str) -> None:
    if a.order.tolist() != b.order.tolist():
        raise AssertionError(f"{what}: order {a.order} != {b.order}")
    if not np.array_equal(a.assign, b.assign):
        raise AssertionError(f"{what}: assignments differ")
    if a.bounds.tolist() != b.bounds.tolist():
        raise AssertionError(f"{what}: bounds {a.bounds} != {b.bounds}")
    for name in ("q_node", "q_link"):
        x, y = (getattr(p.net, name).cpu().numpy() for p in (a, b))
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: final {name} differs")
    if a.paths != b.paths:
        raise AssertionError(f"{what}: paths differ")


def event_ms(fn, *, reps: int, inner: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls,
    per call, in ms (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profile_solve(solvers, net, batch) -> None:
    """Device-time breakdown of one warm greedy solve (torch.profiler):
    busy time by kernel name, launches, and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solvers.solve(net, batch, method="greedy")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: operator rows (aten::...) repeat the time
    # of the kernels they launched
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0
               and not e.key.startswith(("aten::", "cuda"))]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us == 0:
        log("profile: no device time recorded (device breakdown not measured)")
        return
    log(f"profile of one greedy solve: wall {wall_us:.0f} us (profiled), "
        f"device busy {busy_us:.0f} us, idle share "
        f"{1 - busy_us / wall_us:.3f}, {sum(e.count for e in kernels)} "
        f"device kernels")
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    top += [e for e in kernels if "minplus" in e.key and e not in top]
    for e in top:
        log(f"  {e.device_time_total:9.0f} us {e.count:6d}x "
            f"({e.device_time_total / e.count:.2f} us each)  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.core import jobs as J, network as N, schedule, solvers
    from repro_torch.kernels import minplus, ops, ref

    dev = torch.device("cuda")

    # -- 1. the card and the build ------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    lib_path = minplus.build()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in minplus.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    # -- 2. the kernel against its plain version ----------------------------
    rng = np.random.default_rng(0)

    def operand(shape, inf_share=0.0):
        x = rng.uniform(0.0, 10.0, shape).astype(np.float32)
        x[rng.random(shape) < inf_share] = np.float32(1e30)
        return torch.from_numpy(x).to(dev)

    max_err = 0.0
    cases = [((62, 24, 24), (62, 24, 24), 0.0),
             ((35, 24, 24), (35, 24, 24), 0.0),
             ((24, 24), (24, 24), 0.0),
             ((3, 257, 129), (3, 129, 200), 0.0),
             ((62, 24, 24), (62, 24, 24), 0.3),
             ((3, 257, 129), (3, 129, 200), 0.3),
             ((257, 257), (257, 257), 0.1)]
    for sa, sb, inf_share in cases:
        a, b = operand(sa, inf_share), operand(sb, inf_share)
        got = minplus.minplus_matmul_batched(a, b)
        want = ref.minplus_matmul_ref(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at {sa} x {sb} "
                                 f"(1e30 share {inf_share})")
        max_err = max(max_err, float((got - want).abs().max()))
        log(f"kernel == plain bit for bit at {sa} x {sb}, 1e30 share "
            f"{inf_share}")
    w = operand((64, 24, 24), 0.5)
    got = ops.minplus_closure(w)
    want = ref.minplus_closure_ref(w)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("closure through the kernel != plain closure")
    log("closure of a [64, 24, 24] stack == plain closure bit for bit")

    # -- 3. the main path -----------------------------------------------------
    def large(device):
        net, _ = N.us_backbone(capacity_scale=1e-4, device=device)
        return net, J.batch_jobs(paper_jobs_large(0, registry, J),
                                 device=device)

    net, batch = large(dev)
    minplus.reset_launch_count()
    t0 = time.perf_counter()
    plans = {m: solvers.solve(net, batch, method=m, extract_paths=True)
             for m in ("greedy", "lazy")}
    sims = {m: p.simulate(net, batch) for m, p in plans.items()}
    resim = schedule.simulate(net, batch, plans["greedy"].assign,
                              plans["greedy"].order)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = minplus.launch_count()
    log(f"main path (greedy + lazy solves, simulate, replay+simulate) on "
        f"the card: {path_s:.2f} s wall, {launches} kernel launches")
    for m, p in plans.items():
        log(f"  {m}: order {p.order.tolist()} bound {p.bound():.6f} s "
            f"sim {sims[m].makespan:.6f} s, {p.meta['kernel_launches']} "
            f"launches, {p.meta['closure_builds']} closure builds")
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    for m, p in plans.items():
        if p.meta["kernel_launches"] == 0:
            raise AssertionError(f"{m} solve never launched the kernel")
        if not p.bound() >= sims[m].makespan:
            raise AssertionError(f"{m}: bound {p.bound()} < simulated "
                                 f"makespan {sims[m].makespan}")
        if not np.isfinite(p.bounds).all() or p.bounds.shape != (10,):
            raise AssertionError(f"{m}: bad bounds {p.bounds}")
    if not np.array_equal(resim.completion, sims["greedy"].completion):
        raise AssertionError("replayed paths simulate differently")

    cpu_net, cpu_batch = large("cpu")
    for m, p in plans.items():
        cpu_plan = solvers.solve(cpu_net, cpu_batch, method=m,
                                 extract_paths=True)
        assert_plans_equal(p, cpu_plan, f"{m} card vs CPU")
        cpu_sim = cpu_plan.simulate(cpu_net, cpu_batch)
        if not np.array_equal(cpu_sim.completion, sims[m].completion):
            raise AssertionError(f"{m}: simulated completions differ")
        log(f"  {m}: card == CPU port bit for bit (order, assign, bounds, "
            f"queues, paths, completions)")

    qnet, _ = N.small_topology(capacity_scale=1e-3, device=dev)
    qbatch = J.batch_jobs(paper_jobs_small(0, registry), device=dev)
    for m in ("greedy", "lazy"):
        qp = solvers.solve(qnet, qbatch, method=m)
        if (qp.bounds.tolist() != QUICKSTART_BOUNDS
                or qp.order.tolist() != QUICKSTART_ORDER):
            raise AssertionError(f"quickstart {m}: {qp.bounds.tolist()} "
                                 f"{qp.order.tolist()}")
    log("quickstart instance == golden bounds and order (greedy, lazy)")

    # -- 4. timings -----------------------------------------------------------
    a = operand((62, 24, 24))
    b = operand((62, 24, 24))
    kernel_ms = event_ms(lambda: minplus.minplus_matmul_batched(a, b),
                         reps=30, inner=100)
    plain_ms = event_ms(lambda: ref.minplus_matmul_ref(a, b),
                        reps=30, inner=100)
    w = operand((62, 24, 24), 0.3)
    closure_ms = event_ms(lambda: ops.minplus_closure(w), reps=30, inner=20)
    solve_ms = []
    n0 = minplus.launch_count()
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.solve(net, batch, method="greedy")
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    per_solve = (minplus.launch_count() - n0) // 20
    B, M, K, Nn = 62, 24, 24, 24
    bytes_moved = 4 * B * (M * K + K * Nn + M * Nn)
    ops_done = 2 * B * M * Nn * K
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_done / PEAK_F32_OPS_PER_S * 1e3
    log(f"timings on {smi}:")
    log(f"  kernel [62,24,24]: {kernel_ms * 1e3:.2f} us; plain version "
        f"{plain_ms * 1e3:.2f} us; bound {max(t_bytes, t_ops) * 1e3:.4f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    log(f"  closure of [62,24,24] ({ops.closure_steps(24)} squarings): "
        f"{closure_ms * 1e3:.2f} us")
    log(f"  greedy solve, §V large instance: median "
        f"{statistics.median(solve_ms):.2f} ms over 20 (min "
        f"{min(solve_ms):.2f}, max {max(solve_ms):.2f}); {per_solve} kernel "
        f"launches per solve")

    try:
        profile_solve(solvers, net, batch)
    except RuntimeError as err:     # a profiler that cannot trace here
        log(f"profile: not measured ({err})")

    print(json.dumps({"kernels": [{
        "name": "minplus_matmul_batched",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:116 "
                    "(_minplus_kernel_batched; _minplus_kernel at :43 is "
                    "its B=1 view)",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
