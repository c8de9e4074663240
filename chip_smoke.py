#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by exception:

  1. report the card (name, power limit) and build every kernel from
     ``src/repro_torch/kernels/csrc/`` (one ``nvcc`` per source, all
     started together); count the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
     load) instructions in each tensor-core library, failing if either
     is 0;
  2. hold the min-plus product kernel bit for bit against its plain
     PyTorch version on the card, at the main path's shapes and at ragged
     and 1e30-laden ones, and the closure kernel (one launch a
     ``[D, V, V]`` stack, V <= 32) against the plain closure at
     ``[64, 24, 24]`` and ``[8, 32, 32]``; a V = 40 stack takes the loop
     of products;
  3. drive the main path -- the paper's §V large instance (US backbone at
     capacity scale 1e-4; 6 VGG19, 2 ResNet34, 2 hand-made models) through
     ``solve(method="greedy")`` and ``"lazy"``, then ``Plan.simulate``
     with the plan's paths and with paths re-derived by
     ``replay_solution`` -- with every launch counter set to 0 just before
     and read just after (10 closure launches and no product launch a
     greedy solve); then check the results bit for bit against the same
     solves run by the port on the CPU, and the quickstart instance
     against its golden bounds and order;
  4. time the product kernel, its plain version, one closure (the closure
     kernel against the old loop of five product launches) and one greedy
     solve (median of repeated runs, after warm-up; CUDA events, host
     clock for the solve), and profile one greedy solve with
     ``torch.profiler`` (device busy time by kernel, idle share);
  5. hold the flash-attention forward kernels, both entry points, against
     their plain version on the card: the tensor-core kernel
     (``csrc/flash_fwd_sm90.cu``; bf16, d = dv in {64, 128}) and the
     CUDA-core kernel (``csrc/flash_fwd.cu``; the rest), at the prefill's
     shape ([36, 2048, 64] bf16, both kernels), at float32 shapes with
     d = dv and d != dv, at bf16 d = 128, at ragged and short lengths,
     causal and not;
  6. drive the serving path's prefill: ``make_prefill_step`` on
     smollm-135m at full width (random weights from seed 0), float32 with
     TF32 off at B=2, S=512 with attn_impl="flash" against "xla" (30
     launches of the CUDA-core forward); then bfloat16 at B=4, S=2048 with
     every launch counter set to 0 just before and read just after (30
     launches of the tensor-core forward, none of the CUDA-core one);
  7. drive ``DecodeEngine`` at full width (bf16, 4 prompts x 128 tokens,
     32 generated): the flash prefill's last logits against a
     ``serve_step`` loop, and both prefill modes' tokens equal;
  8. drive ``launch/serve.py``'s main path on the card (the routed plan
     through the min-plus kernel, the decode engine), its plan equal to
     the CPU port's bit for bit;
  9. time both forward kernels, their plain version and
     ``F.scaled_dot_product_attention`` (the library yardstick, never
     called by the port) at the prefill's shape, the prefill step and
     decode, and profile one prefill and one decode step with
     ``torch.profiler``;
 10. hold the flash backward kernels against their plain version on the
     card: the tensor-core dq and dk/dv (``csrc/flash_bwd_dq_sm90.cu``,
     ``csrc/flash_bwd_dkv_sm90.cu``; bf16, d = dv in {64, 128}) and the
     CUDA-core dq and dk/dv (``csrc/flash_bwd.cu``), at the training shape
     ([36, 2048, 64] bf16, all four kernels), at float32 shapes with
     d = dv and d != dv (192 -> 128), at bf16 d = 128, at ragged and short
     lengths, causal and not;
 11. drive the training path at smollm-135m's full width (random weights
     from seed 0): float32 with TF32 off at B=2, S=512, loss and grads
     with attn_impl="flash" against "xla" (the CUDA-core kernels); then
     five bfloat16 ``make_train_step`` steps at B=4, S=2048 on
     ``SyntheticStream`` batches, with every launch counter set to 0 just
     before and read just after (per step 60 launches of the tensor-core
     forward -- forward and remat recompute -- 30 of the tensor-core dq
     and 30 of the tensor-core dk/dv, none of a CUDA-core kernel); then
     ``launch/train.py``'s ``train(preset="full")`` killed by its failure
     injector and resumed from its checkpoint, against an uninterrupted
     run;
 12. time both dq and both dk/dv kernels, their plain versions and the
     backward of ``F.scaled_dot_product_attention`` (``autograd.grad`` of
     a saved forward) at the training shape, the host time of one call of
     each tensor-core backward kernel, the bf16 train step (tokens per
     second), and profile one SDPA backward and one train step;
 13. drive the scenario catalog (``repro_torch.scenarios``): each of the
     five topology families at its default traffic mix and seed 0, and a
     48-node random-geometric mesh, through Poisson arrivals
     (``arrivals.stream_times``), a greedy solve of the first 16 jobs
     committed to a ``CommittedWork`` ledger, the exact drain (indexed
     engine) to the 32nd arrival, a greedy solve of the next 16 against
     the ledger's queued state, the forked predictions and both event
     engines to completion; the min-plus counters are read and set to 0
     around each solve (V <= 24: closure kernel launches, no product;
     V = 48: product launches, no closure kernel); plans, queues and
     completions equal the port's CPU run bit for bit, the engines agree
     at rtol 1e-9, the predictions equal the realised completions, the
     simulated window 2 stays within its bound; each greedy solve timed;
 14. minicpm-2b at full width (40 layers, d 2304, 36 heads over 36 KV
     heads, random weights from seed 0): float32 with TF32 off at B=1,
     S=512, flash against xla (40 launches of the CUDA-core forward), then
     the bf16 prefill at B=4, S=2048 (40 launches of the tensor-core
     forward at [144, 2048, 64], none of the CUDA-core one, finite
     logits, peak memory); the tensor-core forward at that shape against
     its plain version, timed with its bound and SDPA; the prefill timed
     and profiled; then gemma3-1b at full width (head_dim 256, 5:1
     local/global windows), a bf16 prefill at B=1, S=2048 with no flash
     launch, timed, with its peak memory.

The line before the last is a JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or run from a directory without the repository's ``src/``, it exits with a
nonzero code and prints no result.  It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import math
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
PEAK_BF16_OPS_PER_S = 989e12        # bf16 on the tensor cores, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def count_tensor_core_sass(stem: str, lib: pathlib.Path) -> None:
    """Count the wgmma (HGMMA) and TMA load (UTMALDG) instructions in a
    tensor-core library's machine code (cuobjdump -sass); fails if either
    is missing."""
    from repro_torch.kernels._build import nvcc
    sass = subprocess.run(
        [str(pathlib.Path(nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    log(f"{stem}: SASS holds {counts['HGMMA']} HGMMA and "
        f"{counts['UTMALDG']} UTMALDG instructions")
    if not all(counts.values()):
        raise AssertionError(f"{stem}: no tensor-core product or no TMA load "
                             f"in the machine code: {counts}")


def assert_no_spills(stem: str, build_log: dict) -> None:
    """Fails if ptxas reported spills in ``stem``'s build of this process
    (read from ``-Xptxas=-v``; a library reused from an earlier build has
    no log here)."""
    lines = [ln for ln in build_log.get(stem, "").splitlines()
             if "spill" in ln]
    if not lines:
        log(f"{stem}: not built in this process; spills not read")
        return
    spilled = [ln.strip() for ln in lines
               if not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                            "spill stores, 0 bytes spill "
                                            "loads")]
    if spilled:
        raise AssertionError(f"{stem}: ptxas spilled: {spilled}")
    log(f"{stem}: ptxas reports 0 spills in each of its {len(lines)} kernel "
        f"instances (d = 64, 128)")


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


@functools.cache
def profiler_works() -> bool:
    """Whether ``torch.profiler`` can trace the card here, by profiling one
    trivial operation.  Only this probe's failure is caught: a profile of a
    real phase runs outside any ``try``, so a kernel that fails to build
    or launch there fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
    except RuntimeError as exc:
        log(f"profile: not measured (torch.profiler cannot trace: {exc})")
        return False
    return True


def profile_device(label: str, fn, *, top: int = 8) -> None:
    """Device-time breakdown of one warm call of ``fn`` (torch.profiler):
    busy time by kernel name, launches, and the device's idle share.
    Only events that ran on the card count (operator rows and
    autograd-function rows repeat the time of the kernels they
    launched)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.device_time_total > 0]
    busy_us = sum(e.device_time_total for e in kernels)
    if busy_us == 0:
        log(f"profile of {label}: no device time recorded (device "
            f"breakdown not measured)")
        return
    log(f"profile of {label}: wall {wall_us:.0f} us (profiled), device "
        f"busy {busy_us:.0f} us, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(e.count for e in kernels)} device kernels")
    rows = sorted(kernels, key=lambda e: -e.device_time_total)[:top]
    rows += [e for e in kernels if ("minplus" in e.key or "flash" in e.key)
             and e not in rows]
    for e in rows:
        log(f"  {e.device_time_total:9.0f} us {e.count:6d}x "
            f"({e.device_time_total / e.count:.2f} us each, "
            f"{e.device_time_total / busy_us:.1%})  {e.key[:80]}")


# -- phases 5-9: the serving path (flash attention, prefill, decode) ---------

# O as (atol, rtol): float32 as tests/test_kernels.py; bf16 the output's
# rounding (up to two ulps, rtol 1.6e-2) and the tensor-core forward's bf16
# P, whose rounding moves a row of few keys by up to 2^-8 sum(p |v|) / l
# (atol 4e-3; tests/test_torch_flash.py:rounded_p_forward_gate_share).  At
# [36,2048,64] the typical |O| is 0.035, so a P.V fault that shifts late
# rows by 0.01 is far outside it
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 1.6e-2)}
LSE_TOL = 1e-5
# dq, dk, dv against the plain backward, as (atol, rtol): float32 sums over
# up to S terms in another order; bf16 at most one bf16 rounding of the
# float32 result apart (one ulp <= 2^-7 |want|), with atol for values
# near 0.  At [36,2048,64] the gradients are 0.02-0.05, so a dropped key
# tile or a mis-scaled dS is far outside this; the CUDA-core kernels equal
# the plain version bit for bit in bf16 on the H100, the tensor-core dk/dv
# kernel lands within it by splitting P and dS into hi + lo bf16 (PERF.md)
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 8e-3)}
# (bh, S, d, dv, dtype, causal); the first is the prefill's per-layer shape.
# bf16 with d = dv in {64, 128} takes the tensor-core kernel, the rest the
# CUDA-core kernel (flash.kernel_variant); at the first shape both run
FLASH_CASES = [(36, 2048, 64, 64, "bfloat16", True),
               (8, 256, 64, 64, "float32", True),
               (2, 256, 192, 128, "float32", True),
               (4, 1000, 64, 64, "bfloat16", True),
               (3, 130, 64, 64, "float32", True),
               (2, 64, 64, 64, "float32", True),
               (2, 300, 64, 32, "float32", False),
               (4, 2048, 128, 128, "bfloat16", True),
               (3, 130, 64, 64, "bfloat16", True),
               (2, 64, 128, 128, "bfloat16", True),
               (1, 1, 64, 64, "bfloat16", True),
               (2, 1000, 64, 64, "bfloat16", False),
               (2, 300, 128, 128, "bfloat16", False)]
FWD_ENTRIES = ("flash_fwd_lse", "flash_attention_bhsd")
PREFILL_SHAPE = (36, 2048, 64)  # [B*H, S, hd] of one layer at B=4, S=2048
# (entry, variant) -> (name in the kernels line, source, TPU kernel)
KERNEL_ROWS = {
    ("flash_fwd_lse", "simt"): (
        "flash_fwd_lse", "flash_fwd.cu",
        "src/repro/kernels/flash.py:125 (_flash_fwd_lse_kernel, flash_fwd_lse "
        "at :259)"),
    ("flash_attention_bhsd", "simt"): (
        "flash_attention_bhsd", "flash_fwd.cu",
        "src/repro/kernels/flash.py:35 (_flash_kernel, flash_attention_bhsd "
        "at :85; not on the serving path)"),
    ("flash_fwd_lse", "sm90"): (
        "flash_fwd_lse_sm90", "flash_fwd_sm90.cu",
        "src/repro/kernels/flash.py:125 (_flash_fwd_lse_kernel, flash_fwd_lse "
        "at :259)"),
    ("flash_attention_bhsd", "sm90"): (
        "flash_attention_bhsd_sm90", "flash_fwd_sm90.cu",
        "src/repro/kernels/flash.py:35 (_flash_kernel, flash_attention_bhsd "
        "at :85; not on the serving path)"),
    ("flash_bwd_dq", "simt"): (
        "flash_bwd_dq", "flash_bwd.cu",
        "src/repro/kernels/flash.py:170 (_flash_dq_kernel; flash_bwd at :292, "
        "pallas_call :300)"),
    ("flash_bwd_dq", "sm90"): (
        "flash_bwd_dq_sm90", "flash_bwd_dq_sm90.cu",
        "src/repro/kernels/flash.py:170 (_flash_dq_kernel; flash_bwd at :292, "
        "pallas_call :300)"),
    ("flash_bwd_dkv", "simt"): (
        "flash_bwd_dkv", "flash_bwd.cu",
        "src/repro/kernels/flash.py:211 (_flash_dkv_kernel; flash_bwd at "
        ":292, pallas_call :320)"),
    ("flash_bwd_dkv", "sm90"): (
        "flash_bwd_dkv_sm90", "flash_bwd_dkv_sm90.cu",
        "src/repro/kernels/flash.py:211 (_flash_dkv_kernel; flash_bwd at "
        ":292, pallas_call :320)"),
}


def kernel_row(key, launches, err, ms, plain_ms, bound, library_ms):
    name, source, replaces = KERNEL_ROWS[key]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def fwd_call(flash, entry, variant, q, k, v, *, scale, causal):
    """(O, lse or None) of ``entry`` through ``variant``'s kernel: the public
    wrapper when the dispatch rule picks that kernel, else the wrapper's
    launcher with the variant named (the other kernel at the same inputs,
    for its check and time)."""
    if variant == flash.kernel_variant(entry, q.dtype, q.shape[2],
                                       v.shape[2]):
        if entry == "flash_fwd_lse":
            return flash.flash_fwd_lse(q, k, v, scale=scale, causal=causal)
        return flash.flash_attention_bhsd(q, k, v, scale=scale,
                                          causal=causal), None
    return flash._launch(q, k, v, scale, causal, entry, variant)


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host time to enqueue one call of ``fn`` (no synchronisation inside
    the loop), in us: at a tiny shape, the wrapper's own cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def flash_variant_counts(flash) -> dict:
    return {f"{e}/{v}": flash.launch_count(e, v) for e in flash.ENTRIES
            for v in flash.VARIANTS if flash.launch_count(e, v)}


def flash_inputs(rng, bh, s, d, dv, dtype, dev):
    import torch
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(dev, tdt) for shape in ((bh, s, d), (bh, s, d), (bh, s, dv))]


def gate_share(got, want, tol: float, rtol: float) -> float:
    """max |got - want| / (tol + rtol |want|): below 1 within the gate."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (tol + rtol * want.abs())).max())


def max_err_within(got, want, tol: float, what: str,
                   rtol: float | None = None) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + rtol * |want|
    everywhere (rtol defaults to tol), and every value is finite."""
    import torch
    rtol = tol if rtol is None else rtol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or \
            bool((diff > tol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: max |diff| {float(diff.max()):.3e} "
                             f"exceeds atol {tol} + rtol {rtol} |want|")
    return float(diff.max())


def flash_bound(bh, s, d, dv, dtype, causal, with_lse):
    """(bound in ms, "bytes" | "operations") for one flash forward: each
    input read once, each output written once; the score and P.V
    products over the (causal) pairs this input has."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = s * (s + 1) // 2 if causal else s * s
    ops_done = 2 * bh * pairs * (d + dv)
    peak = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S
    bytes_moved = bh * s * (2 * d + 2 * dv) * item + (bh * s * 4
                                                      if with_lse else 0)
    t_ops = ops_done / peak * 1e3
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def serving_phases(dev, smi: str) -> list[dict]:
    """Phases 5-9; returns the four forward entries of the kernels line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import flash, minplus, ref
    from repro_torch.launch import serve, steps
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(5)

    # -- 5. the flash forward kernels against their plain version -----------
    err = {(e, v): 0.0 for e in FWD_ENTRIES for v in flash.VARIANTS}
    for bh, s, d, dv, dtype, causal in FLASH_CASES:
        q, k, v = flash_inputs(rng, bh, s, d, dv, dtype, dev)
        scale = 1 / math.sqrt(d)
        want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale,
                                                 causal=causal)
        variants = [flash.kernel_variant("flash_fwd_lse", q.dtype, d, dv)]
        if (bh, s, d, dtype) == (*PREFILL_SHAPE, "bfloat16"):
            variants.append("simt")     # the CUDA-core kernel at the shape
        for variant in variants:
            o, lse = fwd_call(flash, "flash_fwd_lse", variant, q, k, v,
                              scale=scale, causal=causal)
            torch.cuda.synchronize()
            what = (f"flash_fwd_lse ({variant}) {dtype} [{bh},{s},{d}->{dv}] "
                    f"causal={causal}")
            atol, rtol = FLASH_TOL[dtype]
            e_o = max_err_within(o, want_o, atol, what + " O", rtol)
            e_l = max_err_within(lse, want_lse, LSE_TOL, what + " lse")
            key = ("flash_fwd_lse", variant)
            err[key] = max(err[key], e_o, e_l)
            log(f"{what}: max |O - plain| {e_o:.3e} (share of the gate "
                f"{gate_share(o, want_o, atol, rtol):.3f}), max |lse - "
                f"plain| {e_l:.3e}")
            if (s, dtype) in ((2048, "bfloat16"), (256, "float32"),
                              (1000, "bfloat16"), (130, "bfloat16")) \
                    and d == dv:
                o2, _ = fwd_call(flash, "flash_attention_bhsd", variant, q, k,
                                 v, scale=scale, causal=causal)
                torch.cuda.synchronize()
                e2 = max_err_within(o2, want_o, atol,
                                    f"flash_attention_bhsd ({variant}) "
                                    f"{dtype} [{bh},{s}]", rtol)
                key = ("flash_attention_bhsd", variant)
                err[key] = max(err[key], e2)
                log(f"  no-lse entry point at [{bh},{s},{d}]: max |O - "
                    f"plain| {e2:.3e}")

    # -- 6. full-width smollm-135m prefill ------------------------------------
    full = registry.config("smollm_135m")
    gen = torch.Generator().manual_seed(0)
    cfg32 = dataclasses.replace(full, dtype=torch.float32, attn_impl="flash")
    params32 = M.init_params(cfg32, gen, device=dev)
    log(f"smollm-135m at full width: {M.param_count(params32):,} params")
    toks = rng.integers(0, full.vocab_size, (2, 512))
    flash_step = steps.make_prefill_step(cfg32, device=dev)
    xla_step = steps.make_prefill_step(
        dataclasses.replace(cfg32, attn_impl="xla"), device=dev)
    flash.reset_launch_count()
    got = flash_step(params32, {"tokens": toks})
    want = xla_step(params32, {"tokens": toks})
    torch.cuda.synchronize()
    f32_launches = flash.launch_count("flash_fwd_lse", "simt")
    if flash_variant_counts(flash) != {"flash_fwd_lse/simt":
                                       full.num_layers}:
        raise AssertionError(f"float32 prefill: flash launches "
                             f"{flash_variant_counts(flash)}, expected "
                             f"{full.num_layers} of the CUDA-core forward")
    if got.shape != (2, 512, full.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(got.shape)}")
    e32 = max_err_within(got, want, 3e-4, "float32 prefill flash vs xla")
    log(f"float32 prefill B=2 S=512 (TF32 off): flash vs xla logits max "
        f"|diff| {e32:.3e} (tolerance 3e-4)")
    del params32, got, want

    cfg = dataclasses.replace(full, attn_impl="flash")       # bfloat16
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    step = steps.make_prefill_step(cfg, device=dev)
    batch = {"tokens": rng.integers(0, full.vocab_size, (4, 2048))}
    step(params, batch)                                      # warm-up
    torch.cuda.synchronize()
    for mod in (minplus, flash):
        mod.reset_launch_count()
    logits = step(params, batch)
    torch.cuda.synchronize()
    launches = {(e, v): flash.launch_count(e, v) for e in FWD_ENTRIES
                for v in flash.VARIANTS}
    log(f"bf16 prefill B=4 S=2048 (the serving path): flash launches by "
        f"kernel {flash_variant_counts(flash)}, "
        f"{minplus.launch_count()} min-plus launches")
    if flash_variant_counts(flash) != {"flash_fwd_lse/sm90":
                                       full.num_layers}:
        raise AssertionError(f"bf16 prefill: flash launches "
                             f"{flash_variant_counts(flash)}, expected "
                             f"{full.num_layers} of the tensor-core forward "
                             f"and none of the CUDA-core one")
    if logits.shape != (4, 2048, full.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("bf16 prefill logits not finite or misshapen")
    del logits

    # -- 7. DecodeEngine at full width ----------------------------------------
    prompts = rng.integers(0, full.vocab_size, (4, 128)).astype(np.int32)
    flash.reset_launch_count()
    last = step(params, {"tokens": prompts})[:, -1]
    serve_step = steps.make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, 4, 128, device=dev)
    ptoks = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    for i in range(128):
        dec, cache = serve_step(params, cache,
                                {"tokens": ptoks[:, i:i + 1], "pos": i})
    torch.cuda.synchronize()
    if flash.launch_count() != full.num_layers:
        raise AssertionError("prefill at S=128 did not take the flash path")
    diff = (dec - last).abs()
    if bool((diff > 0.11 + 0.05 * last.abs()).any()):
        raise AssertionError(f"decode vs flash prefill: max |diff| "
                             f"{float(diff.max()):.3e} beyond atol 0.11, "
                             f"rtol 0.05")
    log(f"bf16 serve_step loop vs flash prefill, last position: max |diff| "
        f"{float(diff.max()):.3e} (atol 0.11, rtol 0.05)")
    engine = DecodeEngine(cfg, params, max_len=128 + 32 + 8, device=dev)
    res = engine.generate(prompts, gen_len=32)
    res_pt = engine.generate(prompts, gen_len=32, prefill_mode="per_token")
    if not np.array_equal(res.tokens, res_pt.tokens):
        raise AssertionError("prefill modes emit different tokens")
    if res.tokens.shape != (4, 32) or not (
            (res.tokens >= 0) & (res.tokens < full.padded_vocab)).all():
        raise AssertionError("generated tokens out of range")
    log(f"DecodeEngine 4 x (128 + 32) bf16: prefill {res.prefill_s:.3f} s, "
        f"decode {res.decode_s:.3f} s, {res.tokens_per_s:.1f} tok/s; "
        f"per_token mode: {res_pt.tokens_per_s:.1f} tok/s, same tokens")

    # -- 8. launch/serve.py's main path on the card ---------------------------
    for mod in (minplus, flash):
        mod.reset_launch_count()
    _, plans, sres = serve.run("smollm_135m", requests=4, gen=16,
                               device=dev, verbose=False)
    torch.cuda.synchronize()
    serve_minplus = minplus.launch_count()
    if serve_minplus == 0:
        raise AssertionError("serve.py's routed plan never launched min-plus")
    _, cpu_plans, _ = serve.run("smollm_135m", requests=4, gen=1,
                                device="cpu", verbose=False)
    for a, b in zip(plans, cpu_plans):
        if (a.priority, a.bound_s, a.nodes_used) != \
                (b.priority, b.bound_s, b.nodes_used):
            raise AssertionError(f"serve plan card vs CPU: {a} != {b}")
    log(f"serve.py on the card: {len(plans)} placements == CPU port's bit "
        f"for bit, {serve_minplus} min-plus launches, "
        f"{sres.tokens_per_s:.1f} tok/s (smoke config)")

    # -- 9. timings -----------------------------------------------------------
    bh, s, d = PREFILL_SHAPE
    q, k, v = flash_inputs(rng, bh, s, d, d, "bfloat16", dev)
    scale = 1 / math.sqrt(d)
    t = {(e, var): event_ms(
        lambda e=e, var=var: fwd_call(flash, e, var, q, k, v, scale=scale,
                                      causal=True),
        reps=10 if var == "sm90" else 5, inner=10 if var == "sm90" else 5)
        for e in FWD_ENTRIES for var in flash.VARIANTS}
    t["plain"] = event_ms(lambda: ref.flash_fwd_lse_ref(q, k, v, scale=scale),
                          reps=5, inner=3)
    t["sdpa"] = event_ms(lambda: F.scaled_dot_product_attention(
        *(x.unflatten(0, (4, -1)) for x in (q, k, v)),       # [B, H, S, d]
        is_causal=True, scale=scale), reps=10, inner=10)
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    bound = {e: flash_bound(bh, s, d, d, "bfloat16", True,
                            e == "flash_fwd_lse") for e in FWD_ENTRIES}
    log(f"timings on {smi}:")
    for e, var in err:
        log(f"  {e} ({var}) [{bh},{s},{d}] bf16 causal: "
            f"{t[(e, var)] * 1e3:.1f} us per call; bound "
            f"{bound[e][0] * 1e3:.2f} us ({bound[e][1]})")
    log(f"  plain version: {t['plain'] * 1e3:.1f} us; "
        f"F.scaled_dot_product_attention (library yardstick): "
        f"{t['sdpa'] * 1e3:.1f} us")
    tiny = flash_inputs(rng, 1, 64, 64, 64, "bfloat16", dev)
    host = {var: host_us_per_call(lambda var=var: flash._launch(
        *tiny, 0.125, True, "flash_fwd_lse", var)) for var in flash.VARIANTS}
    log(f"  host time per flash_fwd_lse launch at [1,64,64] bf16: sm90 "
        f"{host['sm90']:.1f} us (three tensor maps encoded per call), simt "
        f"{host['simt']:.1f} us")
    n_fwd = launches[("flash_fwd_lse", "sm90")]
    log(f"  prefill step smollm-135m B=4 S=2048 bf16: median "
        f"{statistics.median(prefill_ms):.2f} ms over 5 (min "
        f"{min(prefill_ms):.2f}, max {max(prefill_ms):.2f}); "
        f"{n_fwd} flash launches per prefill, "
        f"{n_fwd * t[('flash_fwd_lse', 'sm90')]:.2f} ms of them by the "
        f"kernel's time per call")
    log(f"  decode (DecodeEngine, 4 x 32 tokens after 128): "
        f"{res.tokens_per_s:.1f} tok/s")
    dcache = M.init_cache(cfg, 4, 168, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    if profiler_works():
        profile_device("one prefill (B=4, S=2048, bf16)",
                       lambda: step(params, batch), top=10)
        profile_device("one decode step (B=4, bf16)", lambda: serve_step(
            params, dcache, {"tokens": tok, "pos": 128}), top=6)

    # launches: the bf16 prefill's; the CUDA-core forward's main-path run
    # is now the float32 prefill of phase 6
    launches[("flash_fwd_lse", "simt")] = f32_launches
    return [kernel_row(key, launches[key], err[key], t[key], t["plain"],
                       bound[key[0]], t["sdpa"]) for key in err]


# -- phases 10-12: the training path (flash backward, train step) ------------

# (bh, S, d, dv, dtype, causal); the first is the training path's per-layer
# shape; the dk/dv kernel is chosen as the forward is, and at the first
# shape both run
BWD_CASES = [(36, 2048, 64, 64, "bfloat16", True),
             (8, 256, 64, 64, "float32", True),
             (2, 256, 192, 128, "float32", True),
             (4, 1000, 64, 64, "bfloat16", True),
             (3, 130, 64, 64, "float32", True),
             (2, 64, 64, 64, "float32", True),
             (1, 1, 16, 16, "float32", True),
             (2, 300, 64, 32, "float32", False),
             (4, 2048, 128, 128, "bfloat16", True),
             (3, 130, 64, 64, "bfloat16", True),
             (2, 64, 128, 128, "bfloat16", True),
             (1, 1, 64, 64, "bfloat16", True),
             (2, 1000, 64, 64, "bfloat16", False),
             (2, 300, 128, 128, "bfloat16", False)]
# full-width float32 grads, flash against the XLA-style path (TF32 off):
# per leaf, max |diff| <= GRAD_REL * max |grad| of that leaf -- the same
# function summed in another order through 30 layers (7.0e-7 on an H100);
# a wrong kernel is off by O(1)
LOSS_RTOL, GRAD_REL = 1e-5, 1e-5
BWD_ENTRIES = ("flash_bwd_dq", "flash_bwd_dkv")
BWD_KERNELS = (("flash_bwd_dq", "simt"), ("flash_bwd_dq", "sm90"),
               ("flash_bwd_dkv", "simt"), ("flash_bwd_dkv", "sm90"))
TRAIN_SHAPE = (36, 2048, 64)    # [B*H, S, hd] of one layer at B=4, S=2048


def bwd_call(flash, entry, variant, q, k, v, do, lse, delta, *, scale,
             causal):
    """dq, or (dk, dv), through ``variant``'s kernel of ``entry``, as
    :func:`fwd_call`."""
    import torch
    if variant == flash.kernel_variant(entry, q.dtype, q.shape[2],
                                       v.shape[2]):
        wrapper = getattr(flash, entry)
        return wrapper(q, k, v, do, lse, delta, scale=scale, causal=causal)
    outs = ((torch.empty_like(q),) if entry == "flash_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    flash._launch_bwd(entry, q, k, v, do, lse, delta, outs, scale, causal,
                      variant)
    return outs[0] if entry == "flash_bwd_dq" else outs


def flash_bwd_bound(bh, s, d, dv, dtype, causal, entry):
    """(bound in ms, "bytes" | "operations") for one backward kernel: each
    input (q, k, v, do, lse, delta) read once, each output written once;
    the products over the (causal) pairs this input has: the dq kernel does
    Q K^T, dO V^T and dS K (2 (2d + dv) FLOP a pair), the dk/dv kernel
    Q K^T, dO V^T, P^T dO and dS^T Q (2 (2d + 2dv))."""
    item = 2 if dtype == "bfloat16" else 4
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    if entry == "flash_bwd_dq":
        ops_done, out_cols = 2 * pairs * (2 * d + dv), d
    else:
        ops_done, out_cols = 2 * pairs * (2 * d + 2 * dv), d + dv
    bytes_moved = (bh * s * (2 * d + 2 * dv + out_cols) * item
                   + 2 * bh * s * 4)
    peak = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S
    t_ops = ops_done / peak * 1e3
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def training_phases(dev, smi: str) -> list[dict]:
    """Phases 10-12; returns the four backward entries of the kernels line."""
    import tempfile

    import torch
    import torch.nn.functional as F
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import flash, minplus, ref
    from repro_torch.launch import steps, train
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(10)

    def cotangent(bh, s, dv, dtype):
        return torch.from_numpy(rng.standard_normal(
            (bh, s, dv), dtype=np.float32)).to(dev, getattr(torch, dtype))

    # -- 10. the backward kernels against their plain version ----------------
    err = dict.fromkeys(BWD_KERNELS, 0.0)
    for bh, s, d, dv, dtype, causal in BWD_CASES:
        q, k, v = flash_inputs(rng, bh, s, d, dv, dtype, dev)
        do = cotangent(bh, s, dv, dtype)
        kw = dict(scale=1 / math.sqrt(d), causal=causal)
        o, lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
        delta = ref.flash_bwd_delta(o, do)
        dq = flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv_ = flash.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        whole = flash.flash_bwd(q, k, v, o, lse, do, **kw)
        want_dq = ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
        want_dk, want_dv = ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                 **kw)
        torch.cuda.synchronize()
        variant = flash.kernel_variant("flash_bwd_dkv", q.dtype, d, dv)
        what = (f"flash_bwd ({variant}) {dtype} [{bh},{s},{d}->{dv}] "
                f"causal={causal}")
        atol, rtol = BWD_TOL[dtype]
        e_dq = max_err_within(dq, want_dq, atol, what + " dq", rtol)
        e_dkv = max(max_err_within(dk, want_dk, atol, what + " dk", rtol),
                    max_err_within(dv_, want_dv, atol, what + " dv", rtol))
        if not all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv_))):
            raise AssertionError(f"{what}: flash_bwd differs from its two "
                                 f"kernels' own launches")
        for entry, e in (("flash_bwd_dq", e_dq), ("flash_bwd_dkv", e_dkv)):
            err[(entry, variant)] = max(err[(entry, variant)], e)
        share_dkv = max(gate_share(dk, want_dk, atol, rtol),
                        gate_share(dv_, want_dv, atol, rtol))
        log(f"{what}: max |dq - plain| {e_dq:.3e} (share of the gate "
            f"{gate_share(dq, want_dq, atol, rtol):.3f}), max |dk, dv - "
            f"plain| {e_dkv:.3e} (share {share_dkv:.3f}); atol {atol}, rtol "
            f"{rtol}; flash_bwd == its kernels, bit for bit")
        if variant == "sm90" and (bh, s, d) == TRAIN_SHAPE:
            # the CUDA-core dq and dk/dv kernels at the training shape too
            dq = bwd_call(flash, "flash_bwd_dq", "simt", q, k, v, do, lse,
                          delta, **kw)
            dk, dv_ = bwd_call(flash, "flash_bwd_dkv", "simt", q, k, v, do,
                               lse, delta, **kw)
            torch.cuda.synchronize()
            e_dq = max_err_within(dq, want_dq, atol, what + " simt dq", rtol)
            e_simt = max(
                max_err_within(dk, want_dk, atol, what + " simt dk", rtol),
                max_err_within(dv_, want_dv, atol, what + " simt dv", rtol))
            err[("flash_bwd_dq", "simt")] = max(
                err[("flash_bwd_dq", "simt")], e_dq)
            err[("flash_bwd_dkv", "simt")] = max(
                err[("flash_bwd_dkv", "simt")], e_simt)
            log(f"  CUDA-core kernels at the same inputs: max |dq - plain| "
                f"{e_dq:.3e} (share of the gate "
                f"{gate_share(dq, want_dq, atol, rtol):.3f}), max |dk, dv "
                f"- plain| {e_simt:.3e}")
    del q, k, v, do, o, lse, delta, dq, dk, dv_, whole

    # -- 11. the training path at full width ---------------------------------
    full = registry.config("smollm_135m")
    cfg32 = dataclasses.replace(full, dtype=torch.float32, attn_impl="flash")
    params32 = M.init_params(cfg32, torch.Generator().manual_seed(0),
                             device=dev)
    batch32 = SyntheticStream(DataConfig(
        vocab_size=full.vocab_size, seq_len=512, global_batch=2),
        device=dev).batch_at(0)

    def loss_and_grads(cfg):
        flat = [x.detach().requires_grad_() for x in pytree.leaves(params32)]
        loss = M.loss_fn(cfg, pytree.unflatten(params32, flat), batch32)
        return loss.detach(), torch.autograd.grad(loss, flat)

    flash.reset_launch_count()
    loss_f, grads_f = loss_and_grads(cfg32)
    torch.cuda.synchronize()
    got = flash_variant_counts(flash)
    f32_launches = {e: flash.launch_count(e, "simt") for e in BWD_ENTRIES}
    want = {"flash_fwd_lse/simt": 2 * full.num_layers,
            "flash_bwd_dq/simt": full.num_layers,
            "flash_bwd_dkv/simt": full.num_layers}
    if got != want:
        raise AssertionError(f"float32 loss + grads: launches {got}, "
                             f"expected {want} (remat on, the CUDA-core "
                             f"kernels)")
    loss_x, grads_x = loss_and_grads(dataclasses.replace(cfg32,
                                                         attn_impl="xla"))
    torch.cuda.synchronize()
    rel_loss = abs(float(loss_f) - float(loss_x)) / abs(float(loss_x))
    if not math.isfinite(float(loss_f)) or rel_loss > LOSS_RTOL:
        raise AssertionError(f"float32 loss flash {float(loss_f)} vs xla "
                             f"{float(loss_x)}")
    worst = 0.0
    for key, a, b in zip((k for k, _ in pytree.items(params32)), grads_f,
                         grads_x):
        scale_b = float(b.abs().max())
        diff = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or diff > GRAD_REL * scale_b:
            raise AssertionError(f"float32 grad {key}: max |flash - xla| "
                                 f"{diff:.3e} > {GRAD_REL} x {scale_b:.3e}")
        worst = max(worst, diff / max(scale_b, 1e-30))
    log(f"float32 loss + grads B=2 S=512 (TF32 off, remat on): loss "
        f"{float(loss_f):.6f}, flash vs xla rel {rel_loss:.2e} (tolerance "
        f"{LOSS_RTOL}); worst leaf max |diff| / max |grad| {worst:.2e} "
        f"(tolerance {GRAD_REL}); launches fwd/dq/dkv {got}")
    del params32, grads_f, grads_x

    cfg = dataclasses.replace(full, attn_impl="flash")       # bfloat16
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = steps.default_optimizer(cfg)
    opt_state = opt.init(params)
    train_step = steps.make_train_step(cfg, opt, device=dev)
    data = SyntheticStream(DataConfig(vocab_size=full.vocab_size,
                                      seq_len=2048, global_batch=4),
                           device=dev)
    batches = [data.batch_at(i) for i in range(5)]
    torch.cuda.synchronize()
    for mod in (minplus, flash):
        mod.reset_launch_count()
    losses = []
    for b in batches:
        loss, params, opt_state = train_step(params, opt_state, b)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = {key: flash.launch_count(*key) for key in BWD_KERNELS}
    losses = [float(x) for x in losses]
    log(f"bf16 train steps B=4 S=2048 (the training path), 5 steps: flash "
        f"launches by kernel {flash_variant_counts(flash)}, min-plus "
        f"{minplus.launch_count()}; losses {[round(x, 4) for x in losses]}")
    per_step = {"flash_fwd_lse/sm90": 2 * full.num_layers,
                "flash_bwd_dq/sm90": full.num_layers,
                "flash_bwd_dkv/sm90": full.num_layers}
    if flash_variant_counts(flash) != {e: 5 * n for e, n in per_step.items()}:
        raise AssertionError(f"train steps: launches "
                             f"{flash_variant_counts(flash)}, expected 5 x "
                             f"{per_step} (none of a CUDA-core kernel)")
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - math.log(full.padded_vocab)) > 0.5:
        raise AssertionError(f"train losses {losses}: not finite, or step 0 "
                             f"not near ln {full.padded_vocab}")

    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(preset="full", steps=4, batch=2, seq=128, ckpt_every=2,
                  log_every=1000, device=dev)
        whole = train.train("smollm_135m", **kw)
        try:
            train.train("smollm_135m", ckpt_dir=tmp, fail_at=3, **kw)
        except RuntimeError as exc:
            if "injected node failure" not in str(exc):
                raise
        else:
            raise AssertionError("the injected failure did not fire")
        resumed = train.train("smollm_135m", ckpt_dir=tmp, **kw)
    rel = abs(resumed.losses[-1] - whole.losses[-1]) / abs(whole.losses[-1])
    if resumed.resumed_from != 2 or len(resumed.losses) != 2 or rel > 1e-4:
        raise AssertionError(f"restart: resumed from {resumed.resumed_from}, "
                             f"losses {resumed.losses} vs {whole.losses}")
    log(f"train.py full width, 4 steps at B=2 S=128, killed at step 3 and "
        f"resumed from step {resumed.resumed_from}: final loss "
        f"{resumed.losses[-1]:.6f} vs uninterrupted {whole.losses[-1]:.6f} "
        f"(rel {rel:.1e}, tolerance 1e-4)")

    # -- 12. timings ----------------------------------------------------------
    bh, s, d = TRAIN_SHAPE
    q, k, v = flash_inputs(rng, bh, s, d, d, "bfloat16", dev)
    do = cotangent(bh, s, d, "bfloat16")
    kw = dict(scale=1 / math.sqrt(d))
    o, lse = flash.flash_fwd_lse(q, k, v, **kw)
    delta = ref.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    causal = dict(causal=True)
    t = {"flash_fwd_lse": event_ms(lambda: flash.flash_fwd_lse(q, k, v, **kw),
                                   reps=10, inner=10),
         "plain_dq": event_ms(lambda: ref.flash_bwd_dq_ref(*args, **kw),
                              reps=5, inner=3),
         "plain_dkv": event_ms(lambda: ref.flash_bwd_dkv_ref(*args, **kw),
                               reps=5, inner=3)}
    for e, var in BWD_KERNELS:
        t[(e, var)] = event_ms(
            lambda e=e, var=var: bwd_call(flash, e, var, *args, **kw,
                                          **causal),
            reps=10, inner=10 if var == "sm90" else 5)
    q4, k4, v4 = (x.unflatten(0, (4, -1)).detach().requires_grad_()
                  for x in (q, k, v))                      # [B, H, S, d]
    do4 = do.unflatten(0, (4, -1))

    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, **kw)

    def sdpa_bwd():     # the backward alone, from the saved forward
        return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                   retain_graph=True)

    t["sdpa_bwd"] = event_ms(sdpa_bwd, reps=10, inner=10)
    step_ms = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(params, opt_state, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    step_med = statistics.median(step_ms)
    flash_ms = (2 * full.num_layers * t["flash_fwd_lse"]
                + full.num_layers * (t[("flash_bwd_dq", "sm90")]
                                     + t[("flash_bwd_dkv", "sm90")]))
    bound = {e: flash_bwd_bound(bh, s, d, d, "bfloat16", True, e)
             for e in BWD_ENTRIES}
    log(f"timings on {smi}:")
    for e, var in BWD_KERNELS:
        plain = t["plain_" + e.rsplit("_", 1)[1]]
        log(f"  {e} ({var}) [{bh},{s},{d}] bf16 causal: "
            f"{t[(e, var)] * 1e3:.1f} us per call; bound "
            f"{bound[e][0] * 1e3:.2f} us ({bound[e][1]}); plain version "
            f"{plain * 1e3:.1f} us")
    tiny = [torch.empty_like(x[:1, :64]).copy_(x[:1, :64]) for x in args]
    for e, maps in (("flash_bwd_dq", "four"), ("flash_bwd_dkv", "six")):
        host = {var: host_us_per_call(lambda e=e, var=var: bwd_call(
            flash, e, var, *tiny, scale=0.125, causal=True))
            for var in flash.VARIANTS}
        log(f"  host time per {e} call at [1,64,64] bf16: sm90 "
            f"{host['sm90']:.1f} us ({maps} tensor maps encoded per call), "
            f"simt {host['simt']:.1f} us")
    log(f"  F.scaled_dot_product_attention backward (library yardstick, "
        f"[4,9,{s},{d}], dq, dk and dv together, autograd.grad of a saved "
        f"forward): {t['sdpa_bwd'] * 1e3:.1f} us; flash_fwd_lse (sm90) "
        f"{t['flash_fwd_lse'] * 1e3:.1f} us")
    log(f"  train step smollm-135m B=4 S=2048 bf16 (remat): median "
        f"{step_med:.2f} ms over 5 (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}); {4 * 2048 / step_med * 1e3:.0f} tokens/s; "
        f"flash kernels {flash_ms:.2f} ms of it by their times per call "
        f"({flash_ms / step_med:.1%})")
    if profiler_works():
        profile_device("one SDPA backward (the yardstick)", sdpa_bwd, top=4)
        profile_device("one train step (B=4, S=2048, bf16)",
                       lambda: train_step(params, opt_state, batches[0]),
                       top=12)

    # launches: the bf16 train steps'; the CUDA-core kernels' main-path run
    # is now the float32 loss and grads of phase 11
    for e in BWD_ENTRIES:
        launches[(e, "simt")] = f32_launches[e]
    return [kernel_row(key, launches[key], err[key], t[key],
                       t["plain_" + key[0].rsplit("_", 1)[1]], bound[key[0]],
                       t["sdpa_bwd"]) for key in BWD_KERNELS]


def routing_phases(dev, smi: str) -> list[dict]:
    """Phases 2-4; returns the two min-plus entries of the kernels line."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import jobs as J, network as N, schedule, solvers
    from repro_torch.kernels import minplus, ops, ref

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
    closure_err = 0.0
    for shape, variant in (((64, 24, 24), "closure"),
                           ((8, 32, 32), "closure"),
                           ((4, 40, 40), "product")):
        w = operand(shape, 0.5)
        minplus.reset_launch_count()
        got = ops.minplus_closure(w)
        want = ref.minplus_closure_ref(
            w, steps=minplus.closure_steps(shape[-1]))
        torch.cuda.synchronize()
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        expected = ({"product": 0, "closure": 1} if variant == "closure"
                    else {"product": minplus.closure_steps(shape[-1]),
                          "closure": 0})
        if minplus.closure_variant(shape[-1], dev) != variant \
                or counts != expected:
            raise AssertionError(f"closure of {shape}: launches {counts}, "
                                 f"expected {expected}")
        if not torch.equal(got, want):
            raise AssertionError(f"closure of {shape} ({variant}) != plain "
                                 f"closure")
        if variant == "closure":
            closure_err = max(closure_err, float((got - want).abs().max()))
        log(f"closure of a {list(shape)} stack through the {variant} "
            f"kernel ({counts}) == plain closure bit for bit")

    # -- 3. the main path -----------------------------------------------------
    def large(device):
        net, _ = N.us_backbone(capacity_scale=1e-4, device=device)
        return net, J.batch_jobs(paper_jobs_large(0, registry, J),
                                 device=device)

    net, batch = large(dev)
    minplus.reset_launch_count()
    t0 = time.perf_counter()
    plans, per_solve = {}, {}
    for m in ("greedy", "lazy"):
        before = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        plans[m] = solvers.solve(net, batch, method=m, extract_paths=True)
        per_solve[m] = {e: minplus.launch_count(e) - before[e]
                        for e in minplus.ENTRIES}
    sims = {m: p.simulate(net, batch) for m, p in plans.items()}
    resim = schedule.simulate(net, batch, plans["greedy"].assign,
                              plans["greedy"].order)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
    log(f"main path (greedy + lazy solves, simulate, replay+simulate) on "
        f"the card: {path_s:.2f} s wall, kernel launches {launches}; per "
        f"solve {per_solve}")
    if per_solve["greedy"] != {"product": 0, "closure": 10}:
        raise AssertionError(f"greedy solve: min-plus launches "
                             f"{per_solve['greedy']}, expected 10 of the "
                             f"closure kernel (one a round) and no product")
    if per_solve["lazy"]["product"] != 0:
        raise AssertionError(f"lazy solve: product launches "
                             f"{per_solve['lazy']}")
    for m, p in plans.items():
        log(f"  {m}: order {p.order.tolist()} bound {p.bound():.6f} s "
            f"sim {sims[m].makespan:.6f} s, {p.meta['kernel_launches']} "
            f"launches, {p.meta['closure_builds']} closure builds")
    if launches["closure"] == 0:
        raise AssertionError("the main path never launched the closure "
                             "kernel")
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
    steps = minplus.closure_steps(24)

    def product_loop():     # the closure as five product launches
        d = ref.force_zero_diagonal(w)
        for _ in range(steps):
            d = ops.minplus_matmul(d, d)
        return d

    if not torch.equal(product_loop(), minplus.minplus_closure_batched(w)):
        raise AssertionError("closure kernel != the loop of products")
    closure_t = {}
    for name, fn in (("loop", product_loop),
                     ("kernel", lambda: minplus.minplus_closure_batched(w)),
                     ("kernel2", lambda: minplus.minplus_closure_batched(w)),
                     ("loop2", product_loop)):
        closure_t[name] = event_ms(fn, reps=30, inner=20)
    closure_ms = min(closure_t["kernel"], closure_t["kernel2"])
    closure_plain_ms = event_ms(
        lambda: ref.minplus_closure_ref(w, steps=steps), reps=30, inner=20)
    solve_ms = []
    n0 = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.solve(net, batch, method="greedy")
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    solve_launches = {e: (minplus.launch_count(e) - n0[e]) / 20
                      for e in minplus.ENTRIES}
    if solve_launches != {"product": 0, "closure": 10}:
        raise AssertionError(f"greedy solves: launches per solve "
                             f"{solve_launches}")
    B, M, K, Nn = 62, 24, 24, 24
    bytes_moved = 4 * B * (M * K + K * Nn + M * Nn)
    ops_done = 2 * B * M * Nn * K
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_done / PEAK_F32_OPS_PER_S * 1e3
    # the closure: W read once, D written once; five squarings' operations
    c_bytes = 2 * 4 * B * M * M / PEAK_BYTES_PER_S * 1e3
    c_ops = steps * ops_done / PEAK_F32_OPS_PER_S * 1e3
    log(f"timings on {smi}:")
    log(f"  kernel [62,24,24]: {kernel_ms * 1e3:.2f} us; plain version "
        f"{plain_ms * 1e3:.2f} us; bound {max(t_bytes, t_ops) * 1e3:.4f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    log(f"  closure of [62,24,24] ({steps} squarings), loop / kernel / "
        f"kernel / loop: " + " / ".join(
            f"{closure_t[n] * 1e3:.2f}" for n in ("loop", "kernel",
                                                  "kernel2", "loop2"))
        + f" us; plain version {closure_plain_ms * 1e3:.2f} us; bound "
        f"{max(c_bytes, c_ops) * 1e3:.4f} us "
        f"({'bytes' if c_bytes >= c_ops else 'operations'})")
    log(f"  greedy solve, §V large instance: median "
        f"{statistics.median(solve_ms):.2f} ms over 20 (min "
        f"{min(solve_ms):.2f}, max {max(solve_ms):.2f}); launches per solve "
        f"{solve_launches}")

    if profiler_works():
        profile_device("one greedy solve",
                       lambda: solvers.solve(net, batch, method="greedy"))

    return [{
        "name": "minplus_matmul_batched",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:116 "
                    "(_minplus_kernel_batched; _minplus_kernel at :43 is "
                    "its B=1 view; off the main path for V <= 32)",
        "launches": launches["product"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }, {
        "name": "minplus_closure_batched",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/minplus.cu",
        "replaces": "src/repro/kernels/minplus.py:116 "
                    "(_minplus_kernel_batched, squared closure_steps(V) "
                    "times by ops.minplus_closure at "
                    "src/repro/kernels/ops.py:141)",
        "launches": launches["closure"],
        "max_abs_err": closure_err,
        "ms": closure_ms,
        "plain_ms": closure_plain_ms,
        "bound_ms": max(c_bytes, c_ops),
        "bound_by": "bytes" if c_bytes >= c_ops else "operations",
        "library_ms": None,
    }]


# -- phase 13: the scenario catalog on the card ------------------------------

# (label, family, family options): the catalog's five families at their
# default traffic mix, and a 48-node metro edge mesh (V > 32, so its
# closures take the loop of product launches instead of the closure kernel)
CATALOG = [("paper-small", "paper-small", {}),
           ("us-backbone", "us-backbone", {}),
           ("edge-cloud", "edge-cloud", {}),
           ("random-geometric", "random-geometric", {}),
           ("star", "star", {}),
           ("random-geometric-48", "random-geometric", {"num_nodes": 48})]
CATALOG_WINDOW = 16     # jobs per arrival window


def catalog_run(family: str, opts: dict, device, take) -> dict:
    """The serving sequence on one scenario at seed 0 and ``device``.

    Poisson arrivals at 0.8 of the scenario's nominal rate; window 1 (the
    first 16 jobs) solved greedy at the fresh state and committed to a
    ``CommittedWork`` at the 16th arrival; the exact drain (indexed engine)
    to the 32nd arrival; window 2 solved against the ledger's queued state
    and committed; the forked predictions; then both engines to
    completion.  ``take()`` reads the min-plus launch counters and sets
    them to 0: it is called just before and just after each solve."""
    from repro_torch.core import (arrivals, completions as C, jobs as J,
                                  schedule, solvers)
    from repro_torch.scenarios import make_scenario

    w = CATALOG_WINDOW
    sc = make_scenario(family, 0, device=device, **opts)
    topo = sc.topology
    rate = sc.nominal_rate(0.8)
    times = list(arrivals.stream_times("poisson", np.random.default_rng(13),
                                       64 / rate, rate=rate))
    if len(times) < 2 * w:
        raise AssertionError(f"{family}: {len(times)} arrivals, need {2 * w}")
    jobs = sc.sample_jobs(np.random.default_rng(14), 2 * w)
    names = [j.name for j in jobs]
    t1, t2 = times[w - 1], times[2 * w - 1]
    b1 = J.batch_jobs(jobs[:w], pad_to=sc.max_layers, device=device)
    b2 = J.batch_jobs(jobs[w:], pad_to=sc.max_layers, device=device)
    out = {"V": sc.num_nodes, "Lmax": sc.max_layers, "mix": sc.traffic.name,
           "rate": rate, "times": (t1, t2), "solves": []}

    def solve(batch, state):
        take()
        plan = solvers.solve(topo, batch, method="greedy", state=state,
                             extract_paths=True)
        out["solves"].append(take())
        return plan

    out["plan1"] = solve(b1, topo.empty_state(clock=t1))
    led = C.CommittedWork.empty(sc.num_nodes, clock=t1).commit(
        b1, out["plan1"], names=names[:w], at=t1)
    out["queues"] = [led.queue_arrays()]
    led = C.drain_exact(topo, led, t2 - t1, engine="indexed")
    out["queues"].append(led.queue_arrays())
    out["drained"] = led.completed
    out["backlog2"] = led.backlog_seconds(topo)
    qs2 = led.queue_state(device=topo.device)
    out["plan2"] = plan2 = solve(b2, qs2)
    led = led.commit(b2, plan2, names=names[w:], at=t2)
    out["queues"].append(led.queue_arrays())
    out["preds"] = C.predict_completions(topo, led)
    out["done"] = {}
    for engine in ("indexed", "ref"):
        done, final = C.run_to_completion(topo, led, engine=engine)
        out["done"][engine] = (done, final.completed)
    sim = schedule.simulate(topo.view(qs2), b2, plan2.assign, plan2.order)
    out["sim2"] = sim.makespan
    out["timing_args"] = (topo, b2, qs2)
    return out


def catalog_phase(dev, smi: str) -> dict:
    """Phase 13; returns the path's min-plus launches by entry."""
    import torch
    from repro_torch.core import solvers
    from repro_torch.kernels import minplus

    tally = dict.fromkeys(minplus.ENTRIES, 0)

    def take():
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        minplus.reset_launch_count()
        for e in counts:
            tally[e] += counts[e]
        return counts

    minplus.reset_launch_count()
    t0 = time.perf_counter()
    runs = {label: catalog_run(family, opts, dev, take)
            for label, family, opts in CATALOG}
    torch.cuda.synchronize()
    take()
    path_s = time.perf_counter() - t0
    log(f"catalog path on the card (6 scenarios x 2 windows of "
        f"{CATALOG_WINDOW}, drains, predictions, both engines): "
        f"{path_s:.2f} s wall, min-plus launches {tally}")

    def no_take():
        return {}

    for label, family, opts in CATALOG:
        r = runs[label]
        cpu = catalog_run(family, opts, "cpu", no_take)
        v = r["V"]
        for i, counts in enumerate(r["solves"]):
            if v <= minplus.CLOSURE_MAX_V:
                ok = counts["product"] == 0 and counts["closure"] > 0
            else:
                ok = counts["closure"] == 0 and counts["product"] > 0
            if not ok:
                raise AssertionError(f"{label} (V={v}) solve {i + 1}: "
                                     f"min-plus launches {counts}")
        for key in ("plan1", "plan2"):
            assert_plans_equal(r[key], cpu[key], f"{label} {key} card vs CPU")
            if not r[key].makespan_bound < 1e29:
                raise AssertionError(f"{label} {key}: unroutable job")
        for i, (a, b) in enumerate(zip(r["queues"], cpu["queues"])):
            for x, y in zip(a, b):
                if not np.array_equal(x, y):
                    raise AssertionError(f"{label}: ledger queues after "
                                         f"step {i} differ card vs CPU")
        for key in ("rate", "times", "drained", "backlog2", "preds",
                    "done"):
            if r[key] != cpu[key]:
                raise AssertionError(f"{label}: {key} differs card vs CPU")
        done_idx, done_ref = r["done"]["indexed"][0], r["done"]["ref"][0]
        if set(done_idx) != set(done_ref) or len(done_idx) != 2 * \
                CATALOG_WINDOW:
            raise AssertionError(f"{label}: completed jobs differ")
        worst = max(abs(done_idx[n] - done_ref[n]) / abs(done_ref[n])
                    for n in done_ref)
        if worst > 1e-9:
            raise AssertionError(f"{label}: engines differ by rel {worst}")
        if r["preds"] != done_idx:
            raise AssertionError(f"{label}: predictions != realised "
                                 f"completions")
        bound2 = r["plan2"].makespan_bound
        if not r["sim2"] <= bound2 * (1 + 1e-5):
            raise AssertionError(f"{label}: simulated {r['sim2']} > bound "
                                 f"{bound2}")
        topo, b2, qs2 = r["timing_args"]
        solvers.solve(topo, b2, method="greedy", state=qs2)      # warm
        solve_ms = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solvers.solve(topo, b2, method="greedy", state=qs2)
            torch.cuda.synchronize()
            solve_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  {label}:{r['mix']} V={v} Lmax={r['Lmax']}: windows at "
            f"t={r['times'][0]:.6g}, {r['times'][1]:.6g} s; launches per "
            f"solve {r['solves']}; {len(r['drained'])} done in the drain, "
            f"window 2 solved at a backlog of {r['backlog2']:.6g} s; "
            f"bound {bound2:.6g} s >= simulated {r['sim2']:.6g} s; engines "
            f"agree to rel {worst:.1e}; predictions == realised; card == "
            f"CPU bit for bit; greedy solve (window 2, queued) median "
            f"{statistics.median(solve_ms):.2f} ms over 10 (min "
            f"{min(solve_ms):.2f}, max {max(solve_ms):.2f}) on {smi}")
    return tally


# -- phase 14: minicpm-2b and gemma3-1b at full width ------------------------

MINICPM_SHAPE = (144, 2048, 64)   # [B*H, S, hd] of one layer at B=4, S=2048


def full_width_phase(dev, smi: str) -> dict:
    """Phase 14; returns the launches, error and times of the forward
    kernels on this path (the sm90 forward timed at MINICPM_SHAPE)."""
    import gc

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import flash, ref
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(14)
    full = registry.config("minicpm_2b")
    bh, s, d = MINICPM_SHAPE
    if (4 * full.num_heads, full.head_dim, full.num_kv_heads) != \
            (bh, d, full.num_heads):
        raise AssertionError(f"minicpm-2b config: {full}")

    # the float32 check: flash (the CUDA-core forward) against xla
    cfg32 = dataclasses.replace(full, dtype=torch.float32, attn_impl="flash")
    t0 = time.perf_counter()
    params = M.init_params(cfg32, torch.Generator().manual_seed(0),
                           device=dev)
    log(f"minicpm-2b at full width: {M.param_count(params):,} params "
        f"(random, seed 0), initialised in {time.perf_counter() - t0:.1f} s")
    toks = rng.integers(0, full.vocab_size, (1, 512))
    flash.reset_launch_count()
    got = steps.make_prefill_step(cfg32, device=dev)(params,
                                                     {"tokens": toks})
    torch.cuda.synchronize()
    f32_counts = flash_variant_counts(flash)
    want = steps.make_prefill_step(dataclasses.replace(
        cfg32, attn_impl="xla"), device=dev)(params, {"tokens": toks})
    if f32_counts != {"flash_fwd_lse/simt": full.num_layers}:
        raise AssertionError(f"minicpm-2b float32 prefill: flash launches "
                             f"{f32_counts}, expected {full.num_layers} of "
                             f"the CUDA-core forward")
    if got.shape != (1, 512, full.padded_vocab):
        raise AssertionError(f"prefill logits shape {tuple(got.shape)}")
    e32 = max_err_within(got, want, 3e-4, "minicpm-2b float32 prefill flash "
                         "vs xla")
    log(f"minicpm-2b float32 prefill B=1 S=512 (TF32 off): flash vs xla "
        f"logits max |diff| {e32:.3e} (tolerance 3e-4); launches "
        f"{f32_counts}")
    del got, want

    # the bf16 prefill at B=4, S=2048: the same weights rounded to bf16
    # (what init_params draws for dtype=bf16)
    params = tree_map(lambda x: x.to(torch.bfloat16), params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, attn_impl="flash")
    step = steps.make_prefill_step(cfg, device=dev)
    batch = {"tokens": rng.integers(0, full.vocab_size, (4, 2048))}
    step(params, batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_count()
    logits = step(params, batch)
    torch.cuda.synchronize()
    bf16_counts = flash_variant_counts(flash)
    peak = torch.cuda.max_memory_allocated()
    if bf16_counts != {"flash_fwd_lse/sm90": full.num_layers}:
        raise AssertionError(f"minicpm-2b bf16 prefill: flash launches "
                             f"{bf16_counts}, expected {full.num_layers} of "
                             f"the tensor-core forward and none of the "
                             f"CUDA-core one")
    if logits.shape != (4, 2048, full.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("minicpm-2b bf16 logits not finite or "
                             "misshapen")
    del logits
    log(f"minicpm-2b bf16 prefill B=4 S=2048: flash launches {bf16_counts} "
        f"at [{bh},{s},{d}]; logits finite; peak device memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")

    # the tensor-core forward at the path's shape against its plain version
    q, k, v = flash_inputs(rng, bh, s, d, d, "bfloat16", dev)
    scale = 1 / math.sqrt(d)
    o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=True)
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale,
                                             causal=True)
    torch.cuda.synchronize()
    atol, rtol = FLASH_TOL["bfloat16"]
    what = f"flash_fwd_lse (sm90) bf16 [{bh},{s},{d}] causal"
    err = max(max_err_within(o, want_o, atol, what + " O", rtol),
              max_err_within(lse, want_lse, LSE_TOL, what + " lse"))
    log(f"{what}: max |O - plain| (and lse) {err:.3e}, share of the O gate "
        f"{gate_share(o, want_o, atol, rtol):.3f}")
    del o, lse, want_o, want_lse

    t = {"sm90": event_ms(lambda: flash.flash_fwd_lse(q, k, v, scale=scale,
                                                      causal=True),
                          reps=10, inner=10),
         "plain": event_ms(lambda: ref.flash_fwd_lse_ref(q, k, v,
                                                         scale=scale),
                           reps=5, inner=2),
         "sdpa": event_ms(lambda: F.scaled_dot_product_attention(
             *(x.unflatten(0, (4, -1)) for x in (q, k, v)), is_causal=True,
             scale=scale), reps=10, inner=10)}
    bound = flash_bound(bh, s, d, d, "bfloat16", True, True)
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(prefill_ms)
    log(f"timings on {smi}:")
    log(f"  flash_fwd_lse (sm90) [{bh},{s},{d}] bf16 causal: "
        f"{t['sm90'] * 1e3:.1f} us per call; bound {bound[0] * 1e3:.2f} us "
        f"({bound[1]}); plain version {t['plain'] * 1e3:.1f} us; "
        f"F.scaled_dot_product_attention (library yardstick) "
        f"{t['sdpa'] * 1e3:.1f} us")
    log(f"  prefill step minicpm-2b B=4 S=2048 bf16: median {med:.2f} ms "
        f"over 5 (min {min(prefill_ms):.2f}, max {max(prefill_ms):.2f}); "
        f"{4 * 2048 / med * 1e3:.0f} tokens/s; {full.num_layers} flash "
        f"launches, {full.num_layers * t['sm90']:.2f} ms of them by the "
        f"kernel's time per call")
    if profiler_works():
        profile_device("one minicpm-2b prefill (B=4, S=2048, bf16)",
                       lambda: step(params, batch), top=10)
    del params, step, q, k, v
    gc.collect()
    torch.cuda.empty_cache()

    # gemma3-1b: head_dim 256 and a 5:1 local/global pattern; every layer
    # takes the windowed path (as the reference), never the flash kernel,
    # even when the config asks for it
    gcfg = dataclasses.replace(registry.config("gemma3_1b"),
                               attn_impl="flash")
    gparams = M.init_params(gcfg, torch.Generator().manual_seed(0),
                            device=dev)
    gstep = steps.make_prefill_step(gcfg, device=dev)
    gbatch = {"tokens": rng.integers(0, gcfg.vocab_size, (1, 2048))}
    gstep(gparams, gbatch)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_count()
    glogits = gstep(gparams, gbatch)
    torch.cuda.synchronize()
    gpeak = torch.cuda.max_memory_allocated()
    if flash_variant_counts(flash):
        raise AssertionError(f"gemma3-1b prefill launched flash: "
                             f"{flash_variant_counts(flash)}")
    if glogits.shape != (1, 2048, gcfg.padded_vocab) \
            or not bool(torch.isfinite(glogits).all()):
        raise AssertionError("gemma3-1b logits not finite or misshapen")
    del glogits
    gms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gstep(gparams, gbatch)
        torch.cuda.synchronize()
        gms.append((time.perf_counter() - t0) * 1e3)
    log(f"gemma3-1b at full width: {M.param_count(gparams):,} params; bf16 "
        f"prefill B=1 S=2048: 0 flash launches (windowed path), logits "
        f"finite; median {statistics.median(gms):.2f} ms over 5 (min "
        f"{min(gms):.2f}, max {max(gms):.2f}) on {smi}; peak device memory "
        f"{gpeak / 2**30:.2f} GiB")
    del gparams, gstep
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32": f32_counts.get("flash_fwd_lse/simt", 0),
            "bf16": bf16_counts.get("flash_fwd_lse/sm90", 0),
            "err": err, "ms": t["sm90"], "plain_ms": t["plain"],
            "sdpa_ms": t["sdpa"], "bound": bound}


def merge_rows(minplus_rows: list[dict], flash_rows: list[dict],
               catalog: dict, wide: dict) -> list[dict]:
    """The kernels line.  The kernels on this run's newest paths report
    those paths' launches (the catalog's solves, minicpm-2b's prefills);
    every path's count stands in "launches_by_path", and "timed_at" names
    the shape of the row's times."""
    from repro_torch.kernels import minplus

    for row, entry in zip(minplus_rows, minplus.ENTRIES):
        row["launches_by_path"] = {"§V large solves (phase 3)":
                                   row["launches"],
                                   "catalog (phase 13)": catalog[entry]}
        row["launches"] = catalog[entry]
        row["timed_at"] = "[62,24,24] f32"
    for row in flash_rows:
        row["timed_at"] = f"[{','.join(map(str, PREFILL_SHAPE))}] bf16"
        if row["name"] == "flash_fwd_lse":
            row["launches_by_path"] = {
                "smollm-135m float32 prefill (phase 6)": row["launches"],
                "minicpm-2b float32 prefill (phase 14)": wide["f32"]}
            row["launches"] = wide["f32"]
        elif row["name"] == "flash_fwd_lse_sm90":
            row["launches_by_path"] = {
                "smollm-135m bf16 prefill (phase 6)": row["launches"],
                "minicpm-2b bf16 prefill (phase 14)": wide["bf16"]}
            row.update(launches=wide["bf16"],
                       max_abs_err=max(row["max_abs_err"], wide["err"]),
                       ms=wide["ms"], plain_ms=wide["plain_ms"],
                       bound_ms=wide["bound"][0], bound_by=wide["bound"][1],
                       library_ms=wide["sdpa_ms"],
                       timed_at=f"[{','.join(map(str, MINICPM_SHAPE))}] "
                                f"bf16")
    return minplus_rows + flash_rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash, minplus

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. the card and the build ------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    t0 = time.perf_counter()
    builds = [minplus.build] + [functools.partial(flash.build, stem)
                                for stem in flash.STEMS]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = [pool.submit(b) for b in builds]         # one nvcc each
        lib_paths = [f.result() for f in libs]
    log(f"built {', '.join(p.name for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for build_log in (minplus.build_log, *flash.build_log.values()):
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    for stem, lib in zip(flash.STEMS, lib_paths[1:]):
        if stem.endswith("_sm90"):
            count_tensor_core_sass(stem, lib)
    assert_no_spills("flash_bwd_dq_sm90", flash.build_log)

    minplus_rows = routing_phases(dev, smi)
    flash_entries = serving_phases(dev, smi)
    bwd_entries = training_phases(dev, smi)
    catalog = catalog_phase(dev, smi)
    wide = full_width_phase(dev, smi)

    rows = merge_rows(minplus_rows, flash_entries + bwd_entries, catalog,
                      wide)
    log(f"phases 1-14 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
