#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run by exception:

  1. report the card (name, power limit) and build every kernel from
     ``src/repro_torch/kernels/csrc/`` (one ``nvcc`` per source, all
     started together); print ptxas's registers and spills for every
     kernel instance, failing on a spill in a tensor-core library or in
     the fused AdamW; count
     the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in
     each tensor-core library, failing if either is 0;
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
     (``csrc/flash_fwd_sm90.cu``; bf16 at (d, dv) in {(64, 64), (128, 128),
     (96, 96), (192, 128)}) and the CUDA-core kernel (``csrc/flash_fwd.cu``;
     the rest), at the prefill's shape ([36, 2048, 64] bf16, both kernels),
     at float32 shapes with d = dv and d != dv, at bf16 d = 128, at bf16
     (96, 96) and (192, 128) (both kernels at phi-3-vision's [32, 2624, 96]
     and MLA's [128, 2048, 192 -> 128]), at ragged and short lengths,
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
     ``csrc/flash_bwd_dkv_sm90.cu``; bf16 at (d, dv) in {(64, 64),
     (128, 128), (96, 96), (192, 128)}) and the CUDA-core dq and dk/dv
     (``csrc/flash_bwd.cu``), at the training shape ([36, 2048, 64] bf16,
     all four kernels), at float32 shapes with d = dv and d != dv
     (192 -> 128), at bf16 d = 128, at bf16 d = 96 and 192 -> 128 (the
     tensor-core dq and dk/dv, at [32, 2624, 96] and
     [128, 2048, 192 -> 128], ragged, short and not causal), at ragged and
     short lengths, causal and not;
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
     launch, timed, with its peak memory;
 15. drive the rest of serving (``repro_torch.serving``: the online
     scheduler, the exact drain, the stream, the fault layer), once on
     the card and once on the CPU, every result but the walls equal:
     the fluid ``run_online`` on paper-small (its 24 backlogs and
     latencies equal the golden ones with ``==``) and the stream at
     delta = 0, B = 1 against it; exact online runs on edge-cloud:lm and
     us-backbone:paper (48 arrivals of 4 jobs at 0.9 of nominal load,
     commit log, finished: completions equal the replay, every bound
     holds, the share of submits that met a real queue printed and held
     at >= 1/2); ``schedule_windows`` against sequential
     ``schedule_jobs``; a batched stream whose solves take up to four
     queued windows; the five fault families under requeue and migrate
     on edge-cloud:lm (replay parity; the transient node's post-recovery
     backlog bounded, as the JAX package's fault gate holds it); the
     min-plus counters set to 0 around each path and each solve (one
     closure launch a job for greedy and migrate, no product); the
     per-submit, per-window and migrate solve walls, a profile of one
     window solve, and a stream under measured solver latency after
     warm-up (printed);
 16. drive Algorithm 2 and the exact oracles (``repro_torch.core``
     ``annealing``, ``exact``, ``bounds``) on paper-small (the quickstart
     instance, V = 5, 8 jobs), once on the card and once on the CPU, all
     equal bit for bit: SA at d = 0.9 with 2 chains from a random and a
     greedy start, each on one ``DrawTape``; greedy; exact on 4 jobs;
     Lemma 8's bounds, alpha and Corollary 1's factor; the min-plus
     counters set to 0 around each solve (one closure launch a job
     evaluated, routed or replayed: K (iters + 1) J + J for SA, plus J
     for the greedy start; ``n_routings`` for exact; 1 for the bounds; no
     product); then the paper's Fig. 5 schedule on the card (d = 0.995,
     4 chains, or one when the d = 0.9 runs estimate it above 120 s)
     beside greedy's ``solve_s`` and their ratio, and a profile of a
     20-iteration SA;
 17. olmoe-1b-7b at full width (16 layers, 16 heads of 128, 64 experts
     top-8; random weights from seed 0): float32 with TF32 off at B=1,
     S=512, flash against xla (16 CUDA-core forward launches; logits at
     3e-4 on the positions before any token whose experts differ between
     the runs); the bf16 prefill at B=4, S=2048 (16 launches of the
     tensor-core forward at [64, 2048, 128], none of the CUDA-core one;
     finite logits, peak memory, the share of token-slots dropped by
     capacity); ``DecodeEngine`` against a ``serve_step`` loop; then
     deepseek-v2 at full width cut to one layer (MLA 192 -> 128, 160
     experts top-6, 2 shared): float32 flash against xla (the CUDA-core
     forward), the absorbed latent decode of 8 tokens against the
     materialized prefill, the bf16 prefill at B=1, S=2048 (one launch of
     the tensor-core forward); each model's forward kernel at its shape
     against its plain version, timed with its bound and SDPA (at MLA's
     shape the CUDA-core forward too); each prefill timed and profiled,
     with the flash kernels' share of the profile's busy time;
 18. the last four families at full width (random weights from seed 0;
     every config with attn_impl="flash"): xlstm-125m (12 layers of
     mLSTM / sLSTM), zamba2-2.7b (54 Mamba2 layers, a shared attention
     block every 6), whisper-base (6 + 6 layers, 1,500 frames) each
     float32 with TF32 off, card against the port's CPU run on the same
     weights (the last prefill logits, 4 decode steps and every state
     leaf after each, at 2e-4); phi-3-vision-4.2b (32 layers, head width
     96, 576 patches) float32 flash against xla at 576 + 512 tokens (32
     CUDA-core forward launches); then for each the bf16 prefill (xlstm
     B=4 S=1024, zamba2 B=1 S=512, whisper B=4 x 1,500 frames with S=448,
     phi-3-vision B=1 with 576 patches + 2048 tokens) with every launch
     counter set to 0 just before and read just after (32 tensor-core and
     no CUDA-core forward launches for phi-3-vision, no flash launch
     for the others), finite logits, peak memory, timed; decode ==
     prefill over 32 tokens at the reference's tolerance, a
     ``DecodeEngine`` run of 32 tokens equal to a ``serve_step`` loop's
     (whisper with ``enc_out``), a profiled decode step and prefill (the
     recurrent families' at S = 128; phi-3-vision's with the flash
     kernels' share of busy time); the tensor-core and the CUDA-core
     forward at [32, 2624, 96] bf16 against their plain version, timed
     with their bound and SDPA; ``launch/serve.run("whisper_base")``'s
     plan on the card equal to the CPU port's bit for bit;
 19. every family's training on the card: the bf16 dk/dv (tensor-core by
     rule, CUDA-core forced) and the dq (the same two) at phi-3-vision's
     [32, 2624, 96], MLA's [128, 2048, 192 -> 128] and olmoe's
     [64, 2048, 128] against their plain versions, timed with their
     bounds and SDPA's backward; the six non-dense smoke configs in float32 (TF32 off,
     flash, remat), card against the CPU port (the MoE expert choices
     equal first, then the loss at rtol 1e-5 and every gradient leaf at
     atol 1e-5 + rtol 1e-4), with phi-3-vision (also at full width, one
     layer) and deepseek-v2 flash against xla on the card; three bf16
     ``make_train_step`` steps with remat of olmoe-1b-7b (B=4 S=2048),
     phi-3-vision-4.2b (B=1, 576 standard-normal patches + 2048; zero
     patches overflow its gradients at depth, in the JAX package too),
     zamba2-2.7b (B=1 S=512), xlstm-125m (B=4 S=256) and whisper-base
     (B=4, 1,500 zero frames, S=448), at full width and at the depth
     ``train_depths``' memory reckoning allows (weights from phases
     17-18, seed 0), every launch counter set to 0 before each step and
     read after it (per layer two forwards, one dq, one dk/dv:
     tensor-core for olmoe and phi-3-vision, none of a CUDA-core kernel;
     none for the others; each step's AdamW apply through the fused
     kernel of ``csrc/adamw.cu``, one sumsq and one update launch a
     non-empty leaf and one finalize, no per-leaf apply),
     finite, timed, peak memory, a profiled step (the recurrent families'
     at S = 64; phi-3-vision's with the flash kernels' share of busy
     time); at olmoe-1b-7b's and whisper-base's trained leaves (the
     gradients of one more batch) the fused AdamW against
     ``AdamW._per_leaf``: the norm within 1e-5 and two calls equal bit
     for bit, the clip scale equal to the per-leaf expression's, p, m
     and v equal leaf by leaf, bit for bit; a whole fused apply and a
     whole per-leaf apply timed with their bound; ``grad_compress`` over one olmoe layer's bf16 gradients, card
     == CPU bit for bit; deepseek-v2's one full-width layer's bf16 loss
     and gradients (B=1 S=2048; launches as phi-3-vision's); the six
     smoke ``train()`` runs in float32 card == CPU, whisper-base's killed
     and resumed; smollm-135m's bf16 step under ``remat_policy="dots"``
     against "full" (loss and launches equal, peak memory);
 20. the production-mesh dry-run (``launch/dryrun.py``): every (arch x
     shape x mesh) cell's record without a process group, each ``ok`` or
     ``skip``; olmo-1b's ``train_4k`` and ``prefill_32k`` steps on the
     256-chip mesh run over DTensors on a fake process group, each
     ``ok`` with its collectives counted; rank 0's local shards of the
     params, AdamW's m / v and the batch of smollm-135m and olmoe-1b-7b
     at ``train_4k``, and of smollm-135m's params, batch and cache at
     ``decode_32k``, made on the card, their storage bytes equal to the
     record's ``memory.argument_bytes``; the port's lint over the
     shipped tree, 0 violations.

The line before the last is a JSON object listing every ported kernel
and the port's own fused AdamW;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or run from a directory without the repository's ``src/``, it exits with a
nonzero code and prints no result.  It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import collections
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
    log(f"{stem}: ptxas reports 0 spill bytes in each of its {len(lines)} "
        f"kernel instances")


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


def device_kernel_times(prof) -> dict:
    """name -> [busy us, count] of the events a profile saw run on the
    card (kernels, copies, sets), summed as ``key_averages()`` sums their
    ``device_time_total``, but read straight from the trace's raw events:
    ``key_averages`` first builds a Python event of every host operator
    too, which takes tens of seconds for the tens of thousands of
    launches of a recurrent step."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_async() \
                or e.start_thread_id() != e.end_thread_id():
            continue
        row = out[e.name()]
        row[0] += (e.end_ns() - e.start_ns()) / 1e3
        row[1] += 1
    return {k: v for k, v in out.items() if v[0] > 0}


def profile_device(label: str, fn, *, top: int = 8) -> dict | None:
    """Device-time breakdown of one warm call of ``fn`` (torch.profiler):
    busy time by kernel name, launches, and the device's idle share.
    Only events that ran on the card count (operator rows and
    autograd-function rows repeat the time of the kernels they
    launched).  Returns the profiled wall, the busy time and the flash
    kernels' busy time (us), or None where nothing ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernel_times(prof)
    busy_us = sum(us for us, _ in kernels.values())
    if busy_us == 0:
        log(f"profile of {label}: no device time recorded (device "
            f"breakdown not measured)")
        return None
    log(f"profile of {label}: wall {wall_us:.0f} us (profiled), device "
        f"busy {busy_us:.0f} us, idle share {1 - busy_us / wall_us:.3f}, "
        f"{sum(n for _, n in kernels.values())} device kernels")
    rows = sorted(kernels, key=lambda k: -kernels[k][0])[:top]
    rows += [k for k in kernels if ("minplus" in k or "flash" in k)
             and k not in rows]
    for k in rows:
        us, n = kernels[k]
        log(f"  {us:9.0f} us {n:6d}x ({us / n:.2f} us each, "
            f"{us / busy_us:.1%})  {k[:80]}")
    return {"wall_us": wall_us, "busy_us": busy_us,
            "flash_us": sum(us for k, (us, _) in kernels.items()
                            if "flash" in k)}


def log_flash_share(label: str, prof: dict | None, wall_ms: float,
                    before: str) -> None:
    """One line: ``label``'s wall (host clock, median) and the flash
    kernels' share of the profile's busy time, beside ``before`` (the
    same figures of an earlier PR's run)."""
    share = ("not measured" if prof is None
             else f"{prof['flash_us'] / prof['busy_us']:.1%} of busy "
             f"({prof['flash_us'] / 1e3:.2f} of {prof['busy_us'] / 1e3:.2f}"
             f" ms)")
    log(f"  {label}: wall {wall_ms:.2f} ms; flash kernels {share}; "
        f"earlier (PERF.md, same card): {before}")


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
# bf16 at (d, dv) in {(64, 64), (128, 128), (96, 96), (192, 128)} takes the
# tensor-core kernel, the rest the CUDA-core kernel (flash.kernel_variant);
# at BOTH_FWD_SHAPES both run
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
               (2, 300, 128, 128, "bfloat16", False),
               # bf16 at phi-3-vision's (96, 96) and MLA's (192, 128): the
               # paths' shapes, ragged, not causal and short
               (32, 2624, 96, 96, "bfloat16", True),
               (128, 2048, 192, 128, "bfloat16", True),
               (4, 1000, 96, 96, "bfloat16", True),
               (4, 1000, 192, 128, "bfloat16", True),
               (2, 300, 96, 96, "bfloat16", False),
               (2, 300, 192, 128, "bfloat16", False),
               (1, 1, 96, 96, "bfloat16", True),
               (3, 130, 192, 128, "bfloat16", True)]
# [bh, S, d, dv] bf16 where phase 5 holds the CUDA-core forward beside the
# tensor-core one: the smollm prefill's, phi-3-vision's and MLA's shapes
BOTH_FWD_SHAPES = ((36, 2048, 64, 64), (32, 2624, 96, 96),
                   (128, 2048, 192, 128))
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
        if dtype == "bfloat16" and (bh, s, d, dv) in BOTH_FWD_SHAPES:
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
                              (1000, "bfloat16"), (130, "bfloat16")):
                o2, _ = fwd_call(flash, "flash_attention_bhsd", variant, q, k,
                                 v, scale=scale, causal=causal)
                torch.cuda.synchronize()
                e2 = max_err_within(o2, want_o, atol,
                                    f"flash_attention_bhsd ({variant}) "
                                    f"{dtype} [{bh},{s}]", rtol)
                key = ("flash_attention_bhsd", variant)
                err[key] = max(err[key], e2)
                log(f"  no-lse entry point at [{bh},{s},{d}->{dv}]: max "
                    f"|O - plain| {e2:.3e}")

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
# shape; each entry's kernel is flash.kernel_variant's (bf16 at (64, 64),
# (128, 128), (96, 96) and (192, 128): the tensor-core dq and dk/dv), and
# at the first shape both variants of each run
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
             (2, 300, 128, 128, "bfloat16", False),
             # bf16 at phi-3-vision's 96 and MLA's 192 -> 128: the
             # tensor-core dq and dk/dv, at the train paths' shapes,
             # ragged, not causal and short
             (32, 2624, 96, 96, "bfloat16", True),
             (128, 2048, 192, 128, "bfloat16", True),
             (4, 1000, 96, 96, "bfloat16", True),
             (4, 1000, 192, 128, "bfloat16", True),
             (2, 300, 96, 96, "bfloat16", False),
             (2, 300, 192, 128, "bfloat16", False),
             (1, 1, 96, 96, "bfloat16", True),
             (1, 1, 192, 128, "bfloat16", True),
             # olmoe-1b-7b's train step (B=4, 16 heads of 128): the
             # tensor-core dq and dk/dv at the shape phase 19 runs them
             (64, 2048, 128, 128, "bfloat16", True)]
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
        variant = flash.kernel_variant("flash_bwd_dq", q.dtype, d, dv)
        what = (f"flash_bwd ({variant}) {dtype} [{bh},{s},{d}->{dv}] "
                f"causal={causal}")
        atol, rtol = BWD_TOL[dtype]
        e_dq = max_err_within(dq, want_dq, atol, what + " dq", rtol)
        e_dkv = max(max_err_within(dk, want_dk, atol, what + " dk", rtol),
                    max_err_within(dv_, want_dv, atol, what + " dv", rtol))
        if not all(torch.equal(a, b) for a, b in zip(whole, (dq, dk, dv_))):
            raise AssertionError(f"{what}: flash_bwd differs from its two "
                                 f"kernels' own launches")
        for key, e in ((("flash_bwd_dq", variant), e_dq),
                       (("flash_bwd_dkv", variant), e_dkv)):
            err[key] = max(err[key], e)
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

    got, _ = flash_vs_xla_grads("smollm-135m B=2 S=512 (remat on)", cfg32,
                                params32, batch32, dev)
    f32_launches = {e: flash.launch_count(e, "simt") for e in BWD_ENTRIES}
    want = {"flash_fwd_lse/simt": 2 * full.num_layers,
            "flash_bwd_dq/simt": full.num_layers,
            "flash_bwd_dkv/simt": full.num_layers}
    if got != want:
        raise AssertionError(f"float32 loss + grads: launches {got}, "
                             f"expected {want} (remat on, the CUDA-core "
                             f"kernels)")
    del params32

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


# -- phase 15: the rest of serving on the card -------------------------------

# The fluid online trajectory on paper-small at 0.6 of nominal load, seed 7,
# 24 arrivals, captured from the JAX package before its committed-work
# ledger landed (the JAX package's benchmarks/common.py:FLUID_GOLD_*,
# copied here: this script imports nothing of the JAX package)
FLUID_GOLD_BACKLOGS = [
    0.03644493898639235, 0.03644493898639235, 0.03644493898639235,
    0.19632062866064648, 0.19005575557234186, 0.19632062866064648,
    0.23074857432573082, 0.03644493898639235, 0.03644493898639235,
    0.03644493898639235, 0.19632062866064648, 0.16821560664505564,
    0.03644493898639235, 0.19632062866064648, 0.19632062866064648,
    0.1868424844665341, 0.03644493898639235, 0.03644493898639235,
    0.03644493898639235, 0.03644493898639235, 0.05736757877488801,
    0.24127095278122912, 0.03644493898639235, 0.03644493898639235,
]
FLUID_GOLD_LATENCIES = [
    0.07911159098148346, 0.07911159098148346, 0.07911159098148346,
    0.2389872968196869, 0.23272264003753662, 0.2389872968196869,
    0.2840821146965027, 0.07911159098148346, 0.07911159098148346,
    0.07911159098148346, 0.2389872968196869, 0.21088248491287231,
    0.07911159098148346, 0.2389872968196869, 0.2389872968196869,
    0.2295093536376953, 0.07911159098148346, 0.07911159098148346,
    0.07911159098148346, 0.07911159098148346, 0.11070089042186737,
    0.2879980802536011, 0.07911159098148346, 0.07911159098148346,
]
# exact online runs: (family at its default mix, load), arrivals, jobs each
ONLINE_CASES = (("edge-cloud", 0.9), ("us-backbone", 0.9))
ONLINE_ARRIVALS, ONLINE_BATCH = 48, 4
# faults: the JAX package's fault_bench --smoke case (edge-cloud:lm, 32
# arrivals at 0.85 of nominal, seed 7), every family, two policies
FAULT_ARRIVALS, FAULT_LOAD, FAULT_SEED = 32, 0.85, 7
FAULT_POLICIES = ("requeue", "migrate")
REPLAY_EPS_S = 1e-6
# the fused stream: paper-small at 1.5 of nominal, a 0.5-gap window of up to
# 8 requests, a solver modeled at 4 gaps a solve, so windows queue up and
# each solve takes up to 4 of them through schedule_windows
STREAM_ARRIVALS = 24


def wall_free(tr) -> dict:
    """A trace's ``to_dict()`` through JSON, wall-clock fields taken out."""
    d = json.loads(json.dumps(tr.to_dict()))
    for w in d.get("window_records", ()):
        w.pop("solve_wall_s")
    d.pop("compile_wall_s", None)
    return d


def record_rows(tr) -> list:
    return [(r.time, r.names, r.latencies, r.backlog_before, r.backlog_after)
            for r in tr.records]


def post_recovery(tr, recover_t: float, mean_service_s: float):
    """fault_bench's boundedness reading: the backlog slope from the first
    to the last commit at or after the recovery, and the last backlog;
    bounded when the slope is negative or the last backlog is under one
    mean service time."""
    post = [(r.time, r.backlog_after) for r in tr.records
            if r.time >= recover_t]
    slope = None
    if len(post) >= 2:
        (t0, b0), (t1, b1) = post[0], post[-1]
        slope = (b1 - b0) / max(t1 - t0, 1e-9)
    final = post[-1][1] if post else None
    bounded = ((slope is not None and slope < 0)
               or (final is not None and final <= mean_service_s))
    return slope, final, bounded


def serving_stack_run(device, take) -> dict:
    """The serving stack on ``device``; every field but the walls is
    compared card against CPU.  ``take()`` reads the min-plus launch
    counters and sets them to 0."""
    from repro_torch.core import jobs as J, solvers
    from repro_torch.scenarios import make_scenario
    from repro_torch.serving import faults as F
    from repro_torch.serving.online import OnlineScheduler, run_online
    from repro_torch.serving.stream import run_stream

    out = {"launches": {}, "walls": {}}

    def scenario(name):
        return make_scenario(name, seed=0, device=device)

    # the fluid gold, and the stream at delta = 0, B = 1 against it
    rate = scenario("paper-small").nominal_rate(0.6)
    kw = dict(horizon=24 / rate, seed=7, rate=rate)
    take()
    gold = run_online(scenario("paper-small"), **kw)
    out["launches"]["fluid gold"] = take()
    out["gold"] = (gold.backlogs.tolist(), gold.latencies.tolist())
    serial = run_stream(scenario("paper-small"), window_s=0.0, max_batch=1,
                        solver_latency=0.0, **kw)
    take()
    out["stream_serial"] = (record_rows(serial) == record_rows(gold)
                            and serial.events == gold.events)
    out["gold_trace"] = wall_free(gold)

    # exact online runs with real queues
    for family, load in ONLINE_CASES:
        sc = scenario(family)
        rate = sc.nominal_rate(load)
        take()
        tr = run_online(sc, horizon=ONLINE_ARRIVALS / rate, seed=7,
                        rate=rate, batch_size=ONLINE_BATCH, drain="exact",
                        track_commits=True, finish=True,
                        sim_engine="indexed")
        out["launches"][f"online {family}"] = take()
        jobs = sum(len(r.names) for r in tr.records)
        gap = max(abs(tr.completions[n] - tr.replay_completions[n])
                  - 1e-9 * abs(tr.replay_completions[n])
                  for n in tr.replay_completions)
        if set(tr.completions) != set(tr.replay_completions) or gap > 1e-9:
            raise AssertionError(f"online {family}: completions != replay")
        act, bound = tr.actual_latencies(), tr.latencies
        if act.size != bound.size or not (
                act <= bound * (1 + 1e-6) + 1e-9).all():
            raise AssertionError(f"online {family}: a bound fails")
        out[f"online {family}"] = wall_free(tr)
        out["walls"][f"online {family}"] = [r.solve_s for r in tr.records]
        out[f"share {family}"] = (
            sum(r.backlog_before > 0 for r in tr.records) / len(tr.records),
            len(tr.records), jobs, tr.summary()["max_backlog_s"])

    # per-solve launch counts: a greedy window and a migrate solve
    sc = scenario("us-backbone")
    wjobs = sc.sample_jobs(np.random.default_rng(3), 8)
    sched = OnlineScheduler(sc.topology, drain="exact")
    sched.submit_jobs(0.0, wjobs[:4], pad_to=sc.max_layers)
    sched.advance_to(0.5 * sched.last_plan.makespan_bound)
    window = J.batch_jobs(wjobs[4:], pad_to=sc.max_layers, device=device)
    take()
    plan = solvers.solve(sched._effective_topology(), window,
                         state=sched.state)
    out["launches"]["greedy window of 4"] = take()
    mig = solvers.solve(sched._effective_topology(), window,
                        method="migrate", state=sched.state)
    out["launches"]["migrate of 4"] = take()
    out["window_plans"] = [(p.order.tolist(), p.assign.tolist(),
                            p.bounds.tolist()) for p in (plan, mig)]
    out["timing_args"] = (sched, window)

    # schedule_windows == W schedule_jobs calls; the fused stream
    sc = scenario("edge-cloud")
    fused = OnlineScheduler(sc.topology, drain="exact")
    seq = OnlineScheduler(sc.topology, drain="exact")
    sjobs = sc.sample_jobs(np.random.default_rng(2), 7)
    wins = [sjobs[:2], sjobs[2:3], sjobs[3:]]
    got = fused.submit_windows(0.0, wins, pad_to=sc.max_layers)
    want = [seq.schedule_jobs(w, pad_to=sc.max_layers) for w in wins]
    out["windows_equal"] = (
        [[(p.job_name, p.priority, p.bound_s, p.assign.tolist())
          for p in w] for w in got]
        == [[(p.job_name, p.priority, p.bound_s, p.assign.tolist())
             for p in w] for w in want]
        and fused.ledger.queue_arrays()[1].tolist()
        == seq.ledger.queue_arrays()[1].tolist())
    rate = scenario("paper-small").nominal_rate(1.5)
    take()
    tr = run_stream(scenario("paper-small"),
                    horizon=STREAM_ARRIVALS / rate, seed=4, rate=rate,
                    window_s=0.5 / rate, max_batch=8, fuse_windows=4,
                    solver_latency=4 / rate, drain="exact",
                    track_commits=True, finish=True)
    out["launches"]["fused stream"] = take()
    per_commit = collections.Counter(w.commit_s for w in tr.windows)
    if max(per_commit.values()) < 2:
        raise AssertionError("fused stream: no solve took two windows")
    out["fused stream"] = wall_free(tr)
    out["fused per solve"] = max(per_commit.values())
    out["fused requests"] = len(tr.requests)
    out["walls"]["fused stream"] = [w.solve_wall_s for w in tr.windows]

    # faults: every family x policy on edge-cloud:lm, exact drain
    out["faults"] = {}
    for family in sorted(F.FAULT_FAMILIES):
        for policy in FAULT_POLICIES:
            sc = scenario("edge-cloud")
            rate = sc.nominal_rate(FAULT_LOAD)
            horizon = FAULT_ARRIVALS / rate
            events = F.make_fault_schedule(family, sc, horizon,
                                           seed=FAULT_SEED)
            take()
            tr = run_online(sc, horizon=horizon, rate=rate, seed=FAULT_SEED,
                            drain="exact", track_commits=True, finish=True,
                            fault_schedule=events, recovery=policy)
            out["launches"][f"faults {family}/{policy}"] = take()
            cc, rr = tr.completions, tr.replay_completions
            gap = max(abs(cc[n] - rr[n]) for n in cc) if cc else 0.0
            if set(cc) != set(rr) or gap > REPLAY_EPS_S:
                raise AssertionError(f"faults {family}/{policy}: replay "
                                     f"parity fails (gap {gap})")
            slope, final, bounded = post_recovery(
                tr, max(e.time for e in events), sc.mean_service_s)
            if family == "transient-node" and not bounded:
                raise AssertionError(f"faults {family}/{policy}: backlog "
                                     f"not bounded after recovery")
            out["faults"][family, policy] = (
                wall_free(tr), gap, slope, final, bounded, len(tr.lost))
    return out


def serving_stack_phase(dev, smi: str) -> dict:
    """Phase 15; returns the path's min-plus launches by entry."""
    import torch
    from repro_torch.core import solvers
    from repro_torch.kernels import minplus
    from repro_torch.scenarios import make_scenario
    from repro_torch.serving.stream import run_stream

    tally = dict.fromkeys(minplus.ENTRIES, 0)

    def take():
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        minplus.reset_launch_count()
        for e in counts:
            tally[e] += counts[e]
        return counts

    minplus.reset_launch_count()
    t0 = time.perf_counter()
    card = serving_stack_run(dev, take)
    torch.cuda.synchronize()
    take()
    card_s = time.perf_counter() - t0
    path = dict(tally)
    log(f"serving stack on the card (fluid gold, 2 exact online runs of "
        f"{ONLINE_ARRIVALS} x {ONLINE_BATCH}, streams, 10 faulted runs): "
        f"{card_s:.2f} s wall, min-plus launches {path}")

    def no_take():
        return {}

    t0 = time.perf_counter()
    cpu = serving_stack_run("cpu", no_take)
    log(f"the same sequence on the CPU: {time.perf_counter() - t0:.2f} s")
    walls = card.pop("walls")
    sched, window = card.pop("timing_args")
    cpu.pop("walls"), cpu.pop("timing_args"), cpu.pop("launches")
    launches = card.pop("launches")
    for key in cpu:
        if card[key] != cpu[key]:
            raise AssertionError(f"phase 15: {key} differs card vs CPU")
    if card["gold"] != (FLUID_GOLD_BACKLOGS, FLUID_GOLD_LATENCIES):
        raise AssertionError("fluid online trajectory != FLUID_GOLD")
    if not card["stream_serial"]:
        raise AssertionError("stream at delta=0, B=1 != the serial loop")
    if not card["windows_equal"]:
        raise AssertionError("schedule_windows != sequential schedule_jobs")
    # every solve of this path is greedy (or migrate) at V <= 32: one
    # closure launch a job, no product launch
    want = {"fluid gold": len(card["gold"][0]), "greedy window of 4": 4,
            "migrate of 4": 4, "fused stream": card["fused requests"]}
    for family, _ in ONLINE_CASES:
        want[f"online {family}"] = card[f"share {family}"][2]
    for what, jobs in want.items():
        if launches[what] != {"product": 0, "closure": jobs}:
            raise AssertionError(f"{what}: {jobs} jobs solved, min-plus "
                                 f"launches {launches[what]}")
    log(f"  fluid gold: 24 backlogs and latencies == FLUID_GOLD; the stream "
        f"at delta=0, B=1 == the serial loop; launches {launches}")
    for family, _ in ONLINE_CASES:
        share, n, jobs, peak = card[f"share {family}"]
        w = walls[f"online {family}"][1:]
        log(f"  online {family} exact, {n} submits of {ONLINE_BATCH} "
            f"({jobs} jobs): {share:.3f} of submits saw a nonzero backlog, "
            f"peak {peak:.6g} s; completions == replay, bounds hold, card "
            f"== CPU; per-submit solve median {statistics.median(w) * 1e3:.2f}"
            f" ms (min {min(w) * 1e3:.2f}, max {max(w) * 1e3:.2f}, "
            f"{len(w)} after the first) on {smi}")
        if share < 0.5:
            raise AssertionError(f"online {family}: only {share:.3f} of "
                                 f"submits met a real queue")
    w = walls["fused stream"]
    log(f"  fused stream: up to {card['fused per solve']} windows a solve, "
        f"schedule_windows == sequential, card == CPU; per-window solve wall "
        f"median {statistics.median(w) * 1e3:.2f} ms over {len(w)} on {smi}")
    for (family, policy), row in card["faults"].items():
        _, gap, slope, final, bounded, lost = row
        log(f"  faults {family}/{policy}: replay gap {gap:.3g} s, post-"
            f"recovery slope {slope}, last backlog {final}, bounded "
            f"{bounded}, lost {lost}, launches "
            f"{launches[f'faults {family}/{policy}']}")

    # timings (host clock, synchronized): the migrate solve
    topo = sched._effective_topology()
    solvers.solve(topo, window, method="migrate", state=sched.state)
    mig_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solvers.solve(topo, window, method="migrate", state=sched.state)
        torch.cuda.synchronize()
        mig_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"  migrate solve of 4 jobs (us-backbone, queued): median "
        f"{statistics.median(mig_ms):.2f} ms over 10 (min {min(mig_ms):.2f}, "
        f"max {max(mig_ms):.2f}) on {smi}")
    profile_device("a greedy window solve of 4 jobs (us-backbone, queued)",
                   lambda: solvers.solve(topo, window, state=sched.state))

    # the measured solver latency after warmup (wall-dependent: printed)
    sc = make_scenario("paper-small", seed=0, device=dev)
    rate = sc.nominal_rate(1.5)
    tr = run_stream(sc, horizon=STREAM_ARRIVALS / rate, seed=4, rate=rate,
                    window_s=0.5 / rate, max_batch=8, fuse_windows=4,
                    solver_latency="measured", warmup=True, drain="exact")
    log(f"  measured-latency stream after warmup: last EMA solve latency "
        f"{tr.windows[-1].solve_model_s * 1e3:.2f} ms, first "
        f"{tr.windows[0].solve_model_s * 1e3:.2f} ms, sustained "
        f"{tr.sustained_arr_s():.4g} requests/s over {len(tr.requests)} "
        f"requests in {len(tr.windows)} windows on {smi}")
    return path


# -- phase 16: Algorithm 2 and the exact oracles on the card -----------------

# SA as the parity check runs it, and the paper's Fig. 5 schedule
SA_CHECK = dict(d=0.9, num_chains=2, block_move_prob=0.3)
FIG5 = dict(d=0.995, num_chains=4, block_move_prob=0.3)
FIG5_LIMIT_S = 120.0    # a Fig. 5 run estimated above this takes one chain
EXACT_JOBS = 4          # the exact solver's subset of paper-small's jobs


def paper_small(device, n: int = 8):
    """The quickstart instance, paper-small: the 5-node topology at link
    capacity scale 1e-3 and the first ``n`` of ``paper_jobs_small(0)``.
    Returns (net, batch, jobs)."""
    from repro_torch.configs import registry
    from repro_torch.core import jobs as J, network as N
    net, _ = N.small_topology(capacity_scale=1e-3, device=device)
    jobs = paper_jobs_small(0, registry)[:n]
    return net, J.batch_jobs(jobs, device=device), jobs


def plan_fields(plan) -> tuple:
    """Everything of a plan that card and CPU must agree on."""
    net = plan.net
    return (plan.order.tolist(), plan.assign.tolist(), plan.bounds.tolist(),
            None if net is None else (net.q_node.cpu().numpy().tolist(),
                                      net.q_link.cpu().numpy().tolist()),
            plan.paths, np.asarray(plan.meta.get("history", [])).tolist(),
            plan.meta.get("chain_cost"), plan.meta.get("n_routings"))


def oracle_run(device, tapes: dict, take) -> dict:
    """Phase 16's solves on ``device``: SA at d = 0.9 from a random and a
    greedy start (each on its tape), greedy, exact on a 4-job subset,
    Lemma 8's bounds, alpha and Corollary 1's factor.  Every field but
    the walls and launches is compared card against CPU.  ``take()``
    reads the min-plus launch counters and sets them to 0."""
    from repro_torch.core import bounds, solvers

    out = {"launches": {}, "walls": {}}
    net, batch, jobs = paper_small(device)
    for init, tape in tapes.items():
        take()
        plan = solvers.solve(net, batch, method="sa", init=init, tape=tape,
                             **SA_CHECK)
        out["launches"][f"sa {init}"] = take()
        out["walls"][f"sa {init}"] = plan.meta["solve_s"]
        out[f"sa {init}"] = plan_fields(plan)
    take()
    out["greedy"] = plan_fields(solvers.solve(net, batch, method="greedy"))
    out["launches"]["greedy"] = take()
    sub_net, sub_batch, _ = paper_small(device, EXACT_JOBS)
    ex = solvers.solve(sub_net, sub_batch, method="exact")
    out["launches"]["exact"] = take()
    out["exact"] = plan_fields(ex)
    s_ss, avg = bounds.service_lower_bounds(net, batch)
    out["launches"]["bounds"] = take()
    out["bounds"] = (s_ss.tolist(), avg, bounds.alpha(net, jobs),
                     bounds.corollary1_factor(net))
    return out


def oracles_phase(dev, smi: str) -> dict:
    """Phase 16; returns the path's min-plus launches by entry and the
    walls PERF.md records."""
    import torch
    from repro_torch.core import annealing, solvers
    from repro_torch.kernels import minplus

    tally = dict.fromkeys(minplus.ENTRIES, 0)

    def take():
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        minplus.reset_launch_count()
        for e in counts:
            tally[e] += counts[e]
        return counts

    _, cpu_batch, _ = paper_small("cpu")
    n_jobs, k = cpu_batch.num_jobs, SA_CHECK["num_chains"]
    iters = annealing._num_iters(1.0, 1e-3, SA_CHECK["d"])
    tapes = {init: annealing.draw_tape(
        cpu_batch.num_layers.numpy(), 5, cpu_batch.max_layers, seed=seed,
        num_chains=k, iters=iters)
        for seed, init in enumerate(("random", "greedy"))}
    minplus.reset_launch_count()
    t0 = time.perf_counter()
    card = oracle_run(dev, tapes, take)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = oracle_run("cpu", tapes, lambda: {})
    cpu_s = time.perf_counter() - t0
    walls, launches = card.pop("walls"), card.pop("launches")
    cpu.pop("walls"), cpu.pop("launches")
    for key in cpu:
        if card[key] != cpu[key]:
            raise AssertionError(f"phase 16: {key} differs card vs CPU")
    # one closure launch a job routed, evaluated or replayed (V = 5), no
    # product: SA K (iters + 1) J + J for the replay (+ greedy's J)
    sa_launches = k * (iters + 1) * n_jobs + n_jobs
    want = {"greedy": n_jobs, "sa random": sa_launches,
            "sa greedy": sa_launches + n_jobs,
            "exact": card["exact"][-1], "bounds": 1}
    for what, n in want.items():
        if launches[what] != {"product": 0, "closure": n}:
            raise AssertionError(f"{what}: min-plus launches "
                                 f"{launches[what]}, expected {n} closure "
                                 f"and no product")
    log(f"paper-small (V=5, {n_jobs} jobs) on the card: SA d={SA_CHECK['d']} "
        f"({iters} iterations) x {k} chains from a random and a greedy "
        f"start, greedy, exact on {EXACT_JOBS} jobs ({card['exact'][-1]} "
        f"routings), Lemma 8 bounds, alpha: {card_s:.2f} s wall (the CPU "
        f"run {cpu_s:.2f} s); plans, histories, queues, paths and bounds "
        f"== the CPU run bit for bit; launches {launches}")
    s_ss, avg, alpha, cor1 = card["bounds"]
    log(f"  SA makespan bound {max(card['sa random'][2]):.6g} s (random "
        f"start) / {max(card['sa greedy'][2]):.6g} s (greedy start), greedy "
        f"{max(card['greedy'][2]):.6g} s; exact makespan bound "
        f"{max(card['exact'][2]):.6g} s; S_SS max {max(s_ss):.6g} s, "
        f"averaged {avg:.6g} s; alpha {alpha:.6g}, 2 - 1/|V| {cor1}")

    # the paper's Fig. 5 setting, on the card only
    net, batch, _ = paper_small(dev)
    fig_iters = annealing._num_iters(1.0, 1e-3, FIG5["d"])
    per_eval = walls["sa random"] / (k * (iters + 1))
    chains = FIG5["num_chains"]
    estimate = per_eval * chains * (fig_iters + 1)
    if estimate > FIG5_LIMIT_S:
        log(f"  Fig. 5 estimate {estimate:.1f} s for {chains} chains "
            f"({per_eval * 1e3:.2f} ms an evaluation) exceeds "
            f"{FIG5_LIMIT_S:.0f} s: one chain")
        chains = 1
    greedy_s = []
    for _ in range(10):
        plan = solvers.solve(net, batch, method="greedy")
        greedy_s.append(plan.meta["solve_s"])
    g_bound = plan.bound()
    take()
    sa = solvers.solve(net, batch, method="sa", seed=0,
                       **dict(FIG5, num_chains=chains))
    fig5 = take()
    want = chains * (fig_iters + 1) * n_jobs + n_jobs
    if fig5 != {"product": 0, "closure": want}:
        raise AssertionError(f"Fig. 5 SA: launches {fig5}, expected {want} "
                             f"closure and no product")
    sim = sa.simulate(net, batch)
    if not sa.bound() >= sim.makespan:
        raise AssertionError(f"Fig. 5 SA: bound {sa.bound()} < simulated "
                             f"{sim.makespan}")
    take()
    g_med = statistics.median(greedy_s)
    log(f"  Fig. 5 setting (d={FIG5['d']}, {fig_iters} iterations, "
        f"{chains} chains, block moves {FIG5['block_move_prob']}): SA "
        f"solve_s {sa.meta['solve_s']:.2f} s, {fig5['closure']} closure "
        f"launches ({sa.meta['solve_s'] / fig5['closure'] * 1e6:.1f} us "
        f"each of wall), bound {sa.bound():.6g} s (sim {sim.makespan:.6g}); "
        f"greedy solve_s median {g_med * 1e3:.2f} ms over 10 (min "
        f"{min(greedy_s) * 1e3:.2f}, max {max(greedy_s) * 1e3:.2f}), bound "
        f"{g_bound:.6g} s; SA / greedy wall {sa.meta['solve_s'] / g_med:.0f}x "
        f"on {smi}")
    d20 = math.exp(math.log(1e-3) / 19.5)
    if annealing._num_iters(1.0, 1e-3, d20) != 20:
        raise AssertionError("the profiled SA does not take 20 iterations")
    if profiler_works():
        profile_device("a 20-iteration SA (one chain, paper-small)",
                       lambda: solvers.solve(net, batch, method="sa", d=d20))
    take()
    return {"launches": dict(tally), "fig5_chains": chains,
            "fig5_s": sa.meta["solve_s"], "greedy_s": g_med}


# -- phase 17: olmoe-1b-7b and deepseek-v2 at full width ---------------------

OLMOE_SHAPE = (64, 2048, 128)        # [B*H, S, hd] of olmoe at B=4, S=2048
MLA_SHAPE = (128, 2048, 192, 128)    # [B*H, S, d, dv] of MLA at B=1, S=2048
DEEPSEEK_LAYERS = 1                  # of 60: one layer is ~5.0 B params


def cast_params(params: dict, dtype) -> dict:
    """``params`` in ``dtype``, the leaves the reference keeps float32 (the
    MoE router, Mamba2's A, dt bias and skip) kept float32, as the
    reference's init and the port's draw them."""
    from repro_torch.models.common import FLOAT32_LEAVES

    def conv(tree, key=""):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        return tree if key in FLOAT32_LEAVES else tree.to(dtype)
    return conv(params)


def spy_prefill(step, params, batch):
    """(logits, per-layer expert choices [N, k], (dropped, total) pairs) of
    one prefill: ``moe.route`` and ``moe.dispatch`` wrapped to keep what
    each layer chose and dropped (device tensors, read once after)."""
    from repro_torch.models import moe
    choices, drops = [], []
    route, dispatch = moe.route, moe.dispatch

    def route_spy(*args):
        out = route(*args)
        choices.append(out[1])
        return out

    def dispatch_spy(*args):
        out = dispatch(*args)
        drops.append(((~out[2]).sum(), out[2].numel()))
        return out

    moe.route, moe.dispatch = route_spy, dispatch_spy
    try:
        logits = step(params, batch)
    finally:
        moe.route, moe.dispatch = route, dispatch
    return logits, choices, drops


def drop_share(drops) -> float:
    return (sum(int(d) for d, _ in drops) / max(sum(n for _, n in drops), 1))


def held_positions(a: list, b: list, s: int) -> int:
    """The positions a flash-vs-xla check holds (B = 1): those before the
    first token whose experts differ between the two runs in any layer.
    Top-k routing is discontinuous, so two correct evaluations may route a
    token whose k-th and (k+1)-th probabilities tie within rounding to
    different experts; a causal model's earlier positions never see that
    token, and capacity ranks follow token order, so they are unaffected."""
    first = s
    for x, y in zip(a, b):
        differ = (x != y).any(-1).nonzero().flatten().tolist()
        if differ:
            first = min(first, differ[0])
    return first


def flash_check_f32(name, cfg32, params, toks, dev, want_counts):
    """float32 prefill, flash against xla (TF32 off): launches, logits at
    3e-4 on the held positions; returns (counts, max err, held)."""
    import torch
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    s = toks.shape[1]
    flash.reset_launch_count()
    got, ch_f, _ = spy_prefill(steps.make_prefill_step(cfg32, device=dev),
                               params, {"tokens": toks})
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    want, ch_x, _ = spy_prefill(steps.make_prefill_step(dataclasses.replace(
        cfg32, attn_impl="xla"), device=dev), params, {"tokens": toks})
    if counts != want_counts:
        raise AssertionError(f"{name} float32 prefill: flash launches "
                             f"{counts}, expected {want_counts}")
    if got.shape != (1, s, cfg32.padded_vocab):
        raise AssertionError(f"{name}: logits shape {tuple(got.shape)}")
    held = held_positions(ch_f, ch_x, s)
    if held < s // 2:
        raise AssertionError(f"{name}: expert choices of flash and xla "
                             f"differ from position {held} of {s}")
    err = max_err_within(got[:, :held], want[:, :held], 3e-4,
                         f"{name} float32 prefill flash vs xla")
    rest = ("" if held == s else f" (from position {held} on a token is "
            f"routed to other experts in the two runs)")
    log(f"{name} float32 prefill B=1 S={s} (TF32 off): flash vs xla logits "
        f"max |diff| {err:.3e} (tolerance 3e-4) over {held} of {s} "
        f"positions{rest}; launches {counts}")
    return counts, err, held


def time_prefill(step, params, batch, n: int = 5) -> list:
    import torch
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def hold_and_time_fwd(rng, dev, heads, bh, s, d, dv, smi,
                      also_simt: bool = False):
    """The bf16 forward kernel that the dispatch rule picks at [bh, s, d ->
    dv] (``heads`` per batch row) against its plain version; its time, the
    plain version's, SDPA's on [bh / heads, heads, s, d] (None where SDPA
    refuses the shape) and the bound.  With ``also_simt``, the CUDA-core
    forward (forced) at the same inputs too, under "simt"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref
    variant = flash.kernel_variant("flash_fwd_lse", torch.bfloat16, d, dv)
    q, k, v = flash_inputs(rng, bh, s, d, dv, "bfloat16", dev)
    scale = 1 / math.sqrt(d)
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale,
                                             causal=True)
    atol, rtol = FLASH_TOL["bfloat16"]
    width = f"{d}->{dv}" if d != dv else f"{d}"
    variants = [variant] + (["simt"] if also_simt and variant != "simt"
                            else [])
    held = {}
    for var in variants:
        o, lse = fwd_call(flash, "flash_fwd_lse", var, q, k, v, scale=scale,
                          causal=True)
        torch.cuda.synchronize()
        what = f"flash_fwd_lse ({var}) bf16 [{bh},{s},{width}] causal"
        err = max(max_err_within(o, want_o, atol, what + " O", rtol),
                  max_err_within(lse, want_lse, LSE_TOL, what + " lse"))
        log(f"{what}: max |O - plain| (and lse) {err:.3e}, share of the O "
            f"gate {gate_share(o, want_o, atol, rtol):.3f}")
        del o, lse
        fast = var == "sm90"
        held[var] = {"err": err, "ms": event_ms(
            lambda var=var: fwd_call(flash, "flash_fwd_lse", var, q, k, v,
                                     scale=scale, causal=True),
            reps=10 if fast else 3, inner=5 if fast else 2)}
    del want_o, want_lse
    plain = event_ms(lambda: ref.flash_fwd_lse_ref(q, k, v, scale=scale),
                     reps=3, inner=2)
    qs, ks, vs = (x.unflatten(0, (-1, heads)) for x in (q, k, v))
    try:
        sdpa = event_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, scale=scale), reps=10, inner=5)
    except RuntimeError as exc:
        log(f"  F.scaled_dot_product_attention refuses d={d}, dv={dv}: "
            f"library time not measured ({str(exc)[:120]})")
        sdpa = None
    bound = flash_bound(bh, s, d, dv, "bfloat16", True, True)
    sdpa_txt = "not measured" if sdpa is None else f"{sdpa * 1e3:.1f} us"
    times = "; ".join(f"{var} {held[var]['ms'] * 1e3:.1f} us per call"
                      for var in variants)
    log(f"  flash_fwd_lse bf16 [{bh},{s},{width}] causal on {smi}: {times}; "
        f"bound {bound[0] * 1e3:.2f} us ({bound[1]}); plain version "
        f"{plain * 1e3:.1f} us; F.scaled_dot_product_attention (library "
        f"yardstick) {sdpa_txt}")
    out = {"variant": variant, "err": held[variant]["err"],
           "ms": held[variant]["ms"], "plain_ms": plain, "sdpa_ms": sdpa,
           "bound": bound, "shape": f"[{bh},{s},{width}] bf16"}
    if "simt" in held and variant != "simt":
        out["simt"] = held["simt"]
    return out


def moe_mla_phase(dev, smi: str, keep) -> dict:
    """Phase 17; returns the forward kernels' launches on this path and
    their checks and times at the path's shapes.  Passes each model's
    bf16 weights to ``keep(arch, params)``."""
    import gc

    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(17)
    out = {"launches": {}}

    # -- olmoe-1b-7b: all 16 layers, 16 heads of 128, 64 experts top-8
    full = registry.config("olmoe_1b_7b")
    bh, s, d = OLMOE_SHAPE
    if (4 * full.num_heads, full.head_dim) != (bh, d):
        raise AssertionError(f"olmoe-1b-7b config: {full}")
    cfg32 = dataclasses.replace(full, dtype=torch.float32, attn_impl="flash")
    t0 = time.perf_counter()
    params = M.init_params(cfg32, torch.Generator().manual_seed(0),
                           device=dev)
    log(f"olmoe-1b-7b at full width ({full.num_layers} layers): "
        f"{M.param_count(params):,} params (random, seed 0), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    counts, _, _ = flash_check_f32(
        "olmoe-1b-7b", cfg32, params, rng.integers(0, full.vocab_size,
                                                   (1, 512)), dev,
        {"flash_fwd_lse/simt": full.num_layers})
    out["launches"]["olmoe-1b-7b float32 prefill"] = counts
    params = cast_params(params, torch.bfloat16)
    keep("olmoe_1b_7b", params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, attn_impl="flash")
    step = steps.make_prefill_step(cfg, device=dev)
    batch = {"tokens": rng.integers(0, full.vocab_size, (4, 2048))}
    step(params, batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_count()
    logits, _, drops = spy_prefill(step, params, batch)
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    peak = torch.cuda.max_memory_allocated()
    if counts != {"flash_fwd_lse/sm90": full.num_layers}:
        raise AssertionError(f"olmoe-1b-7b bf16 prefill: flash launches "
                             f"{counts}, expected {full.num_layers} of the "
                             f"tensor-core forward and none of the "
                             f"CUDA-core one")
    if logits.shape != (4, 2048, full.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("olmoe-1b-7b bf16 logits not finite or "
                             "misshapen")
    del logits
    out["launches"]["olmoe-1b-7b bf16 prefill"] = counts
    log(f"olmoe-1b-7b bf16 prefill B=4 S=2048: flash launches {counts} at "
        f"[{bh},{s},{d}]; logits finite; token-slots dropped by capacity "
        f"{drop_share(drops):.4f} (cf {full.moe_capacity_factor}); peak "
        f"device memory {peak / 2**30:.2f} GiB")

    # decode: the engine's tokens against a serve_step loop's
    prompts = rng.integers(0, full.vocab_size, (4, 32))
    engine = DecodeEngine(cfg, params, max_len=64, device=dev)
    res = engine.generate(prompts, 16)
    with torch.no_grad():
        cache = M.init_cache(cfg, 4, 64, device=dev)
        toks = torch.as_tensor(prompts, device=dev)
        for i in range(32):
            lg, cache = M.serve_step(cfg, params, cache,
                                     {"tokens": toks[:, i:i + 1], "pos": i})
        loop = []
        for j in range(16):
            tok = torch.argmax(lg, -1)[:, None]
            loop.append(tok[:, 0])
            lg, cache = M.serve_step(cfg, params, cache,
                                     {"tokens": tok, "pos": 32 + j})
    loop = torch.stack(loop, 1).cpu().numpy()
    if not np.array_equal(res.tokens, loop):
        raise AssertionError("olmoe-1b-7b: DecodeEngine tokens != the "
                             "serve_step loop's")
    del cache, engine
    log(f"olmoe-1b-7b DecodeEngine, 4 prompts x 32 tokens, 16 generated: "
        f"tokens == a serve_step loop's; {res.tokens_per_s:.1f} tok/s "
        f"(prefill {res.prefill_s:.2f} s, decode {res.decode_s:.2f} s) on "
        f"{smi}")

    out["olmoe"] = hold_and_time_fwd(rng, dev, full.num_heads, bh, s, d, d,
                                     smi)
    ms = time_prefill(step, params, batch)
    out["olmoe_prefill_ms"] = statistics.median(ms)
    log(f"  prefill step olmoe-1b-7b B=4 S=2048 bf16: median "
        f"{statistics.median(ms):.2f} ms over 5 (min {min(ms):.2f}, max "
        f"{max(ms):.2f}); {4 * 2048 / statistics.median(ms) * 1e3:.0f} "
        f"tokens/s on {smi}")
    if profiler_works():
        profile_device("one olmoe-1b-7b prefill (B=4, S=2048, bf16)",
                       lambda: step(params, batch), top=10)
    del params, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- deepseek-v2 at full width, one layer: MLA (192 -> 128), 160 experts
    full = dataclasses.replace(registry.config("deepseek_v2_236b"),
                               num_layers=DEEPSEEK_LAYERS)
    bh, s, d, dv = MLA_SHAPE
    if (full.num_heads, full.qk_nope_head_dim + full.qk_rope_head_dim,
            full.v_head_dim) != (bh, d, dv):
        raise AssertionError(f"deepseek-v2 config: {full}")
    cfg32 = dataclasses.replace(full, dtype=torch.float32, attn_impl="flash")
    t0 = time.perf_counter()
    params = M.init_params(cfg32, torch.Generator().manual_seed(0),
                           device=dev)
    log(f"deepseek-v2-236b at full width, depth {DEEPSEEK_LAYERS}: "
        f"{M.param_count(params):,} params (random, seed 0), initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    counts, _, _ = flash_check_f32(
        "deepseek-v2", cfg32, params, rng.integers(0, full.vocab_size,
                                                   (1, 512)), dev,
        {"flash_fwd_lse/simt": DEEPSEEK_LAYERS})
    out["launches"]["deepseek-v2 float32 prefill"] = counts

    # the absorbed latent-cache decode against the materialized form, on
    # the same 8 tokens (float32, TF32 off)
    toks = torch.as_tensor(rng.integers(0, full.vocab_size, (1, 8)),
                           device=dev)
    cfgx = dataclasses.replace(cfg32, attn_impl="xla")
    with torch.no_grad():
        want = M.prefill_logits(cfgx, params, {"tokens": toks})
        cache = M.init_cache(cfgx, 1, 8, device=dev)
        got = []
        for i in range(8):
            lg, cache = M.serve_step(cfgx, params, cache,
                                     {"tokens": toks[:, i:i + 1], "pos": i})
            got.append(lg)
    got = torch.stack(got, 1)
    err = max_err_within(got, want, 0.11, "deepseek-v2 absorbed decode vs "
                         "materialized prefill", rtol=0.05)
    log(f"deepseek-v2 absorbed decode, 8 steps, against the materialized "
        f"prefill's logits (float32): max |diff| {err:.3e} (the reference's "
        f"decode tolerance atol 0.11, rtol 0.05)")
    del cache, got, want

    params = cast_params(params, torch.bfloat16)
    keep("deepseek_v2_236b", params)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(full, attn_impl="flash")
    step = steps.make_prefill_step(cfg, device=dev)
    batch = {"tokens": rng.integers(0, full.vocab_size, (1, 2048))}
    step(params, batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_count()
    logits, _, drops = spy_prefill(step, params, batch)
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    peak = torch.cuda.max_memory_allocated()
    if counts != {"flash_fwd_lse/sm90": DEEPSEEK_LAYERS}:
        raise AssertionError(f"deepseek-v2 bf16 prefill: flash launches "
                             f"{counts}, expected {DEEPSEEK_LAYERS} of the "
                             f"tensor-core forward at (192, 128) and none "
                             f"of the CUDA-core one")
    if logits.shape != (1, 2048, full.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("deepseek-v2 bf16 logits not finite or "
                             "misshapen")
    del logits
    out["launches"]["deepseek-v2 bf16 prefill"] = counts
    log(f"deepseek-v2 bf16 prefill B=1 S=2048: flash launches {counts} at "
        f"[{bh},{s},{d}->{dv}]; logits finite; token-slots dropped by "
        f"capacity {drop_share(drops):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    out["mla"] = hold_and_time_fwd(rng, dev, full.num_heads, bh, s, d, dv,
                                   smi, also_simt=True)
    ms = time_prefill(step, params, batch)
    out["deepseek_prefill_ms"] = statistics.median(ms)
    log(f"  prefill step deepseek-v2 (1 layer) B=1 S=2048 bf16: median "
        f"{statistics.median(ms):.2f} ms over 5 (min {min(ms):.2f}, max "
        f"{max(ms):.2f}) on {smi}")
    prof = None
    if profiler_works():
        prof = profile_device("one deepseek-v2 prefill (1 layer, B=1, "
                              "S=2048, bf16)", lambda: step(params, batch),
                              top=10)
    log_flash_share("deepseek-v2 layer prefill (B=1, S=2048, bf16)", prof,
                    out["deepseek_prefill_ms"], "25.93 ms on the "
                    "CUDA-core forward, the forward 58.3% of busy")
    del params, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 18: xLSTM, Zamba2, Whisper and phi-3-vision at full width ---------

PHI3V_SHAPE = (32, 576 + 2048, 96)   # [B*H, P + S, hd] of phi-3-vision's
#                                      prefill at B = 1
GEN = 32                  # generated tokens, and the prompt length decoded
DECODE_TOL = (0.11, 0.05)  # the reference's decode == prefill (atol, rtol)
# (arch, float32 card-vs-CPU check (B, S), bf16 prefill (B, S)); phi-3-
# vision's float32 check is flash against xla on the card at S = 512
FAMILIES = (("xlstm_125m", (2, 64), (4, 1024)),
            ("zamba2_2_7b", (1, 32), (1, 512)),
            ("whisper_base", (2, 64), (4, 448)),
            ("phi3_vision_4_2b", None, (1, 2048)))
# the recurrent families launch kernels per token (an xlstm-125m prefill
# at S = 1024 is ~250 k launches): their prefill is profiled at this length
RECURRENT_PROFILE_S = 128


def family_batch(cfg, rng, b: int, s: int) -> dict:
    """numpy tokens [b, s], plus standard-normal frames [b, num_frames, D]
    (encdec) or patches [b, num_patches, D] (vlm), float32."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}
    stub = {"encdec": ("frames", cfg.num_frames),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if stub:
        out[stub[0]] = rng.standard_normal(
            (b, stub[1], cfg.d_model), dtype=np.float32)
    return out


def encoder_extra(cfg, params, batch, dev) -> dict:
    """Whisper's ``enc_out`` for the decode steps (the encoding of the
    batch's frames on ``dev``), else nothing."""
    import torch
    from repro_torch.models import encdec
    if cfg.family != "encdec":
        return {}
    with torch.no_grad():
        return {"enc_out": encdec.encode(cfg, params, torch.as_tensor(
            batch["frames"], device=dev), remat=False)}


def card_vs_cpu_f32(name, cfg32, params, dev, b, s, rng) -> float:
    """The float32 (TF32 off) prefill's last logits and 4 ``serve_step``s
    (logits and every state leaf after each) on the card against the
    port's CPU run on the same weights (``params`` on the CPU), at
    atol = rtol = 2e-4; no flash launch on the card.  Returns the max
    |diff|."""
    import torch
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.pytree import items, tree_map
    dparams = tree_map(lambda x: x.to(dev), params)
    batch = family_batch(cfg32, rng, b, s)
    flash.reset_launch_count()
    got = steps.make_prefill_step(cfg32, device=dev)(dparams, batch)[:, -1]
    torch.cuda.synchronize()
    if flash_variant_counts(flash):
        raise AssertionError(f"{name} float32 prefill launched flash: "
                             f"{flash_variant_counts(flash)}")
    want = steps.make_prefill_step(cfg32, device="cpu")(params, batch)[:, -1]
    err = max_err_within(got.cpu(), want, 2e-4,
                         f"{name} float32 prefill card vs CPU")
    extra = (encoder_extra(cfg32, dparams, batch, dev),
             encoder_extra(cfg32, params, batch, "cpu"))
    caches = (M.init_cache(cfg32, b, 8, device=dev),
              M.init_cache(cfg32, b, 8, device="cpu"))
    step = (steps.make_serve_step(cfg32, device=dev),
            steps.make_serve_step(cfg32, device="cpu"))
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        a, _ = step[0](dparams, caches[0], {"tokens": tok, "pos": i,
                                            **extra[0]})
        c, _ = step[1](params, caches[1], {"tokens": tok, "pos": i,
                                           **extra[1]})
        err = max(err, max_err_within(a.cpu(), c, 2e-4,
                                      f"{name} float32 decode step {i}"))
        cpu_state = dict(items(caches[1]))
        for key, leaf in items(caches[0]):
            err = max(err, max_err_within(leaf.cpu(), cpu_state[key], 2e-4,
                                          f"{name} {key} after step {i}"))
    del dparams, caches
    log(f"{name} float32 (TF32 off) B={b} S={s}: card vs CPU port, last "
        f"prefill logits, 4 decode steps and every state leaf after each: "
        f"max |diff| {err:.3e} (tolerance 2e-4); no flash launch")
    return err


def serve_family(name, cfg, params, dev, smi, b, s, rng,
                 want_flash: dict) -> dict:
    """The bf16 serving path of one family: the prefill with every launch
    counter set to 0 just before and read just after (flash launches ==
    ``want_flash``, finite logits, peak memory), timed; decode == prefill
    over the first GEN tokens (a ``serve_step`` loop against a prefill of
    those tokens, text only for vlm) at the reference's tolerance; the
    loop's GEN greedy tokens == ``DecodeEngine``'s from the same prompts;
    a profile of one decode step."""
    import torch
    from repro_torch.kernels import flash, minplus
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.serving.engine import DecodeEngine
    step = steps.make_prefill_step(cfg, device=dev)
    batch = family_batch(cfg, rng, b, s)
    step(params, batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (flash, minplus):
        mod.reset_launch_count()
    logits = step(params, batch)
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    peak = torch.cuda.max_memory_allocated()
    if counts != want_flash or minplus.launch_count():
        raise AssertionError(f"{name} bf16 prefill: flash launches {counts} "
                             f"(expected {want_flash}), min-plus "
                             f"{minplus.launch_count()}")
    if logits.shape != (b, s, cfg.padded_vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} bf16 logits not finite or misshapen")
    del logits
    ms = time_prefill(step, params, batch, n=3)
    out = {"prefill_ms": statistics.median(ms), "peak_gib": peak / 2**30,
           "launches": counts, "tokens": b * s}
    stub = {"frames": f"{cfg.num_frames:,} frames + ",
            "patches": f"{cfg.num_patches} patches + "}
    what = "".join(v for k, v in stub.items() if k in batch)
    log(f"{name} bf16 prefill B={b} {what}S={s}: flash launches {counts or 0}"
        f", logits finite; median {out['prefill_ms']:.2f} ms over 3 (min "
        f"{min(ms):.2f}, max {max(ms):.2f}), {b * s / out['prefill_ms'] * 1e3:.0f}"
        f" tokens/s; peak device memory {out['peak_gib']:.2f} GiB on {smi}")

    # decode == prefill over the first GEN tokens, then GEN greedy steps
    short = {k: (v[:, :GEN] if k == "tokens" else v) for k, v in batch.items()
             if k != "patches"}
    want = steps.make_prefill_step(cfg, device=dev)(params, short)
    extra = encoder_extra(cfg, params, batch, dev)
    serve = steps.make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, b, 2 * GEN + 8, device=dev)
    toks = torch.as_tensor(short["tokens"], device=dev)
    err = 0.0
    for i in range(GEN):
        lg, cache = serve(params, cache, {"tokens": toks[:, i:i + 1],
                                          "pos": i, **extra})
        err = max(err, max_err_within(lg, want[:, i], DECODE_TOL[0],
                                      f"{name} decode vs prefill at {i}",
                                      rtol=DECODE_TOL[1]))
    loop = []
    for j in range(GEN):
        tok = torch.argmax(lg, -1)[:, None]
        loop.append(tok[:, 0])
        lg, cache = serve(params, cache, {"tokens": tok, "pos": GEN + j,
                                          **extra})
    loop = torch.stack(loop, 1).cpu().numpy()
    engine = DecodeEngine(cfg, params, max_len=2 * GEN + 8, device=dev)
    res = engine.generate(short["tokens"], GEN, extra_batch=extra)
    if not np.array_equal(res.tokens, loop):
        raise AssertionError(f"{name}: DecodeEngine tokens != the "
                             f"serve_step loop's")
    out.update(decode_err=err, decode_tok_s=res.tokens_per_s,
               decode_ms_per_step=res.decode_s / GEN * 1e3)
    log(f"{name} bf16 decode: {GEN} serve_steps vs the prefill's logits max "
        f"|diff| {err:.3e} (atol {DECODE_TOL[0]}, rtol {DECODE_TOL[1]}); "
        f"DecodeEngine {b} prompts x {GEN} tokens, {GEN} generated == the "
        f"loop's: {res.tokens_per_s:.1f} tok/s ({out['decode_ms_per_step']:.2f}"
        f" ms a step; prompt {res.prefill_s:.2f} s) on {smi}")
    if profiler_works():
        tok = torch.zeros((b, 1), dtype=torch.long, device=dev)
        profile_device(f"one {name} decode step (B={b}, bf16)",
                       lambda: serve(params, cache, {"tokens": tok,
                                                     "pos": 2 * GEN,
                                                     **extra}), top=8)
    return out


def families_phase(dev, smi: str, keep) -> dict:
    """Phase 18; returns the flash launches of each path, the min-plus
    launches of whisper's served plan, phi-3-vision's forward kernel
    check and times at PHI3V_SHAPE, and each family's serving figures.
    Passes each family's bf16 weights to ``keep(arch, params)``."""
    import gc

    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash, minplus
    from repro_torch.launch import serve, steps
    from repro_torch.models import model as M
    from repro_torch.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(18)
    out = {"launches": {}, "serving": {}}
    for arch, check, (b, s) in FAMILIES:
        full = registry.config(arch)
        name = full.name
        cfg32 = dataclasses.replace(full, dtype=torch.float32,
                                    attn_impl="flash")
        t0 = time.perf_counter()
        # the CPU copy serves the card-vs-CPU check; phi-3-vision's is
        # drawn straight onto the card
        params = M.init_params(cfg32, torch.Generator().manual_seed(0),
                               device="cpu" if check else dev)
        log(f"{name} at full width ({full.num_layers} layers, d "
            f"{full.d_model}): {M.param_count(params):,} params (random, "
            f"seed 0), initialised in {time.perf_counter() - t0:.1f} s")
        if check:
            card_vs_cpu_f32(name, cfg32, params, dev, *check, rng)
            params = tree_map(lambda x: x.to(dev),
                              cast_params(params, torch.bfloat16))
        else:
            bh, s_all, d = PHI3V_SHAPE
            if (full.num_heads, full.num_patches + s, full.head_dim) != \
                    (bh, s_all, d):
                raise AssertionError(f"{name} config: {full}")
            toks = family_batch(cfg32, rng, 1, 512)
            flash.reset_launch_count()
            got = steps.make_prefill_step(cfg32, device=dev)(params, toks)
            torch.cuda.synchronize()
            counts = flash_variant_counts(flash)
            want = steps.make_prefill_step(dataclasses.replace(
                cfg32, attn_impl="xla"), device=dev)(params, toks)
            if counts != {"flash_fwd_lse/simt": full.num_layers}:
                raise AssertionError(f"{name} float32 prefill: flash "
                                     f"launches {counts}")
            err = max_err_within(got, want, 3e-4, f"{name} float32 prefill "
                                 f"flash vs xla")
            out["launches"][f"{name} float32 prefill"] = counts
            log(f"{name} float32 prefill B=1, {full.num_patches} patches + 512 "
                f"tokens (TF32 off): flash vs xla logits max |diff| {err:.3e} (tolerance "
                f"3e-4); launches {counts}")
            del got, want
            params = cast_params(params, torch.bfloat16)
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(full, attn_impl="flash")
        want_flash = ({"flash_fwd_lse/sm90": full.num_layers}
                      if full.family == "vlm" else {})
        keep(arch, params)
        res = serve_family(name, cfg, params, dev, smi, b, s, rng,
                           want_flash)
        out["serving"][name] = res
        out["launches"][f"{name} bf16 prefill"] = res["launches"]
        if full.family == "vlm":
            out["phi3v"] = hold_and_time_fwd(rng, dev, full.num_heads,
                                             *PHI3V_SHAPE, PHI3V_SHAPE[2],
                                             smi, also_simt=True)
            n = full.num_layers
            log(f"  {name} prefill: {n} tensor-core flash launches, "
                f"{n * out['phi3v']['ms']:.2f} ms of the "
                f"{res['prefill_ms']:.2f} ms by the kernel's time per call")
        prof = None
        if profiler_works():
            ps = RECURRENT_PROFILE_S if full.sub_quadratic else s
            batch = family_batch(cfg, rng, b, ps)
            step = steps.make_prefill_step(cfg, device=dev)
            prof = profile_device(f"one {name} prefill (B={b}, S={ps}, "
                                  f"bf16)", lambda: step(params, batch),
                                  top=8)
        if full.family == "vlm":
            log_flash_share(f"{name} prefill (B=1, {full.num_patches} "
                            f"patches + {s}, bf16)", prof,
                            res["prefill_ms"], "140.80 ms on the "
                            "CUDA-core forward, the forward 61% of busy")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{name}: {time.perf_counter() - t0:.1f} s in phase 18")

    # launch/serve.py's encdec branch on the card: the routed plan through
    # the min-plus kernel, equal to the CPU port's bit for bit
    for mod in (minplus, flash):
        mod.reset_launch_count()
    _, plans, sres = serve.run("whisper_base", requests=4, gen=16,
                               device=dev, verbose=False)
    torch.cuda.synchronize()
    n_minplus = minplus.launch_count()
    out["minplus"] = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
    if n_minplus == 0 or flash_variant_counts(flash):
        raise AssertionError(f"serve.run('whisper_base'): min-plus "
                             f"{n_minplus}, flash "
                             f"{flash_variant_counts(flash)}")
    _, cpu_plans, _ = serve.run("whisper_base", requests=4, gen=1,
                                device="cpu", verbose=False)
    for a, c in zip(plans, cpu_plans, strict=True):
        if (a.priority, a.bound_s, a.nodes_used) != \
                (c.priority, c.bound_s, c.nodes_used):
            raise AssertionError(f"whisper serve plan card vs CPU: {a} != "
                                 f"{c}")
    log(f"serve.run('whisper_base') on the card: {len(plans)} placements == "
        f"CPU port's bit for bit, {n_minplus} min-plus launches, no flash, "
        f"{sres.tokens_per_s:.1f} tok/s (smoke config, encoder output of "
        f"zero frames)")
    return out


# -- phase 19: the train steps of the other five families --------------------

PHI3V_BWD = (32, 576 + 2048, 96, 96)   # [B*H, P + S, d, dv] of phi-3-vision's
#                                        train step at B = 1
CARD_BYTES = 80e9                      # the H100's 80 GB
SPARE_BYTES = 15e9                     # kept free of the memory reckoning
# (arch, depth unit, bf16 train step (B, S), the flash kernels its
# attention must take, written out here rather than read from the dispatch
# rule: tensor-core at olmoe's d = 128 and phi-3-vision's d = 96, none for
# the rest); the depth is cut, in whole
# units (zamba2's groups of 6 Mamba2 layers), only as far as
# train_reckoning says the card forces
TRAIN_FAMILIES = (("olmoe_1b_7b", 1, (4, 2048), "sm90"),
                  ("phi3_vision_4_2b", 1, (1, 2048), "sm90"),
                  ("zamba2_2_7b", 6, (1, 512), None),
                  ("xlstm_125m", 1, (4, 256), None),
                  ("whisper_base", 1, (4, 448), None))
TRAIN_STEPS = 3
# the six non-dense archs of the registry, trained at their smoke configs
SMOKE_ARCHS = ("olmoe_1b_7b", "deepseek_v2_236b", "phi3_vision_4_2b",
               "zamba2_2_7b", "xlstm_125m", "whisper_base")
SMOKE_B, SMOKE_S = 2, 128    # float32 checks: S >= 128 takes flash
# float32 card == CPU port: the loss at rtol 1e-5 and every gradient leaf
# at tests/test_torch_train.py's GRAD_TOL (the same function summed in
# another order)
GRAD_TOL = (1e-5, 1e-4)
# the recurrent families launch kernels per token (a zamba2-2.7b step of
# 42 layers at S = 64 is ~100 k kernels): their step is profiled at this
# length
TRAIN_PROFILE_S = 64
GC_TOPK_FRAC = 1e-3          # topk_mask's fraction in the grad_compress check
# the families at whose trained leaves phase 19 holds the fused AdamW
# against its per-leaf plain version (the olmoe train cell's; whisper's many
# small and ragged leaves), the gradients from one more batch of (1, S)
ADAMW_HELD = {"olmoe_1b_7b": 512, "whisper_base": 448}
ADAMW_NORM_RTOL = 1e-5       # the fused norm's summation order, nothing else


def train_reckoning(cfg, b: int, s: int) -> dict:
    """The device memory a bf16 ``make_train_step`` needs, by count from
    the meta-device param tree: ~22 bytes a parameter (bf16 parameter and
    gradient, float32 m and v, each old and new: ``AdamW.apply`` builds
    every new tree before the old ones are dropped; on the card its fused
    kernel makes no temporaries beside them), and the activations under
    remat: the float32 logits path (~16 bytes a token and vocab entry)
    and ~100 bytes a token and channel of the widest projection for the
    block recomputed in the backward."""
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves
    sizes = [x.numel() for x in leaves(M.param_shapes(cfg))]
    wide = max(cfg.d_model, cfg.d_ff, cfg.moe_top_k * cfg.moe_d_ff)
    tokens = b * (s + cfg.num_patches + cfg.num_frames)
    return {"params": sum(sizes), "state": 22 * sum(sizes),
            "act": 16 * b * s * cfg.padded_vocab + 100 * tokens * wide}


def train_depths() -> dict:
    """arch -> (depth, reckoning at it, reckoning one unit deeper or None):
    the deepest whole number of units whose reckoning leaves SPARE_BYTES of
    the card free."""
    from repro_torch.configs import registry
    out = {}
    for arch, unit, (b, s), _ in TRAIN_FAMILIES:
        full = registry.config(arch)
        depth, fits, over = 0, None, None
        for n in range(unit, full.num_layers + 1, unit):
            r = train_reckoning(dataclasses.replace(full, num_layers=n), b, s)
            if r["state"] + r["act"] > CARD_BYTES - SPARE_BYTES:
                over = r
                break
            depth, fits = n, r
        if not depth:
            raise AssertionError(f"{arch}: one unit of depth does not fit")
        out[arch] = (depth, fits, over)
    return out


def cut_params(params: dict, depth: int, device) -> dict:
    """The first ``depth`` layers of a stacked param tree ("blocks", or
    zamba2's "mamba"), copied to ``device`` with every other leaf."""
    from repro_torch.pytree import tree_map
    key = "mamba" if "mamba" in params else "blocks"
    out = {k: tree_map(lambda x: x.to(device), v) for k, v in params.items()
           if k != key or depth is None}
    if depth is not None and key in params:
        out[key] = tree_map(lambda x: x[:depth].to(device, copy=True),
                            params[key])
    return out


def parking(depths: dict) -> tuple:
    """(keep, parked): phases 17-18 call ``keep(arch, params)`` with each
    model's bf16 weights (seed 0), and ``parked[arch]`` holds them, cut to
    ``depths``' depth (whole where the arch has none), in host memory
    until phase 19 trains on them (a draw at full width costs ~10-35 s
    of host time a model)."""
    import torch
    parked = {}

    def keep(arch: str, params: dict) -> None:
        parked[arch] = cut_params(params, depths.get(arch, (None,))[0],
                                  torch.device("cpu"))
    return keep, parked


def hold_and_time_bwd(rng, dev, bh, s, d, dv, smi) -> dict:
    """The bf16 backward kernels at [bh, s, d -> dv] (one batch row of bh
    heads) against their plain versions at BWD_TOL, each gate share
    printed: dq and dk/dv through the kernel the dispatch rule picks and,
    where that is the tensor-core one, the CUDA-core kernel forced at the
    same inputs.  Their times, the plain
    versions', the backward of F.scaled_dot_product_attention
    (``autograd.grad`` of a saved forward on [1, bh, s, d]; None where it
    refuses the shape) and the bounds.  "err" and "ms" are keyed by
    (entry, variant)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref
    q, k, v = flash_inputs(rng, bh, s, d, dv, "bfloat16", dev)
    do = torch.from_numpy(rng.standard_normal((bh, s, dv), dtype=np.float32)
                          ).to(dev, torch.bfloat16)
    kw = dict(scale=1 / math.sqrt(d), causal=True)
    o, lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(o, do)
    args = (q, k, v, do, lse, delta)
    want = {"flash_bwd_dq": (ref.flash_bwd_dq_ref(*args, **kw),),
            "flash_bwd_dkv": ref.flash_bwd_dkv_ref(*args, **kw)}
    keys = []
    for entry in BWD_ENTRIES:
        rule = flash.kernel_variant(entry, torch.bfloat16, d, dv)
        keys += [(entry, rule)] + ([(entry, "simt")] if rule == "sm90"
                                   else [])
    atol, rtol = BWD_TOL["bfloat16"]
    width = f"{d}->{dv}" if d != dv else f"{d}"
    err, shares = {}, {}
    for entry, var in keys:
        got = bwd_call(flash, entry, var, *args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        what = f"{entry} ({var}) bf16 [{bh},{s},{width}] causal"
        err[(entry, var)] = max(
            max_err_within(g, w, atol, f"{what} {name}", rtol)
            for g, w, name in zip(got, want[entry], ("dk", "dv")
                                  if entry == "flash_bwd_dkv" else ("dq",)))
        shares[(entry, var)] = max(gate_share(g, w, atol, rtol)
                                   for g, w in zip(got, want[entry]))
        log(f"{what}: max |got - plain| {err[(entry, var)]:.3e}, share of "
            f"the gate {shares[(entry, var)]:.3f} (atol {atol}, rtol "
            f"{rtol})")
        del got
    del want
    t = {(e, var): event_ms(lambda e=e, var=var: bwd_call(
        flash, e, var, *args, **kw), reps=10 if var == "sm90" else 5,
        inner=5 if var == "sm90" else 2) for e, var in keys}
    plain = {"flash_bwd_dq": event_ms(lambda: ref.flash_bwd_dq_ref(
        *args, **kw), reps=3, inner=1),
        "flash_bwd_dkv": event_ms(lambda: ref.flash_bwd_dkv_ref(*args, **kw),
                                  reps=3, inner=1)}
    qs, ks, vs = (x[None].detach().requires_grad_() for x in (q, k, v))
    try:
        out4 = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              scale=kw["scale"])
        do4 = do[None]
        sdpa = event_ms(lambda: torch.autograd.grad(
            out4, (qs, ks, vs), do4, retain_graph=True), reps=5, inner=2)
    except RuntimeError as exc:
        log(f"  F.scaled_dot_product_attention backward refuses d={d}, "
            f"dv={dv}: library time not measured ({str(exc)[:120]})")
        sdpa = None
    bound = {e: flash_bwd_bound(bh, s, d, dv, "bfloat16", True, e)
             for e in BWD_ENTRIES}
    sdpa_txt = "not measured" if sdpa is None else f"{sdpa * 1e3:.1f} us"
    for e, var in keys:
        log(f"  {e} ({var}) bf16 [{bh},{s},{width}] causal on {smi}: "
            f"{t[(e, var)] * 1e3:.1f} us per call; bound "
            f"{bound[e][0] * 1e3:.2f} us ({bound[e][1]}); plain version "
            f"{plain[e] * 1e3:.1f} us")
    log(f"  F.scaled_dot_product_attention backward (library yardstick, "
        f"dq, dk and dv together): {sdpa_txt}")
    return {"err": err, "share": shares, "ms": t, "plain_ms": plain,
            "sdpa_ms": sdpa, "bound": bound,
            "shape": f"[{bh},{s},{width}] bf16"}


def smoke_train_batch(cfg, rng, b: int, s: int) -> dict:
    """numpy tokens [b, s], next-token labels with every fourth masked (-1),
    and standard-normal patches or frames where the family takes them."""
    batch = family_batch(cfg, rng, b, s)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, ::4] = -1
    batch["labels"] = labels
    return batch


def loss_and_grads(cfg, params, batch: dict, dev):
    """(loss, gradient of every leaf in ``leaves`` order) of ``loss_fn`` on
    ``dev`` (leaves that no layer reads get a zero gradient, as in
    ``make_train_step``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves, unflatten
    flat = [x.detach().requires_grad_() for x in leaves(params)]
    on = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    loss = M.loss_fn(cfg, unflatten(params, flat), on)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def flash_vs_xla_grads(name, cfg32, params, batch, dev) -> tuple:
    """float32 loss and gradients with attn_impl="flash" (the CUDA-core
    forward and backward, launches counted) against "xla" on the card:
    the loss at LOSS_RTOL, each leaf within GRAD_REL of its largest
    |value|; returns (launches, worst leaf ratio)."""
    import torch
    from repro_torch.kernels import flash
    from repro_torch.pytree import items
    flash.reset_launch_count()
    loss_f, grads_f = loss_and_grads(cfg32, params, batch, dev)
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    loss_x, grads_x = loss_and_grads(dataclasses.replace(
        cfg32, attn_impl="xla"), params, batch, dev)
    rel = abs(float(loss_f) - float(loss_x)) / abs(float(loss_x))
    if not math.isfinite(float(loss_f)) or rel > LOSS_RTOL:
        raise AssertionError(f"{name} float32 loss flash {float(loss_f)} vs "
                             f"xla {float(loss_x)}")
    worst = 0.0
    for (key, _), a, b in zip(items(params), grads_f, grads_x, strict=True):
        top = float(b.abs().max())
        diff = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or diff > GRAD_REL * top:
            raise AssertionError(f"{name} float32 grad {key}: max |flash - "
                                 f"xla| {diff:.3e} > {GRAD_REL} x {top:.3e}")
        worst = max(worst, diff / max(top, 1e-30))
    log(f"{name} float32 loss + grads (TF32 off): flash vs xla on the card, "
        f"loss rel {rel:.2e} (tolerance {LOSS_RTOL}), worst leaf max |diff| "
        f"/ max |grad| {worst:.2e} (tolerance {GRAD_REL}); launches {counts}")
    return counts, worst


def smoke_card_vs_cpu(arch, rng, dev) -> dict:
    """The smoke config in float32 (TF32 off, attn_impl="flash", remat on),
    seed-0 weights on the card and on the CPU, one batch: for MoE the
    top-k expert ids of every layer equal first; then the loss at rtol
    1e-5 and every gradient leaf at GRAD_TOL, the flash launches (the
    CUDA-core kernels, per layer two forwards, one dq, one dk/dv, where
    the family takes flash)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.pytree import items, tree_map
    cfg = dataclasses.replace(registry.smoke_config(arch),
                              dtype=torch.float32, attn_impl="flash",
                              remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    dparams = tree_map(lambda x: x.to(dev), params)
    batch = smoke_train_batch(cfg, rng, SMOKE_B, SMOKE_S)
    if cfg.family == "moe":
        prefill = {k: v for k, v in batch.items() if k != "labels"}
        _, got, _ = spy_prefill(steps.make_prefill_step(cfg, device=dev),
                                dparams, prefill)
        _, want, _ = spy_prefill(steps.make_prefill_step(cfg, device="cpu"),
                                 params, prefill)
        for layer, (a, b) in enumerate(zip(got, want, strict=True)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{arch} smoke: expert choices of layer "
                                     f"{layer} differ between card and CPU")
    flash.reset_launch_count()
    loss, grads = loss_and_grads(cfg, dparams, batch, dev)
    torch.cuda.synchronize()
    counts = flash_variant_counts(flash)
    want_counts = step_launches(
        "simt" if cfg.family in ("moe", "vlm") else None, cfg.num_layers)
    if counts != want_counts:
        raise AssertionError(f"{arch} smoke float32 loss + grads: launches "
                             f"{counts}, expected {want_counts}")
    loss_h, grads_h = loss_and_grads(cfg, params, batch, "cpu")
    rel = abs(float(loss) - float(loss_h)) / abs(float(loss_h))
    if rel > 1e-5:
        raise AssertionError(f"{arch} smoke float32 loss card {float(loss)} "
                             f"vs CPU {float(loss_h)}")
    err = max(max_err_within(a.cpu(), b, GRAD_TOL[0],
                             f"{arch} smoke card vs CPU grad {key}",
                             GRAD_TOL[1])
              for (key, _), a, b in zip(items(params), grads, grads_h,
                                        strict=True))
    choices = " (expert choices equal in every layer)" \
        if cfg.family == "moe" else ""
    log(f"{arch} smoke float32 B={SMOKE_B} S={SMOKE_S} (TF32 off, remat): "
        f"card vs CPU port loss rel {rel:.2e} (tolerance 1e-5), every "
        f"gradient leaf max |diff| {err:.3e} (atol {GRAD_TOL[0]}, rtol "
        f"{GRAD_TOL[1]}){choices}; launches {counts or 0}")
    out = {"launches": counts}
    if arch in ("phi3_vision_4_2b", "deepseek_v2_236b"):
        out["flash_vs_xla"] = flash_vs_xla_grads(f"{arch} smoke", cfg,
                                                 dparams, batch, dev)
    return out


def train_batches(cfg, b: int, s: int, n: int, dev) -> list:
    """``n`` SyntheticStream batches, with the zero frames (encdec) that
    ``train()`` gives, and standard-normal patches (vlm, drawn from seed
    0).  Zero patches, as ``train()`` gives them, make every patch row's
    residual stream exactly 0 in every layer: each RMSNorm backward then
    multiplies those rows' gradient by rsqrt(eps) = 1000, which overflows
    past ~10 layers, and 0 x inf makes the weight gradients NaN -- in the
    JAX package's own train step too (tests/test_torch_families_train.py
    holds both packages to that at 19 layers)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b), device=dev)
    gen = torch.Generator().manual_seed(0)
    out = []
    for i in range(n):
        batch = data.batch_at(i)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.num_frames, cfg.d_model),
                                          dtype=cfg.dtype, device=dev)
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(
                (b, cfg.num_patches, cfg.d_model), generator=gen).to(
                dev, cfg.dtype)
        out.append(batch)
    return out


def step_launches(variant: str | None, layers: int) -> dict:
    """The flash launches of one train step with remat through
    ``variant``'s kernels: per layer two forwards (forward and
    recompute), one dq and one dk/dv; none where ``variant`` is None.
    The caller names the variant, so a head width the dispatch rule
    misroutes fails the launch gate."""
    if variant is None:
        return {}
    return {f"flash_fwd_lse/{variant}": 2 * layers,
            f"flash_bwd_dq/{variant}": layers,
            f"flash_bwd_dkv/{variant}": layers}


def grad_compress_card_vs_cpu(cfg, params, batch, dev) -> None:
    """``Int8Compressor.compress`` / ``decompress`` (the roundtrip) and
    ``topk_mask`` over the bf16 gradient tree of one olmoe step, on the
    card and on the CPU on the same tensors: codes, scales, residuals,
    decompressed gradients and masks equal bit for bit."""
    import torch
    from repro_torch.optim.grad_compress import Int8Compressor, topk_mask
    from repro_torch.pytree import items, leaves, tree_map, unflatten
    _, grads = loss_and_grads(cfg, params, batch, dev)
    tree = unflatten(params, list(grads))
    del grads
    comp = Int8Compressor()
    results = {}
    for where, g in (("card", tree), ("cpu", tree_map(lambda x: x.cpu(),
                                                      tree))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes, err = comp.compress(g, comp.init(g))
        back = comp.decompress(codes)
        t1 = time.perf_counter()
        masks = tree_map(lambda x: topk_mask(x, GC_TOPK_FRAC), g)
        torch.cuda.synchronize()
        results[where] = ((t1 - t0, time.perf_counter() - t1),
                          {"codes": tree_map(lambda qs: qs[0], codes),
                           "scales": tree_map(lambda qs: qs[1], codes),
                           "residuals": err, "decompressed": back,
                           "masks": masks})
    for part, tree_card in results["card"][1].items():
        cpu = dict(items(results["cpu"][1][part]))
        for key, x in items(tree_card):
            if not torch.equal(x.cpu(), cpu[key]):
                raise AssertionError(f"grad_compress {part} of {key}: card != "
                                     f"CPU")
    n = sum(x.numel() for x in leaves(tree))
    b, s = batch["tokens"].shape
    log(f"grad_compress over {cfg.name}'s bf16 gradient tree ("
        f"{cfg.num_layers} layer at full width, B={b} S={s}: "
        f"{len(leaves(tree))} leaves, {n:,} values,"
        f" {Int8Compressor.compressed_bytes(tree):,} int8 bytes against "
        f"{Int8Compressor.raw_bytes(tree):,} float32): int8 codes, scales, "
        f"residuals, decompressed gradients and topk_mask (frac "
        f"{GC_TOPK_FRAC}) card == CPU bit for bit; roundtrip and topk_mask: "
        f"card {results['card'][0][0] * 1e3:.1f} + "
        f"{results['card'][0][1] * 1e3:.1f} ms, CPU "
        f"{results['cpu'][0][0]:.2f} + {results['cpu'][0][1]:.2f} s (host "
        f"clock)")


def train_family(arch, cfg, params, dev, smi, b, s, want) -> dict:
    """TRAIN_STEPS bf16 ``make_train_step`` steps of one family on
    SyntheticStream batches, every launch counter set to 0 just before
    each and read just after (exactly ``want``); finite
    losses and parameters after the steps (a non-finite gradient would
    make them NaN through the clip); peak memory, the step walls (host
    clock around work ended by synchronize) and a profile of one step."""
    import torch
    from repro_torch.kernels import adamw, flash, minplus
    from repro_torch.launch import steps
    from repro_torch.pytree import leaves
    opt = steps.default_optimizer(cfg)
    opt_state = opt.init(params)
    step = steps.make_train_step(cfg, opt, device=dev)
    batches = train_batches(cfg, b, s, TRAIN_STEPS, dev)
    n = sum(1 for x in leaves(params) if x.numel())
    want_adamw = {"sumsq": n, "finalize": 1, "update": n}
    total, total_adamw = collections.Counter(), collections.Counter()
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        for mod in (flash, minplus, adamw):
            mod.reset_launch_count()
        t0 = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        counts = flash_variant_counts(flash)
        if counts != want or minplus.launch_count():
            raise AssertionError(f"{arch} bf16 train step: flash launches "
                                 f"{counts} (expected {want}), min-plus "
                                 f"{minplus.launch_count()}")
        got = {e: adamw.launch_count(e) for e in adamw.ENTRIES}
        applies = {p: adamw.apply_count(p) for p in adamw.PATHS}
        if got != want_adamw or applies != {"fused": 1, "per_leaf": 0}:
            raise AssertionError(f"{arch} bf16 train step: AdamW launches "
                                 f"{got} (expected {want_adamw}), applies "
                                 f"{applies} (expected one fused)")
        total.update(counts)
        total_adamw.update(got)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or not all(
            bool(torch.isfinite(x).all()) for x in leaves(params)):
        raise AssertionError(f"{arch} bf16 train steps: losses {losses} or "
                             f"the new params not finite")
    med = statistics.median(walls)
    tokens = b * s
    log(f"{cfg.name} bf16 train steps (depth {cfg.num_layers}, B={b} S={s}, "
        f"remat): losses {[round(x, 4) for x in losses]}, finite; flash "
        f"launches a step {want or 0}; step wall median {med:.2f} ms over "
        f"{TRAIN_STEPS} (min {min(walls):.2f}, max {max(walls):.2f}), "
        f"{tokens / med * 1e3:.0f} tokens/s; AdamW through the fused kernel "
        f"each step ({n} sumsq + 1 finalize + {n} update launches); peak "
        f"device memory {peak / 2**30:.2f} GiB on {smi}")
    prof = None
    if profiler_works():
        ps = TRAIN_PROFILE_S if cfg.sub_quadratic else s
        batch = train_batches(cfg, b, ps, 1, dev)[0]
        prof = profile_device(f"one {cfg.name} train step (depth "
                              f"{cfg.num_layers}, B={b}, S={ps}, bf16)",
                              lambda: step(params, opt_state, batch), top=8)
    if cfg.family == "vlm":
        log_flash_share(f"{cfg.name} train step (depth {cfg.num_layers}, "
                        f"B={b}, S={s}, bf16)", prof, med, "518.56 ms with "
                        "dq on the CUDA cores, the flash kernels 18.7% and "
                        "dq 15.6% of busy")
    out = {"launches": dict(total), "adamw_launches": dict(total_adamw),
           "step_ms": med, "peak_gib": peak / 2**30,
           "tokens_per_s": tokens / med * 1e3, "losses": losses}
    if arch in ADAMW_HELD:
        batch = train_batches(cfg, 1, ADAMW_HELD[arch], 1, dev)[0]
        out["adamw_held"] = hold_and_time_adamw(cfg, params, opt_state,
                                                batch, dev, smi)
    return out


def adamw_bytes(ps: list) -> int:
    """The bytes a fused apply moves over the leaves ``ps``: p and g (each
    in p's dtype) and float32 m and v read once, new p, m and v written
    once, and g read once more by the norm: 4 x p's element size + 16 B a
    parameter, 24 B a bf16 one and 32 B a float32 one."""
    return sum(x.numel() * (4 * x.element_size() + 16) for x in ps)


def timed_apply(fn, reps: int) -> float:
    """Median CUDA-event ms of ``fn`` over ``reps`` after one warm-up, the
    result dropped and the garbage collected after each call (the trees
    ``AdamW.apply`` returns hold a reference cycle, and two of them do not
    fit beside the inputs)."""
    import gc

    import torch
    times = []
    for i in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        del out
        gc.collect()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def hold_and_time_adamw(cfg, params, opt_state, batch, dev, smi) -> dict:
    """The fused AdamW's wrappers at a trained model's own leaves and state,
    on the gradients of ``batch``: the norm of ``global_norm`` within
    ADAMW_NORM_RTOL of the per-leaf path's and equal bit for bit over two
    calls, its clip scale equal to ``AdamW._clip_scale`` at that norm; p,
    m and v of ``update`` equal to ``AdamW._per_leaf``'s at that scale,
    leaf by leaf, at every element; then a whole fused apply
    (``AdamW.apply``) and a whole per-leaf apply (the norm and
    ``_per_leaf``, as the CPU runs it) timed, with the bound of
    :func:`adamw_bytes` at the peak bandwidth."""
    import gc

    import torch
    from repro_torch.kernels import adamw
    from repro_torch.launch import steps
    from repro_torch.pytree import leaves, unflatten
    gc.collect()    # the profiled step's trees
    torch.cuda.empty_cache()
    opt = steps.default_optimizer(cfg)
    _, grads = loss_and_grads(cfg, params, batch, dev)
    ps, ms, vs = (leaves(x) for x in (params, opt_state["m"],
                                      opt_state["v"]))
    gs = list(grads)
    del grads
    step = opt_state["step"] + 1
    lr = opt.schedule(step)
    t = step.float()
    bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    gnorm, scale = adamw.global_norm(gs, opt.clip_norm)
    again = adamw.global_norm(gs, opt.clip_norm)
    want = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    rel = abs(float(gnorm) - float(want)) / float(want)
    if not (torch.equal(again[0], gnorm) and torch.equal(again[1], scale)):
        raise AssertionError(f"{cfg.name} AdamW norm: two calls differ")
    if rel > ADAMW_NORM_RTOL or not torch.equal(scale,
                                                opt._clip_scale(gnorm)):
        raise AssertionError(f"{cfg.name} AdamW norm {float(gnorm)!r} vs "
                             f"the per-leaf path's {float(want)!r} (rel "
                             f"{rel:.2e}); scale {float(scale)!r} vs "
                             f"{float(opt._clip_scale(gnorm))!r}")

    def scalar(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    hyper = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps,
                 weight_decay=opt.weight_decay)
    differ, err = collections.Counter(), 0.0
    for leaf in zip(ps, gs, ms, vs):
        one = [[x] for x in leaf]
        got = adamw.update(*one, scale, scalar(lr), scalar(bc1), scalar(bc2),
                           **hyper)
        ref = opt._per_leaf(*one, scale, lr, bc1, bc2)
        for what, a, b in zip("pmv", got, ref):
            if a[0].numel():
                differ[what] += int((a[0] != b[0]).sum())
                err = max(err, float((a[0].float() - b[0].float()).abs()
                                     .max()))
        del got, ref
    if sum(differ.values()):
        raise AssertionError(f"{cfg.name} AdamW update: elements that differ "
                             f"from the per-leaf path's {dict(differ)}")
    tree_g = unflatten(params, gs)

    def per_leaf():
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
        return opt._per_leaf(ps, gs, ms, vs, opt._clip_scale(norm), lr, bc1,
                             bc2)

    gc.collect()
    torch.cuda.empty_cache()
    adamw.reset_launch_count()
    ms_fused = timed_apply(lambda: opt.apply(params, tree_g, opt_state), 5)
    if adamw.apply_count("fused") != 6 or adamw.apply_count("per_leaf"):
        raise AssertionError(f"{cfg.name} AdamW timing: applies "
                             f"{adamw.apply_count('fused')} fused, "
                             f"{adamw.apply_count('per_leaf')} per-leaf")
    ms_plain = timed_apply(per_leaf, 3)
    n = sum(x.numel() for x in ps)
    moved = adamw_bytes(ps)
    bound = moved / PEAK_BYTES_PER_S * 1e3
    dtypes = collections.Counter(str(x.dtype).removeprefix("torch.")
                                 for x in ps)
    shape = (f"{cfg.name} depth {cfg.num_layers}: {len(ps)} leaves, {n:,} "
             f"params")
    log(f"{cfg.name} AdamW at its {len(ps)} trained leaves ({dict(dtypes)}; "
        f"{n:,} params, {moved / 1e9:.2f} GB an apply): the fused norm "
        f"{float(gnorm):.6f} against the per-leaf path's rel {rel:.2e} "
        f"(tolerance {ADAMW_NORM_RTOL}), two calls equal bit for bit, the "
        f"clip scale {float(scale):.6f} equal to the per-leaf expression's; "
        f"p, m and v == the per-leaf path's at every element; an apply "
        f"fused {ms_fused:.2f} ms ({moved / ms_fused / 1e9:.2f} TB/s, "
        f"bound {bound:.2f} ms), per-leaf {ms_plain:.2f} ms on {smi}")
    del tree_g, gs
    gc.collect()
    torch.cuda.empty_cache()
    return {"shape": shape, "gnorm_rel": rel, "err": err, "ms": ms_fused,
            "plain_ms": ms_plain, "bound": (bound, "bytes")}


def train_families_phase(dev, smi: str, parked: dict, depths: dict) -> dict:
    """Phase 19 on the bf16 weights phases 17-18 ``parked`` (cut to
    ``train_depths``' ``depths``); returns the flash launches of each
    train path, the bf16 backward kernels' checks and times at
    phi-3-vision's, MLA's and olmoe's shapes, and each family's step
    figures."""
    import gc
    import tempfile

    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps, train
    from repro_torch.models import model as M
    from repro_torch.pytree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(19)
    out = {"launches": {}, "train": {}, "adamw": {}, "adamw_held": {}}
    start = time.perf_counter()

    def lap(what):
        log(f"  [phase 19: {what} at {time.perf_counter() - start:.1f} s]")

    # -- the bf16 backward kernels at the train paths' head widths
    out["bwd"] = {"phi3v": hold_and_time_bwd(rng, dev, *PHI3V_BWD, smi),
                  "mla": hold_and_time_bwd(rng, dev, *MLA_SHAPE, smi),
                  "olmoe": hold_and_time_bwd(rng, dev, *OLMOE_SHAPE,
                                             OLMOE_SHAPE[2], smi)}
    gc.collect()
    torch.cuda.empty_cache()
    lap("the backward kernels held and timed")

    # -- float32: the card against the CPU port, flash against xla
    for arch in SMOKE_ARCHS:
        res = smoke_card_vs_cpu(arch, rng, dev)
        out["launches"][f"{arch} smoke float32 loss + grads"] = \
            res["launches"]
    name = registry.config("phi3_vision_4_2b").name
    cfg32 = dataclasses.replace(registry.config("phi3_vision_4_2b"),
                                num_layers=1, dtype=torch.float32,
                                attn_impl="flash")
    params = M.init_params(cfg32, torch.Generator().manual_seed(0),
                           device=dev)
    batch = smoke_train_batch(cfg32, rng, 1, 512)
    counts, _ = flash_vs_xla_grads(f"{name} (full width, 1 layer, "
                                   f"{cfg32.num_patches} patches + 512 "
                                   f"tokens)", cfg32, params, batch, dev)
    if counts != {"flash_fwd_lse/simt": 2, "flash_bwd_dq/simt": 1,
                  "flash_bwd_dkv/simt": 1}:
        raise AssertionError(f"{name} float32 loss + grads: launches {counts}")
    out["launches"][f"{name} float32 loss + grads (1 layer)"] = counts
    del params
    lap("the float32 checks")

    # -- bf16 train steps of five families, depth cut by the reckoning
    for arch, unit, (b, s), variant in TRAIN_FAMILIES:
        full = registry.config(arch)
        depth, fits, over = depths[arch]
        cfg = dataclasses.replace(full, num_layers=depth, attn_impl="flash")
        need = (fits["state"] + fits["act"]) / 1e9
        why = (f"the whole model; its reckoning {need:.1f} GB" if over is None
               else f"{depth} of {full.num_layers} layers (in units of "
               f"{unit}): {fits['params'] / 1e9:.3f} B params x 22 B + "
               f"activations ~{fits['act'] / 1e9:.1f} GB = {need:.1f} GB; "
               f"{depth + unit} layers would need "
               f"{(over['state'] + over['act']) / 1e9:.1f} GB")
        log(f"{full.name} bf16 train step: depth {why} (card "
            f"{CARD_BYTES / 1e9:.0f} GB, {SPARE_BYTES / 1e9:.0f} GB kept "
            f"spare)")
        params = tree_map(lambda x: x.to(dev), parked.pop(arch))
        if arch == "olmoe_1b_7b":
            grad_compress_card_vs_cpu(
                dataclasses.replace(cfg, num_layers=1),
                cut_params(params, 1, dev),
                train_batches(cfg, b, s, 1, dev)[0], dev)
        res = train_family(arch, cfg, params, dev, smi, b, s,
                           step_launches(variant, depth))
        res.update(depth=depth, reckoning_gb=need)
        out["train"][full.name] = res
        out["launches"][f"{full.name} bf16 train steps"] = res["launches"]
        out["adamw"][f"{full.name} bf16 train steps"] = \
            res["adamw_launches"]
        if "adamw_held" in res:
            out["adamw_held"][full.name] = res["adamw_held"]
        del params
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{full.name} trained")

    # -- deepseek-v2 at full width, one layer: loss and gradients in bf16
    full = dataclasses.replace(registry.config("deepseek_v2_236b"),
                               num_layers=DEEPSEEK_LAYERS)
    cfg = dataclasses.replace(full, attn_impl="flash")
    params = tree_map(lambda x: x.to(dev), parked.pop("deepseek_v2_236b"))
    batch = train_batches(cfg, 1, 2048, 1, dev)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_count()
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, params, batch, dev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = flash_variant_counts(flash)
    peak = torch.cuda.max_memory_allocated()
    want = step_launches("sm90", DEEPSEEK_LAYERS)  # (192, 128)
    if counts != want:
        raise AssertionError(f"deepseek-v2 bf16 loss + grads: launches "
                             f"{counts}, expected {want}")
    if not math.isfinite(float(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("deepseek-v2 bf16 loss or gradients not finite")
    del grads
    out["launches"]["deepseek-v2 bf16 loss + grads"] = counts
    out["deepseek"] = {"ms": wall, "peak_gib": peak / 2**30}
    log(f"deepseek-v2 (full width, {DEEPSEEK_LAYERS} layer, remat) bf16 loss "
        f"+ grads B=1 S=2048: loss {float(loss):.4f}, finite gradients; "
        f"launches {counts}; {wall:.2f} ms (the first call); peak device "
        f"memory {peak / 2**30:.2f} GiB on {smi}")
    prof = None
    if profiler_works():
        prof = profile_device("one deepseek-v2 loss + grads (1 layer, B=1, "
                              "S=2048, bf16)", lambda: loss_and_grads(
                                  cfg, params, batch, dev), top=8)
    log_flash_share("deepseek-v2 layer loss + grads (B=1, S=2048, bf16; the "
                    "first call's wall)", prof, wall, "122.63 ms with dq "
                    "on the CUDA cores, dq 25.7% of busy")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("deepseek-v2's loss and gradients")

    # -- train() on the smoke configs in float32: card == CPU, a restart
    smoke = registry.smoke_config
    registry.smoke_config = lambda arch: dataclasses.replace(
        smoke(arch), dtype=torch.float32)
    try:
        kw = dict(preset="smoke", steps=TRAIN_STEPS, batch=2, seq=128,
                  log_every=1000, lr=1e-3)
        for arch in SMOKE_ARCHS:
            card = train.train(arch, device=dev, **kw)
            cpu = train.train(arch, device="cpu", **kw)
            rel = max(abs(a - c) / abs(c) for a, c in
                      zip(card.losses, cpu.losses, strict=True))
            if len(card.losses) != TRAIN_STEPS or rel > 1e-5:
                raise AssertionError(f"train('{arch}') card {card.losses} vs "
                                     f"CPU {cpu.losses}")
            log(f"train('{arch}', preset='smoke') float32, {TRAIN_STEPS} "
                f"steps at B=2 S=128: card == CPU port, losses rel "
                f"{rel:.1e} (tolerance 1e-5)")
        with tempfile.TemporaryDirectory() as tmp:
            kw.update(steps=4, ckpt_every=2)
            whole = train.train("whisper_base", device=dev, **kw)
            try:
                train.train("whisper_base", device=dev, ckpt_dir=tmp,
                            fail_at=3, **kw)
            except RuntimeError as exc:
                if "injected node failure" not in str(exc):
                    raise
            else:
                raise AssertionError("the injected failure did not fire")
            resumed = train.train("whisper_base", device=dev, ckpt_dir=tmp,
                                  **kw)
    finally:
        registry.smoke_config = smoke
    rel = max(abs(a - c) / abs(c) for a, c in
              zip(resumed.losses, whole.losses[2:], strict=True))
    if resumed.resumed_from != 2 or rel > 1e-5:
        raise AssertionError(f"whisper restart: resumed from "
                             f"{resumed.resumed_from}, losses "
                             f"{resumed.losses} vs {whole.losses}")
    log(f"train('whisper_base') float32 on the card, 4 steps, killed at step "
        f"3 and resumed from step {resumed.resumed_from}: losses "
        f"{resumed.losses} == the uninterrupted run's last two (rel "
        f"{rel:.1e}, tolerance 1e-5)")

    lap("the smoke train() runs")

    # -- remat_policy="dots" against "full": smollm-135m, one bf16 step
    full = registry.config("smollm_135m")
    cfg = dataclasses.replace(full, attn_impl="flash")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    batch = train_batches(cfg, 4, 2048, 1, dev)[0]
    res = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        opt = steps.default_optimizer(c)
        step = steps.make_train_step(c, opt, device=dev)
        state = opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.reset_launch_count()
        loss, _, _ = step(params, state, batch)
        torch.cuda.synchronize()
        res[policy] = (float(loss), flash_variant_counts(flash),
                       torch.cuda.max_memory_allocated() / 2**30)
        del state, step
    want = step_launches("sm90", full.num_layers)
    if res["dots"][:2] != res["full"][:2] or res["full"][1] != want:
        raise AssertionError(f"remat_policy dots {res['dots']} vs full "
                             f"{res['full']} (launches expected {want})")
    log(f"smollm-135m bf16 train step B=4 S=2048, remat_policy='dots' vs "
        f"'full': loss {res['dots'][0]:.6f} == {res['full'][0]:.6f}, "
        f"launches {res['dots'][1]} == full's; peak device memory "
        f"{res['dots'][2]:.2f} GiB (dots) vs {res['full'][2]:.2f} GiB (full)")
    out["dots"] = res
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lap("remat 'dots'")
    return out


# -- phase 20: the production-mesh dry-run and the lint -----------------------

# the cells whose steps run over DTensors on the fake 256-chip group
AUDIT_CELLS = (("olmo_1b", "train_4k"), ("olmo_1b", "prefill_32k"))
# the cells whose rank-0 shards are made on the card
SHARD_CELLS = (("smollm_135m", "train_4k"), ("olmoe_1b_7b", "train_4k"),
               ("smollm_135m", "decode_32k"))


def dryrun_phase(dev) -> None:
    """Phase 20: the dry-run's records over the grid, the collective audit
    of ``AUDIT_CELLS``, the card's bytes for rank 0's shards of
    ``SHARD_CELLS`` against the records, and the lint."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.pytree import leaves

    t = time.perf_counter()
    records = {}
    for arch in registry.ARCH_IDS:
        for shape in SHAPES:
            for multi in (False, True):
                rec = dryrun.run_cell(arch, shape, multi)
                if rec["status"] not in ("ok", "skip"):
                    raise AssertionError(f"dry-run {arch} {shape}: {rec}")
                records[arch, shape, multi] = rec
    n_ok = sum(r["status"] == "ok" for r in records.values())
    log(f"phase 20: {len(records)} cells, {n_ok} ok, "
        f"{len(records) - n_ok} skip, in {time.perf_counter() - t:.1f} s")

    for arch, shape in AUDIT_CELLS:
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, False, collectives=True)
        coll = rec["collectives"]
        if rec["status"] != "ok" or not coll["per_op"]:
            raise AssertionError(f"collective audit {arch} {shape}: {rec}")
        per_op = {op: (d["count"], d["bytes"])
                  for op, d in sorted(coll["per_op"].items())}
        log(f"phase 20: {arch} {shape} pod16x16 collectives (count, bytes "
            f"a device) {per_op}; total {coll['total_bytes']} B, effective "
            f"{coll['effective_bytes']:.6g} B; audit {rec['audit_s']:.1f} s "
            f"({time.perf_counter() - t:.1f} s with the specs)")

    mesh = dryrun.make_production_mesh()
    for arch, shape in SHARD_CELLS:
        spec = SHAPES[shape]
        cfg = dryrun.cell_config(arch, {})
        args = dryrun.cell_args(arch, cfg, spec, mesh)
        before = torch.cuda.memory_allocated()
        shards = [torch.empty(dryrun.local_shape(x.shape, s, mesh),
                              dtype=x.dtype, device=dev)
                  for name in args.trees
                  for x, s in zip(leaves(args.trees[name]),
                                  leaves(args.specs[name]))]
        got = sum(x.untyped_storage().nbytes() for x in shards)
        want = records[arch, shape, False]["memory"]["argument_bytes"]
        log(f"phase 20: {arch} {shape} pod16x16 rank-0 shards "
            f"({', '.join(args.trees)}): {got} B made on the card, record "
            f"{want} B; torch.cuda.memory_allocated() "
            f"{torch.cuda.memory_allocated() - before} B above the "
            f"{before} B before")
        if got != want:
            raise AssertionError(f"{arch} {shape}: {got} != {want}")
        del shards
        torch.cuda.empty_cache()

    lint = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "src/", "tests/",
         "benchmarks/", "chip_smoke.py", "--strict"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    log(f"phase 20: {lint.stdout.strip().splitlines()[-1]}")
    if lint.returncode != 0 or "0 violations" not in lint.stdout:
        raise AssertionError(lint.stdout + lint.stderr)


def merge_rows(minplus_rows: list[dict], flash_rows: list[dict],
               catalog: dict, wide: dict, stack: dict, oracles: dict,
               moe_mla: dict, families: dict, trained: dict) -> list[dict]:
    """The kernels line.  The kernels on this run's newest paths report
    those paths' launches (phase 16's SA, exact and bounds solves for the
    closure kernel, the catalog's V = 48 solves for the product, the
    phi-3-vision prefills of phase 18 for both forward kernels -- bf16
    through the tensor-core one, float32 through the CUDA-core one -- and
    the bf16 train steps of phase 19 for the four backward kernels);
    every path's count stands in "launches_by_path".  "timed_at" names the
    shape of the row's times; "also_timed" keeps the row's times at the
    other shapes this run timed it at (the CUDA-core kernels forced at
    the shapes the tensor-core ones now take)."""
    from repro_torch.kernels import minplus

    def timed_of(row):
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")}

    for row, entry in zip(minplus_rows, minplus.ENTRIES):
        row["launches_by_path"] = {"§V large solves (phase 3)":
                                   row["launches"],
                                   "catalog (phase 13)": catalog[entry],
                                   "serving stack (phase 15)": stack[entry],
                                   "SA, exact and bounds (phase 16)":
                                   oracles["launches"][entry],
                                   "serve.run('whisper_base') (phase 18)":
                                   families["minplus"][entry]}
        row["launches"] = oracles["launches"][entry] or catalog[entry]
        row["timed_at"] = "[62,24,24] f32"
    for row in flash_rows:
        row["timed_at"] = f"[{','.join(map(str, PREFILL_SHAPE))}] bf16"
        if row["name"] not in ("flash_fwd_lse", "flash_fwd_lse_sm90"):
            continue
        variant = "simt" if row["name"] == "flash_fwd_lse" else "sm90"
        earlier = ("smollm-135m float32 prefill (phase 6)",
                   "minicpm-2b float32 prefill (phase 14)", wide["f32"]) \
            if variant == "simt" else \
            ("smollm-135m bf16 prefill (phase 6)",
             "minicpm-2b bf16 prefill (phase 14)", wide["bf16"])
        row["launches_by_path"] = {earlier[0]: row["launches"],
                                   earlier[1]: earlier[2]}
        row["also_timed"] = {}
        if variant == "sm90":
            row["also_timed"][f"[{','.join(map(str, MINICPM_SHAPE))}] bf16"] \
                = {"ms": wide["ms"], "plain_ms": wide["plain_ms"],
                   "bound_ms": wide["bound"][0],
                   "library_ms": wide["sdpa_ms"]}
            row["max_abs_err"] = max(row["max_abs_err"], wide["err"])
        # each newer path's launches; the newest path that launched this
        # kernel, where this run timed the kernel at that path's shape,
        # gives the row its launches and its times
        for phase, runs, helds in (
                (17, moe_mla["launches"], (moe_mla["olmoe"], moe_mla["mla"])),
                (18, families["launches"], (families.get("phi3v"),)),
                (19, trained["launches"], ())):
            mine = {what: counts.get(f"flash_fwd_lse/{variant}", 0)
                    for what, counts in runs.items()}
            mine = {what: n for what, n in mine.items() if n}
            for what, n in mine.items():
                row["launches_by_path"][f"{what} (phase {phase})"] = n
            for held in helds:
                if held is None:
                    continue
                mine_held = (held if held["variant"] == variant
                             else held.get(variant))
                if mine_held is None:
                    continue
                row["also_timed"][row["timed_at"]] = timed_of(row)
                row.update(max_abs_err=max(row["max_abs_err"],
                                           mine_held["err"]),
                           ms=mine_held["ms"], plain_ms=held["plain_ms"],
                           bound_ms=held["bound"][0],
                           bound_by=held["bound"][1],
                           library_ms=held["sdpa_ms"], timed_at=held["shape"])
                if mine:
                    row["launches"] = sum(mine.values())
        row["also_timed"].pop(row["timed_at"], None)
    # the backward kernels: phase 19's bf16 train paths give the launches;
    # each kernel this run timed at phi-3-vision's, MLA's and olmoe's
    # shapes takes its times at phi-3-vision's (the others' and the smollm
    # training shape's under "also_timed")
    for row in flash_rows:
        if not row["name"].startswith("flash_bwd"):
            continue
        entry = row["name"].removesuffix("_sm90")
        variant = "sm90" if row["name"].endswith("_sm90") else "simt"
        earlier = ("smollm-135m bf16 train steps (phase 11)" if variant ==
                   "sm90" else "smollm-135m float32 loss + grads (phase 11)")
        row["launches_by_path"] = {earlier: row["launches"]}
        bf16 = 0
        for what, counts in trained["launches"].items():
            n = counts.get(f"{entry}/{variant}", 0)
            if n:
                row["launches_by_path"][f"{what} (phase 19)"] = n
                bf16 += n if "bf16" in what else 0
        if bf16:
            row["launches"] = bf16
        for key in ("olmoe", "mla", "phi3v"):
            held = trained["bwd"][key]
            if (entry, variant) not in held["ms"]:
                continue
            row.setdefault("also_timed", {})[row["timed_at"]] = \
                timed_of(row)
            row["max_abs_err"] = max(row["max_abs_err"],
                                     held["err"][(entry, variant)])
            row.update(ms=held["ms"][(entry, variant)],
                       plain_ms=held["plain_ms"][entry],
                       bound_ms=held["bound"][entry][0],
                       bound_by=held["bound"][entry][1],
                       library_ms=held["sdpa_ms"], timed_at=held["shape"])
        if "also_timed" in row:
            row["also_timed"].pop(row["timed_at"], None)
    return minplus_rows + flash_rows + [adamw_row(trained)]


def adamw_row(trained: dict) -> dict:
    """The kernels line's row of the fused AdamW (its three entries as one
    apply): the launches of phase 19's bf16 train steps, all three entries
    together, by path and by entry; the times and the bound at the olmoe
    train cell's leaves (the other held family's under "also_timed"); the
    largest difference from the per-leaf path's p, m and v (0 when equal)
    and the norm's relative difference."""
    held = trained["adamw_held"]
    first, *rest = held.values()
    by_entry = collections.Counter()
    for counts in trained["adamw"].values():
        by_entry.update(counts)
    return {"name": "adamw", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/adamw.cu",
            "replaces": "none: port-only (src/repro/optim/adamw.py runs plain "
                        "jnp ops); on the card it replaces AdamW._per_leaf "
                        "(src/repro_torch/optim/adamw.py)",
            "launches": sum(by_entry.values()),
            "launches_by_entry": dict(by_entry),
            "launches_by_path": {f"{what} (phase 19)": sum(counts.values())
                                 for what, counts in
                                 trained["adamw"].items()},
            "max_abs_err": max(h["err"] for h in held.values()),
            "norm_rel_err": max(h["gnorm_rel"] for h in held.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound"][0], "bound_by": first["bound"][1],
            "library_ms": None, "timed_at": first["shape"],
            "also_timed": {h["shape"]: {"ms": h["ms"],
                                        "plain_ms": h["plain_ms"],
                                        "bound_ms": h["bound"][0],
                                        "library_ms": None} for h in rest}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import adamw, flash, minplus

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
                                for stem in flash.STEMS] + [adamw.build]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        libs = [pool.submit(b) for b in builds]         # one nvcc each
        lib_paths = [f.result() for f in libs]
    log(f"built {', '.join(p.name for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for build_log in (minplus.build_log, *flash.build_log.values(),
                      adamw.build_log):
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    for stem, lib in zip(flash.STEMS, lib_paths[1:]):
        if stem.endswith("_sm90"):
            count_tensor_core_sass(stem, lib)
    for stem in flash.STEMS:
        if stem.endswith("_sm90"):
            assert_no_spills(stem, flash.build_log)
    assert_no_spills("adamw", {"adamw": adamw.build_log})

    log(f"phase 1 took {time.perf_counter() - t_start:.1f} s")
    t = time.perf_counter()
    minplus_rows = routing_phases(dev, smi)
    log(f"phases 2-4 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    flash_entries = serving_phases(dev, smi)
    log(f"phases 5-9 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bwd_entries = training_phases(dev, smi)
    log(f"phases 10-12 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    catalog = catalog_phase(dev, smi)
    log(f"phase 13 took {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wide = full_width_phase(dev, smi)
    log(f"phase 14 took {time.perf_counter() - t:.1f} s")
    t15 = time.perf_counter()
    stack = serving_stack_phase(dev, smi)
    log(f"phase 15 took {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    oracles = oracles_phase(dev, smi)
    log(f"phase 16 took {time.perf_counter() - t16:.1f} s")
    depths = train_depths()
    keep, parked = parking(depths)
    t17 = time.perf_counter()
    moe_mla = moe_mla_phase(dev, smi, keep)
    log(f"phase 17 took {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    families = families_phase(dev, smi, keep)
    log(f"phase 18 took {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    trained = train_families_phase(dev, smi, parked, depths)
    log(f"phase 19 took {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    dryrun_phase(dev)
    log(f"phase 20 took {time.perf_counter() - t20:.1f} s")

    rows = merge_rows(minplus_rows, flash_entries + bwd_entries, catalog,
                      wide, stack, oracles, moe_mla, families, trained)
    log(f"phases 1-20 took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
