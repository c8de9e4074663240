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
     (device busy time by kernel, idle share);
  5. hold the flash-attention kernel (``csrc/flash_fwd.cu``, both entry
     points) against its plain version on the card, at the prefill's
     shape ([36, 2048, 64] bf16), at float32 shapes with d = dv and
     d != dv, at ragged and short lengths, causal and not;
  6. drive the serving path's prefill: ``make_prefill_step`` on
     smollm-135m at full width (random weights from seed 0), float32 with
     TF32 off at B=2, S=512 with attn_impl="flash" against "xla"; then
     bfloat16 at B=4, S=2048 with every launch counter set to 0 just
     before and read just after (one flash launch per layer);
  7. drive ``DecodeEngine`` at full width (bf16, 4 prompts x 128 tokens,
     32 generated): the flash prefill's last logits against a
     ``serve_step`` loop, and both prefill modes' tokens equal;
  8. drive ``launch/serve.py``'s main path on the card (the routed plan
     through the min-plus kernel, the decode engine), its plan equal to
     the CPU port's bit for bit;
  9. time the flash kernel, its plain version and
     ``F.scaled_dot_product_attention`` (the library yardstick, never
     called by the port) at the prefill's shape, the prefill step and
     decode, and profile one prefill and one decode step with
     ``torch.profiler``.

The line before the last is a JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or run from a directory without the repository's ``src/``, it exits with a
nonzero code and prints no result.  It imports nothing of JAX and nothing
of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
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

FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # O; tests/test_kernels.py
LSE_TOL = 1e-5
# (bh, S, d, dv, dtype, causal); the first is the prefill's per-layer shape
FLASH_CASES = [(36, 2048, 64, 64, "bfloat16", True),
               (8, 256, 64, 64, "float32", True),
               (2, 256, 192, 128, "float32", True),
               (4, 1000, 64, 64, "bfloat16", True),
               (3, 130, 64, 64, "float32", True),
               (2, 64, 64, 64, "float32", True),
               (2, 300, 64, 32, "float32", False)]


def flash_inputs(rng, bh, s, d, dv, dtype, dev):
    import torch
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            .to(dev, tdt) for shape in ((bh, s, d), (bh, s, d), (bh, s, dv))]


def max_err_within(got, want, tol: float, what: str) -> float:
    """Max |got - want|; raises unless |got - want| <= tol + tol * |want|
    everywhere (and every value is finite)."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or \
            bool((diff > tol + tol * want.abs()).any()):
        raise AssertionError(f"{what}: max |diff| {float(diff.max()):.3e} "
                             f"exceeds tolerance {tol}")
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
    """Phases 5-9; returns the two flash entries of the kernels line."""
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

    # -- 5. the flash kernel against its plain version ------------------------
    err = {"flash_fwd_lse": 0.0, "flash_attention_bhsd": 0.0}
    for bh, s, d, dv, dtype, causal in FLASH_CASES:
        q, k, v = flash_inputs(rng, bh, s, d, dv, dtype, dev)
        scale = 1 / math.sqrt(d)
        o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=causal)
        want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale,
                                                 causal=causal)
        torch.cuda.synchronize()
        what = f"flash_fwd_lse {dtype} [{bh},{s},{d}->{dv}] causal={causal}"
        e_o = max_err_within(o, want_o, FLASH_TOL[dtype], what + " O")
        e_l = max_err_within(lse, want_lse, LSE_TOL, what + " lse")
        err["flash_fwd_lse"] = max(err["flash_fwd_lse"], e_o, e_l)
        log(f"{what}: max |O - plain| {e_o:.3e}, max |lse - plain| "
            f"{e_l:.3e}")
        if (s, dtype) in ((2048, "bfloat16"), (256, "float32"),
                          (1000, "bfloat16")) and d == dv:
            o2 = flash.flash_attention_bhsd(q, k, v, scale=scale,
                                            causal=causal)
            torch.cuda.synchronize()
            e2 = max_err_within(o2, want_o, FLASH_TOL[dtype],
                                f"flash_attention_bhsd {dtype} [{bh},{s}]")
            err["flash_attention_bhsd"] = max(err["flash_attention_bhsd"], e2)
            log(f"  no-lse entry point at [{bh},{s},{d}]: max |O - plain| "
                f"{e2:.3e}")

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
    if flash.launch_count() != full.num_layers:
        raise AssertionError(f"float32 prefill: {flash.launch_count()} flash "
                             f"launches, expected {full.num_layers}")
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
    launches = flash.launch_count()
    no_lse_launches = flash.launch_count("flash_attention_bhsd")
    log(f"bf16 prefill B=4 S=2048 (the serving path): {launches} "
        f"flash_fwd_lse launches, {no_lse_launches} no-lse launches, "
        f"{minplus.launch_count()} min-plus launches")
    if launches != full.num_layers:
        raise AssertionError(f"bf16 prefill: {launches} flash launches, "
                             f"expected {full.num_layers}")
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
    bh, s, d = 36, 2048, 64
    q, k, v = flash_inputs(rng, bh, s, d, d, "bfloat16", dev)
    scale = 1 / math.sqrt(d)
    t = {
        "flash_fwd_lse": event_ms(lambda: flash.flash_fwd_lse(
            q, k, v, scale=scale), reps=10, inner=10),
        "flash_attention_bhsd": event_ms(lambda: flash.flash_attention_bhsd(
            q, k, v, scale=scale), reps=10, inner=10),
        "plain": event_ms(lambda: ref.flash_fwd_lse_ref(q, k, v, scale=scale),
                          reps=5, inner=3),
        "sdpa": event_ms(lambda: F.scaled_dot_product_attention(
            *(x.unflatten(0, (4, -1)) for x in (q, k, v)),   # [B, H, S, d]
            is_causal=True, scale=scale), reps=10, inner=10),
    }
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    bound = {e: flash_bound(bh, s, d, d, "bfloat16", True,
                            e == "flash_fwd_lse") for e in err}
    log(f"timings on {smi}:")
    for e in err:
        log(f"  {e} [{bh},{s},{d}] bf16 causal: {t[e] * 1e3:.1f} us per "
            f"call; bound {bound[e][0] * 1e3:.2f} us ({bound[e][1]})")
    log(f"  plain version: {t['plain'] * 1e3:.1f} us; "
        f"F.scaled_dot_product_attention (library yardstick): "
        f"{t['sdpa'] * 1e3:.1f} us")
    log(f"  prefill step smollm-135m B=4 S=2048 bf16: median "
        f"{statistics.median(prefill_ms):.2f} ms over 5 (min "
        f"{min(prefill_ms):.2f}, max {max(prefill_ms):.2f}); "
        f"{launches} flash launches per prefill, "
        f"{launches * t['flash_fwd_lse']:.2f} ms of them by the kernel's "
        f"time per call")
    log(f"  decode (DecodeEngine, 4 x 32 tokens after 128): "
        f"{res.tokens_per_s:.1f} tok/s")
    dcache = M.init_cache(cfg, 4, 168, device=dev)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    try:
        profile_device("one prefill (B=4, S=2048, bf16)",
                       lambda: step(params, batch), top=10)
        profile_device("one decode step (B=4, bf16)", lambda: serve_step(
            params, dcache, {"tokens": tok, "pos": 128}), top=6)
    except RuntimeError as exc:     # a profiler that cannot trace here
        log(f"profile: not measured ({exc})")

    return [{
        "name": e,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": ("src/repro/kernels/flash.py:125 (_flash_fwd_lse_kernel, "
                     "flash_fwd_lse at :259)" if e == "flash_fwd_lse" else
                     "src/repro/kernels/flash.py:35 (_flash_kernel, "
                     "flash_attention_bhsd at :85; not on the serving path)"),
        "launches": launches if e == "flash_fwd_lse" else no_lse_launches,
        "max_abs_err": err[e],
        "ms": t[e],
        "plain_ms": t["plain"],
        "bound_ms": bound[e][0],
        "bound_by": bound[e][1],
        "library_ms": t["sdpa"],
    } for e in err]



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.core import jobs as J, network as N, schedule, solvers
    from repro_torch.kernels import flash, minplus, ops, ref

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
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc each
        libs = [pool.submit(mod.build) for mod in (minplus, flash)]
        lib_paths = [f.result() for f in libs]
    log(f"built {', '.join(p.name for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for mod in (minplus, flash):
        for line in mod.build_log.splitlines():
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
        profile_device("one greedy solve",
                       lambda: solvers.solve(net, batch, method="greedy"))
    except RuntimeError as err:     # a profiler that cannot trace here
        log(f"profile: not measured ({err})")

    flash_entries = serving_phases(dev, smi)

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
    }] + flash_entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
