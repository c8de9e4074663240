"""Serving driver: routed scheduling + batched decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \
      --requests 4 --gen 16 --device cuda

Counterpart of ``repro.launch.serve``: the routed scheduler places the
requests on the default cluster (the plan's min-plus closures run on the
hand-written kernel on the card), then a :class:`DecodeEngine` decodes
them with the arch's smoke config and random weights from seed 0 (an
encdec arch decodes against the encoding of zero frames).
``--device`` defaults to ``cuda`` and fails without a card; ``--device
cpu`` runs the kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import network as N
from repro_torch.device import resolve_device
from repro_torch.models import encdec
from repro_torch.models import model as M
from repro_torch.serving.engine import DecodeEngine, GenerationResult
from repro_torch.serving.scheduler import Placement, Request, RoutedScheduler


def default_cluster(*, device: str | torch.device = "cuda"
                    ) -> N.ComputeNetwork:
    G, GB = 1e12, 1e9
    return N.make_network(
        6,
        [(0, 1, 10 * GB), (1, 2, 40 * GB), (2, 3, 40 * GB), (3, 4, 40 * GB),
         (4, 5, 10 * GB), (1, 3, 40 * GB), (2, 4, 40 * GB)],
        [0, 50 * G, 50 * G, 50 * G, 50 * G, 0], device=device)


def run(arch: str = "smollm_135m", requests: int = 4, gen: int = 16,
        prompt_len: int = 8, method: str = "greedy", *,
        device: str | torch.device = "cuda", verbose: bool = True
        ) -> tuple[RoutedScheduler, list[Placement], GenerationResult]:
    dev = resolve_device(device)
    sched = RoutedScheduler(default_cluster(device=dev), method=method)
    plans = sched.schedule([
        Request(arch, src=0, dst=5, seq_len=2048, name=f"req{i}")
        for i in range(requests)])
    if verbose:
        for p in plans:
            print(f"[serve] prio {p.priority} {p.job_name}: slices "
                  f"{p.nodes_used} bound {p.bound_s*1e3:.2f} ms")
        print(f"[serve] plan: solver={sched.last_plan.solver} "
              f"makespan bound {sched.last_plan.bound()*1e3:.2f} ms")

    cfg = registry.smoke_config(arch)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    engine = DecodeEngine(cfg, params, max_len=prompt_len + gen + 8,
                          device=dev)
    prompts = np.tile(np.arange(prompt_len, dtype=np.int32)[None],
                      (requests, 1))
    extra = {}
    if cfg.family == "encdec":
        frames = torch.zeros((requests, cfg.num_frames, cfg.d_model),
                             dtype=cfg.dtype, device=dev)
        with torch.no_grad():
            extra["enc_out"] = encdec.encode(cfg, params, frames, remat=False)
    res = engine.generate(prompts, gen_len=gen, extra_batch=extra)
    if verbose:
        print(f"[serve] {requests} requests x {gen} tokens: "
              f"{res.tokens_per_s:.1f} tok/s (decode {res.decode_s:.2f}s)")
    return sched, plans, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--method", default="greedy",
                    help="routing solver (greedy|lazy|greedy_ref)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    run(args.arch, args.requests, args.gen, args.prompt_len, args.method,
        device=args.device)


if __name__ == "__main__":
    main()
