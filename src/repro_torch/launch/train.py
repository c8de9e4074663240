"""Training driver: fault-tolerant loop with checkpoint/restart.

Counterpart of ``repro.launch.train`` for every family (the encdec and
vlm stubs take zero frames and zero patches, as there): deterministic
data, the port's train step, atomic checkpoints, a straggler monitor, and
resume from the newest checkpoint that repeats an uninterrupted run.  Like
the reference it trains with the registry config's ``attn_impl``.  Runs on
the card by default and raises without one unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --preset smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FailureInjector, StragglerMonitor
from repro_torch.launch.steps import default_optimizer, make_train_step
from repro_torch.models import model as M
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class TrainResult:
    losses: list
    final_step: int
    resumed_from: int | None
    straggler_flags: int


def train(arch: str, *, preset: str = "smoke", steps: int = 100,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 50, seed: int = 0,
          fail_at: int | None = None, log_every: int = 10,
          d_model_override: int | None = None,
          lr: float | None = None, warmup: int | None = None,
          device: str | torch.device = "cuda") -> TrainResult:
    dev = resolve_device(device)
    cfg = (registry.smoke_config(arch) if preset == "smoke"
           else registry.config(arch))
    if d_model_override:
        cfg = dataclasses.replace(cfg, d_model=d_model_override)
    if lr is not None:
        wu = warmup if warmup is not None else max(steps // 10, 5)
        opt = AdamW(schedule=lambda s: schedules.warmup_cosine(
            s, peak_lr=lr, warmup_steps=wu, total_steps=max(steps, wu + 1)))
    else:
        opt = default_optimizer(cfg)
    step_fn = make_train_step(cfg, opt, device=dev)

    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed), device=dev)

    params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                           device=dev)
    opt_state = opt.init(params)
    start = 0
    resumed_from = None
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state = ckpt.place(ckpt.restore(
                ckpt_dir, last, {"params": params, "opt": opt_state}), dev)
            params, opt_state = state["params"], state["opt"]
            start = last
            resumed_from = last

    injector = FailureInjector(fail_at)
    monitor = StragglerMonitor()
    losses = []
    for step in range(start, steps):
        injector.check(step)
        t0 = time.time()
        b = data.batch_at(step)
        if cfg.family == "encdec":
            b["frames"] = torch.zeros((batch, cfg.num_frames, cfg.d_model),
                                      dtype=cfg.dtype, device=dev)
        if cfg.family == "vlm":
            b["patches"] = torch.zeros((batch, cfg.num_patches, cfg.d_model),
                                       dtype=cfg.dtype, device=dev)
        loss, params, opt_state = step_fn(params, opt_state, b)
        loss = float(loss)
        monitor.record(time.time() - t0)
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step} loss {loss:.4f}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1,
                      {"params": params, "opt": opt_state})
            ckpt.prune(ckpt_dir)
    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, {"params": params, "opt": opt_state})
    return TrainResult(losses=losses, final_step=steps,
                       resumed_from=resumed_from,
                       straggler_flags=monitor.flagged)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    res = train(args.arch, preset=args.preset, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                seed=args.seed, device=args.device)
    print(f"[train] done: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f} "
          f"(resumed_from={res.resumed_from})")


if __name__ == "__main__":
    main()
