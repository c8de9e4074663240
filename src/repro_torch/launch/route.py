"""Paper driver: route DNN inference jobs over the evaluation topologies.

  PYTHONPATH=src python -m repro_torch.launch.route --topology us \
      --jobs vgg19:6,resnet34:2,synthetic:2 --scale 1e-4 \
      --methods greedy,sa --seed 0 --device cuda

``--methods`` takes any comma list of registered solver names (see
``repro_torch.core.solvers.available()``), e.g. ``greedy,lazy,sa,exact``;
``sa`` runs the reference's defaults (4 chains, cooling factor
``sa_iters_d``).  ``--device`` defaults to
``cuda`` and fails without a card; ``--device cpu`` runs the plain
versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import jobs as J, network as N, solvers
from repro_torch.configs import registry
from repro_torch.kernels import minplus

_SA_DEFAULTS = dict(num_chains=4)

def build_jobs(spec: str, num_nodes: int, seed: int) -> list[J.InferenceJob]:
    rng = np.random.default_rng(seed)
    out = []
    for part in spec.split(","):
        name, count = part.split(":")
        for i in range(int(count)):
            src, dst = rng.choice(num_nodes, size=2, replace=False)
            if name in registry.PAPER_MODELS:
                out.append(registry.get(name).make_job(
                    f"{name}-{i}", int(src), int(dst)))
            elif name == "synthetic":
                out.append(J.synthetic_job(f"syn-{i}", int(src), int(dst),
                                           num_layers=24, seed=seed + i,
                                           flops_scale=2e9, bytes_scale=2e6))
            else:
                comp, data = registry.cost_profile(name, seq_len=2048,
                                                   batch=1)
                out.append(J.InferenceJob(f"{name}-{i}", int(src), int(dst),
                                          comp.astype(np.float32),
                                          data.astype(np.float32)))
    return out


def run(topology: str, jobs_spec: str, scale: float, methods: str, seed: int,
        sa_iters_d: float = 0.995, verbose: bool = True,
        device: str = "cuda") -> dict:
    net, names = (N.small_topology(capacity_scale=scale, device=device)
                  if topology == "small"
                  else N.us_backbone(capacity_scale=scale, device=device))
    jobs = build_jobs(jobs_spec, net.num_nodes, seed)
    batch = J.batch_jobs(jobs, device=device)
    out = {"topology": topology, "scale": scale, "J": len(jobs)}

    for method in (m.strip() for m in methods.split(",") if m.strip()):
        opts = {}
        if method == "sa":
            opts = dict(_SA_DEFAULTS, seed=seed, d=sa_iters_d)
        launches0 = minplus.launch_count()
        plan = solvers.solve(net, batch, method=method, **opts)
        launches = minplus.launch_count() - launches0
        sim = plan.simulate(net, batch)
        out[f"{method}_s"] = plan.meta["solve_s"]
        out[f"{method}_bound"] = plan.bound()
        out[f"{method}_sim"] = sim.makespan
        if verbose:
            print(f"[{method}] bound {plan.bound():.3f}s "
                  f"sim {sim.makespan:.3f}s "
                  f"({plan.meta['solve_s']:.2f}s to solve, "
                  f"{launches} min-plus kernel launches)")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--topology", default="small", choices=["small", "us"])
    ap.add_argument("--jobs", default="vgg19:2,resnet34:6")
    ap.add_argument("--scale", type=float, default=1e-4)
    ap.add_argument("--methods", default="greedy,sa",
                    help="comma list of registered solvers "
                         f"(available: {','.join(solvers.available())})")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    run(args.topology, args.jobs, args.scale, args.methods, args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
