"""Scenario catalog: one entry point for every benchmark, example, and test.

Counterpart of ``repro.scenarios``.  Scenarios are built on ``device``
(default ``"cuda"``); sampling jobs is host-side numpy and draws the same
stream as the reference.

``make_scenario(name, seed)`` composes a topology family
(:mod:`.topologies`) with a traffic mix (:mod:`.traffic`) into a
:class:`Scenario`: the network, where traffic enters/leaves, what arrives,
and calibration helpers (``nominal_rate`` turns an offered-load factor into
an arrival rate).  Names are ``"family"`` or ``"family:traffic"``:

    sc = make_scenario("edge-cloud", seed=0)          # family default mix
    sc = make_scenario("us-backbone:paper", seed=1)   # explicit mix
    sc = make_scenario("star", seed=0, device="cpu")  # on the host

Catalog (see ``available_scenarios()``):

  family             default traffic   shape
  paper-small        paper             the paper's 5-node Fig. 2
  us-backbone        paper             24-node USNET backbone (Fig. 4)
  edge-cloud         lm                edge sites -> aggregation -> cloud
  random-geometric   synthetic         seeded geometric mesh
  star               synthetic         cellular hub-and-spoke
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

import torch

from repro_torch.core import jobs as J
from repro_torch.core.network import ComputeNetwork
from repro_torch.core.state import QueueState, Topology
from .topologies import FAMILIES
from .traffic import MIXES, TrafficEntry, TrafficMix, make_traffic

_DEFAULT_TRAFFIC = {
    "paper-small": "paper",
    "us-backbone": "paper",
    "edge-cloud": "lm",
    "random-geometric": "synthetic",
    "star": "synthetic",
}


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named (topology, traffic) pairing with sampling helpers."""

    name: str
    seed: int
    topology: Topology
    node_names: tuple[str, ...]
    ingress: tuple[int, ...]
    egress: tuple[int, ...]
    traffic: TrafficMix

    @property
    def num_nodes(self) -> int:
        return self.topology.num_nodes

    @property
    def max_layers(self) -> int:
        """Common padding width for this scenario's batches."""
        return self.traffic.max_layers

    def network(self, state: QueueState | None = None) -> ComputeNetwork:
        return self.topology.view(state)

    def sample_src_dst(self, rng: np.random.Generator) -> tuple[int, int]:
        src = int(rng.choice(self.ingress))
        egress = [e for e in self.egress if e != src] or list(self.egress)
        return src, int(rng.choice(egress))

    def sample_jobs(self, rng: np.random.Generator,
                    n: int = 1) -> list[J.InferenceJob]:
        # Names end in a monotonic per-instance sequence number, not the
        # batch index: completion tracking keys on job names (the
        # exact-drain ledger rejects repeats), and the 30-bit nonce alone
        # has ~0.4% birthday-collision odds by 3k requests.  The nonce draw
        # is kept as-is so the rng stream — and every recorded trajectory —
        # stays bit-identical.
        seq = getattr(self, "_name_seq", 0)
        out = []
        for i in range(n):
            src, dst = self.sample_src_dst(rng)
            out.append(self.traffic.sample(
                rng, f"{self.name}-{int(rng.integers(1 << 30))}-{seq + i}",
                src, dst))
        # repro-lint: disable=RL004 -- host-only name counter, never on a device
        object.__setattr__(self, "_name_seq", seq + n)
        return out

    def job_stream(self, rng: np.random.Generator, times,
                   batch_size: int = 1):
        """Lazy ``(t, jobs)`` arrival epochs for the streaming pipeline.

        Jobs are sampled *at pull time*, in arrival order — the pipeline
        consumes epochs strictly time-ordered, so the rng stream (and
        hence every job and job name) is identical to the serial
        ``run_online`` loop over the same ``times``.
        """
        for t in times:
            yield float(t), self.sample_jobs(rng, batch_size)

    @functools.cached_property
    def mean_service_s(self) -> float:
        """Mean empty-network optimal completion time of a request (s).

        The true per-request work along its critical resource chain —
        compute *and* transfers — so offered-load calibration respects
        whichever resource actually bottlenecks the scenario.  The routes
        run on the scenario's device; the costs come to the host for the
        float64 mean.
        """
        from repro_torch.core import routing
        rng = np.random.default_rng(self.seed + 0x5EED)
        # 32 samples: enough that a lopsided mix (rare-but-heavy entries)
        # doesn't under-estimate the mean and mis-calibrate offered load.
        batch = J.batch_jobs(self.sample_jobs(rng, 32),
                             device=self.topology.device)
        costs = routing.route_batch(self.topology.view(), batch).cost
        costs = costs.cpu().numpy().astype(np.float64)
        return float(costs.mean())

    def nominal_rate(self, load: float) -> float:
        """Arrival rate (req/s) offering ``load`` x one-request-at-a-time
        service capacity: ``load / mean_service_s``.

        This is conservative (the network serves disjoint routes in
        parallel), so ``load < 1`` is comfortably sub-capacity — the regime
        the draining scheduler must hold bounded; the online benchmark
        sweeps this factor.
        """
        return load / max(self.mean_service_s, 1e-30)


def available_scenarios() -> tuple[str, ...]:
    return tuple(sorted(FAMILIES))


def make_scenario(name: str, seed: int = 0, *, traffic: str | None = None,
                  device: str | torch.device = "cuda",
                  **family_opts) -> Scenario:
    """Build a scenario by name (``"family"`` or ``"family:traffic"``) on
    ``device``."""
    family, _, mix_name = name.partition(":")
    if traffic is not None:
        if mix_name:
            raise ValueError("pass traffic either in the name or as traffic=")
        mix_name = traffic
    try:
        gen = FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown scenario family {family!r}; available: "
            f"{', '.join(available_scenarios())}") from None
    mix = make_traffic(mix_name or _DEFAULT_TRAFFIC[family])
    net, names, ingress, egress = gen(seed, device=device, **family_opts)
    return Scenario(
        name=f"{family}:{mix.name}", seed=seed, topology=net.topology,
        node_names=tuple(names), ingress=tuple(ingress),
        egress=tuple(egress), traffic=mix)


__all__ = [
    "Scenario", "TrafficEntry", "TrafficMix", "MIXES", "FAMILIES",
    "available_scenarios", "make_scenario", "make_traffic",
]
