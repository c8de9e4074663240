"""Build the port's objects from plain numpy arrays and JSON.

This system has no weights; what is carried across from the JAX package
(or from anywhere else) is network state, job batches and plans.  These
constructors take exactly the arrays the reference's objects hold
(``np.asarray`` of each field), so a test can hand both packages the same
inputs.  Plans cross over through the shared JSON form of
``Plan.to_dict``/``Plan.from_dict``.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.jobs import JobBatch
from .core.network import ComputeNetwork
from .core.plan import Plan
from .device import resolve_device


def network_from_numpy(mu_node, mu_link, q_node, q_link, clock=0.0, *,
                       device: str | torch.device) -> ComputeNetwork:
    """A :class:`ComputeNetwork` from float32 arrays (converted if not)."""
    dev = resolve_device(device)
    f32 = [torch.from_numpy(np.array(x, np.float32)).to(dev)
           for x in (mu_node, mu_link, q_node, q_link)]
    return ComputeNetwork.of(*f32, clock=float(np.float32(clock)))


def batch_from_numpy(src, dst, comp, data, num_layers, *,
                     device: str | torch.device) -> JobBatch:
    """A :class:`JobBatch` from its padded arrays (int32 ids, float32 costs)."""
    dev = resolve_device(device)
    return JobBatch(*(torch.from_numpy(np.array(x, dt)).to(dev)
                      for x, dt in ((src, np.int32), (dst, np.int32),
                                    (comp, np.float32), (data, np.float32),
                                    (num_layers, np.int32))))


def plan_from_dict(d: Mapping[str, Any], *,
                   device: str | torch.device) -> Plan:
    """A port :class:`Plan` from the JSON form either package writes."""
    return Plan.from_dict(d, device=device)


def plan_to_dict(plan: Plan) -> dict[str, Any]:
    """The JSON form of a port plan, loadable by either package."""
    return plan.to_dict()
