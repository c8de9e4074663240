"""Build the port's objects from plain numpy arrays and JSON.

What is carried across from the JAX package (or from anywhere else) is
network state, job batches, plans and LM weights.  These constructors
take exactly the arrays the reference's objects hold (``np.asarray`` of
each field), so a test can hand both packages the same inputs.  Plans
cross over through the shared JSON form of
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


def lm_params_from_numpy(tree: Mapping[str, Any], cfg, *,
                         device: str | torch.device) -> dict:
    """The port's LM params from the reference's param pytree as numpy.

    ``tree`` is ``{"blocks": {"attn": {wq, wk, wv, wo}, "ln1", "ln2",
    "mlp": {w_up, w_gate, w_down}} stacked [L, ...], "embed": {"tok"[,
    "head"]}, "ln_f"}`` with numpy leaves.  bfloat16 weights cross as
    float32 arrays that hold bfloat16 values (numpy has no bfloat16
    without ``ml_dtypes``); every leaf is cast to ``cfg.dtype``, which is
    lossless for those.
    """
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, Mapping):
            return {k: convert(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=cfg.dtype)

    return convert(tree)


def plan_from_dict(d: Mapping[str, Any], *,
                   device: str | torch.device) -> Plan:
    """A port :class:`Plan` from the JSON form either package writes."""
    return Plan.from_dict(d, device=device)


def plan_to_dict(plan: Plan) -> dict[str, Any]:
    """The JSON form of a port plan, loadable by either package."""
    return plan.to_dict()
