"""Build the port's objects from plain numpy arrays and JSON.

What is carried across from the JAX package (or from anywhere else) is
network state, job batches, plans, LM weights and AdamW state.  These constructors
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
from .pytree import tree_map


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


def lm_params_to_numpy(params: Mapping[str, Any]) -> dict:
    """The port's LM params as a tree of float32 numpy arrays (bfloat16
    values are exact in float32), for the reference's ``init_params``
    tree layout."""
    return tree_map(lambda x: x.detach().float().cpu().numpy(), dict(params))


def adamw_state_from_numpy(tree: Mapping[str, Any], *,
                           device: str | torch.device) -> dict:
    """The port's AdamW state from the reference's ``{"m", "v", "step"}``
    as numpy: float32 moment trees and an int32 scalar step."""
    dev = resolve_device(device)

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return {"m": tree_map(f32, dict(tree["m"])),
            "v": tree_map(f32, dict(tree["v"])),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)}


def plan_from_dict(d: Mapping[str, Any], *,
                   device: str | torch.device) -> Plan:
    """A port :class:`Plan` from the JSON form either package writes."""
    return Plan.from_dict(d, device=device)


def plan_to_dict(plan: Plan) -> dict[str, Any]:
    """The JSON form of a port plan, loadable by either package."""
    return plan.to_dict()
