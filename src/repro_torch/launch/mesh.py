"""Production and debug meshes.

Counterpart of ``repro.launch.mesh``.  The production meshes are the
reference's TPU pods, 256 chips in a (data=16, model=16) layout and two
pods (2 x 256) with a leading 'pod' axis; here they are abstract
:class:`~repro_torch.distributed.sharding.Mesh` values (names and sizes),
which the sharding rules and a shape audit read.  A debug mesh is checked
against the devices this process sees and raises, as the reference does,
when there are too few.  No ``torch.distributed`` device mesh is built:
on one card there is nothing to shard over.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1, *,
                    device: str = "cuda") -> Mesh:
    """A (data, model) mesh over the visible devices of ``device``'s type
    (the CUDA cards, or the one CPU; ``"cuda"`` raises without a card);
    raises ``ValueError`` when it needs more than there are."""
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else 1
    need = data * model
    if have < need:
        raise ValueError(f"Number of devices {have} must be >= the product "
                         f"of mesh_shape {(data, model)}")
    return Mesh(("data", "model"), (data, model), device_type=dev.type)
