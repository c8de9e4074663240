"""Parameter, batch, cache and optimizer-state sharding rules.

Counterpart of ``repro.distributed.sharding``, over an abstract mesh:
:class:`Mesh` holds axis names and sizes and no devices (the production
meshes of :mod:`repro_torch.launch.mesh` are 256 and 512 chips).  A spec
is a plain tuple, the port's ``PartitionSpec``: one entry per dim of the
leaf, each None (replicated), a mesh axis name, or a tuple of names.

Rules are the reference's name-based templates, fitted right-aligned to
each leaf's shape, so stacked [L, ...] and grouped block params inherit
the rule of their trailing dims; any template axis that does not divide
its dim is dropped, which makes every spec legal.  The port's param tree
has the reference's key paths ("blocks/attn/wq"), so the regexes see the
same strings.  :func:`param_shardings` maps each spec onto
``torch.distributed.tensor`` placements, one per mesh axis; it is pure
data and needs no process group.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

from repro_torch.pytree import items, tree_map, unflatten

FSDP = "data"
TP = "model"

# (regex on the param path, right-aligned spec template for trailing dims)
_RULES: list[tuple[str, tuple]] = [
    # [V, D] vocab-parallel only: sharding D over 'data' would leak a
    # D-sharding into the gather output and replicate the batch dim of
    # every downstream activation
    (r"embed/tok$", ("model", None)),
    (r"embed/head$", ("data", "model")),           # [D, V]
    (r"(wq|wk|wv|w_q|w_q_b)$", ("data", "model")),  # [D, H*hd]
    (r"(wo|w_out)$", ("model", "data")),           # [H*hd, D]
    (r"(w_up|w_gate|w_in)$", ("data", "model")),   # [D, F]
    (r"w_down$", ("model", "data")),               # [F, D]
    (r"router$", ("data", None)),                  # [D, E] replicated experts dim
    (r"moe/w_(gate|up)$", ("model", "data", None)),  # [E, D, F] EP over experts
    (r"moe/w_down$", ("model", None, "data")),     # [E, F, D]
    (r"(w_kv_a|w_q_a)$", ("data", None)),          # [D, r]
    (r"(w_uk|w_uv)$", ("model", None, None)),      # [H, r, hd] heads over TP
    (r"conv_w$", (None, "model")),                 # [dconv, inner+2n]
    (r"w_[ifo]$", ("data", None)),                 # xlstm gate projections
    (r"/r$", (None, None, None)),                  # sLSTM recurrent blocks
]

_ATTN_PARAM_RE = r"(wq|wk|wv|wo|w_q$|w_q_a|w_q_b|w_uk|w_uv|w_kv_a)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh as names and sizes (the reference's ``AbstractMesh``);
    ``device_type`` names the devices a debug mesh was checked against
    (None for the abstract production meshes)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_type: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def _mesh_axis_size(mesh: Mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _fit(template: tuple, shape: tuple, mesh: Mesh) -> tuple:
    """Right-align the template to ``shape``; drop non-dividing axes."""
    spec = [None] * len(shape)
    for i in range(1, min(len(template), len(shape)) + 1):
        axis = template[-i]
        if axis is not None and shape[-i] % _mesh_axis_size(mesh, axis) == 0:
            spec[len(shape) - i] = axis
    return tuple(spec)


def _apply_layout(template: tuple, layout: str, name: str = "") -> tuple:
    """'2d' (baseline): TP over 'model' + FSDP over 'data'.  'dp_only': no
    tensor parallelism, FSDP over ('data', 'model').  'dp_attn': the
    attention projections as 'dp_only', the rest as '2d'."""
    if layout == "2d":
        return template
    if layout == "dp_attn":
        if re.search(_ATTN_PARAM_RE, name):
            return _apply_layout(template, "dp_only", name)
        return template
    if layout == "dp_only":
        return tuple(None if a == "model" else ("data", "model")
                     if a == "data" else a for a in template)
    raise ValueError(layout)


def _map_with_path(fn, tree: Any) -> Any:
    """``fn(path, leaf)`` over a nested-dict tree, paths joined by '/'."""
    return unflatten(tree, [fn(path, leaf) for path, leaf in items(tree)])


def param_specs(shape_tree: Any, mesh: Mesh, *, layout: str = "2d") -> Any:
    """A spec tree matching ``shape_tree`` (any leaves with ``.shape``:
    meta tensors from ``models.model.param_shapes``, or real ones)."""

    def leaf_spec(name, leaf):
        for pat, template in _RULES:
            if re.search(pat, name):
                return _fit(_apply_layout(template, layout, name),
                            tuple(leaf.shape), mesh)
        return ()   # norms, scalars, biases: replicate

    return _map_with_path(leaf_spec, shape_tree)


def placements(spec: tuple, mesh: Mesh) -> tuple:
    """``torch.distributed.tensor`` placements of ``spec``, one per mesh
    axis in the mesh's order: ``Shard(dim)`` where the axis shards ``dim``
    (alone or in a tuple), ``Replicate()`` where it shards nothing."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(shape_tree: Any, mesh: Mesh, *,
                    layout: str = "2d") -> Any:
    return tree_map(lambda s: placements(s, mesh),
                    param_specs(shape_tree, mesh, layout=layout))


def batch_axes(mesh: Mesh, *, layout: str = "2d") -> tuple:
    """Mesh axes the global batch shards over."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if layout == "dp_only":
        dp = dp + ("model",)
    return dp


def _batch_dim_axes(dim: int, dp: tuple, mesh: Mesh):
    """The spec entry of a batch dim: ``dp`` with trailing axes dropped
    until ``dim`` divides (e.g. batch 128 on a 512-chip dp_only layout
    shards over 'data' only); one axis as its name, none as None (as
    ``PartitionSpec`` normalizes them)."""
    while dp and dim % _mesh_axis_size(mesh, dp) != 0:
        dp = dp[:-1]
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_specs(batch_tree: Any, mesh: Mesh, *, layout: str = "2d") -> Any:
    dp = batch_axes(mesh, layout=layout)

    def leaf_spec(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return (_batch_dim_axes(shape[0], dp, mesh),) \
            + (None,) * (len(shape) - 1)

    return _map_with_path(leaf_spec, batch_tree)


def cache_specs(cache_tree: Any, mesh: Mesh, *, layout: str = "2d") -> Any:
    """Decode caches [L, B, T, heads, hd]: batch over dp, heads over TP;
    recurrent states [L, B, H, ...]: heads at dim 2."""
    dp = batch_axes(mesh, layout=layout)

    def leaf_spec(_, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = _batch_dim_axes(shape[1], dp, mesh)
        if len(shape) == 5 and shape[3] % _mesh_axis_size(mesh, TP) == 0:
            spec[3] = TP
        if len(shape) == 4 and shape[2] % _mesh_axis_size(mesh, TP) == 0:
            spec[2] = TP
        return tuple(spec)

    return _map_with_path(leaf_spec, cache_tree)


def opt_state_specs(param_spec_tree: Any, mesh: Mesh) -> Any:
    """AdamW state: m / v mirror the param specs; step is replicated."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}
