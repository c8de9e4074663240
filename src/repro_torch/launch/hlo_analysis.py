"""Collective traffic: the roofline's collective term.

Counterpart of ``repro.launch.hlo_analysis``.  :func:`collective_stats`
is the reference's parser of optimized HLO text, kept as a copy (the port
has no HLO of its own; the copy lets the accounting be held to the
reference on the same text).  :func:`comm_stats` applies the same
accounting to the collectives that the production-mesh audit of
:mod:`repro_torch.launch.dryrun` counts while a step runs over
DTensors: each :class:`CommRecord` carries the reference's op name,
the bytes of the collective's result on one device, and the mesh axes
its group spans.  Each op is weighted by the standard ring-algorithm
factor over its group size k:

    all-reduce           2 (k-1)/k      (reduce-scatter + all-gather)
    all-gather           (k-1)/k
    reduce-scatter       (k-1)/k
    all-to-all           (k-1)/k
    collective-permute   1

In HLO text both IotaReplicaGroup (``replica_groups=[G,S]<=...``) and
explicit list (``replica_groups={{0,1},...}``) syntaxes are parsed.
"""
from __future__ import annotations

import dataclasses
import math
import re

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(?P<result>\([^=]*?\)|[a-z0-9]+\[[0-9,]*\]\S*)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")
_SHAPE_RE = re.compile(r"([a-z][a-z0-9]*)\[([0-9,]*)\]")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=")
_LIST_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")

# c10d functional collectives (``torch.ops._c10d_functional``) under the
# reference's HLO op names
C10D_OPS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass(frozen=True)
class CommRecord:
    """One collective: its HLO op name, the bytes of its result on one
    device, and the mesh axes its group spans."""

    op: str
    nbytes: int
    axes: tuple[str, ...]


def _shape_bytes(result: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(result):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _LIST_GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 1


def _factor(op: str, k: int) -> float:
    if op == "collective-permute":   # point-to-point: full payload moves
        return 1.0
    if k <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (k - 1) / k
    return (k - 1) / k


def _accumulate(items) -> dict:
    """The stats dict of ``(op, nbytes, k)`` triples, in order."""
    per_op: dict[str, dict] = {}
    total = 0
    effective = 0.0
    for op, nbytes, k in items:
        d = per_op.setdefault(op, {"count": 0, "bytes": 0,
                                   "effective_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
        d["effective_bytes"] += nbytes * _factor(op, k)
        total += nbytes
        effective += nbytes * _factor(op, k)
    return {"per_op": per_op, "total_bytes": total,
            "effective_bytes": effective}


def collective_stats(hlo_text: str) -> dict:
    """Aggregate collective traffic from optimized HLO text.

    Returns per-op counts/bytes plus ``total_bytes`` (sum of result sizes,
    per device) and ``effective_bytes`` (ring-factor weighted — the number a
    per-link bandwidth divides for the roofline collective term).
    """
    def items():
        for line in hlo_text.splitlines():
            m = _COLL_RE.search(line)
            if m:
                yield (m.group("op"), _shape_bytes(m.group("result")),
                       _group_size(line))

    return _accumulate(items())


def comm_stats(records, mesh) -> dict:
    """:func:`collective_stats`' dict for counted records on
    ``mesh`` (a :class:`repro_torch.distributed.sharding.Mesh`): the group
    size of each is the product of the sizes of the axes it spans."""
    shape = mesh.shape
    return _accumulate((r.op, r.nbytes, math.prod(shape[a] for a in r.axes))
                       for r in records)
