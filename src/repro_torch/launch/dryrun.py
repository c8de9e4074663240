"""Production-mesh dry-run: an audit of every (arch x shape x mesh) cell
that allocates nothing.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell over 512 placeholder XLA devices and reads the compiler's
memory and cost analyses and the collectives in its HLO.  The port has no
compiler to ask, so each cell is audited in two parts, and nothing is set
process-wide when this module is imported:

(a) the record, with no process group: params, optimizer state, batch and
    (at decode) cache as meta tensors (``models.model.param_shapes``, each
    config's ``input_specs``, ``AdamW.init``, ``init_cache(device="meta")``),
    placed by :mod:`repro_torch.distributed.sharding` over
    ``launch.mesh.make_production_mesh``.  ``memory.argument_bytes`` is
    one device's share of them: each leaf's local shard, where a dim its
    spec's axes do not divide stays whole (the specs already drop such
    axes).  ``flash_hidden`` is the reference's analytic term for the
    flash kernels.  The compiler's own numbers (``temp_bytes``,
    ``code_bytes``, ``compile_s``, the cost analysis) have no counterpart
    and stay null.
(b) the collectives (``--collectives``): the step itself
    (``make_train_step`` / ``make_prefill_step`` / ``make_serve_step``)
    runs once on DTensors over a ``"fake"`` process group with one
    rank a chip, each holding its local shard on the ``meta`` device (no
    data; ``FakeTensorMode`` cannot be used: ``DTensor``'s own bookkeeping
    for strided shards reads a tensor it makes, which fake mode refuses),
    with ``attn_impl="xla"``: the flash kernels take no ``DTensor``, and
    ``flash_hidden`` adds them back as the reference adds back its
    ``pallas_call`` sites.  Each collective that ``DTensor`` runs is
    counted (a ``CommDebugMode``) and :func:`hlo_analysis.comm_stats`
    weighs them.  A cell that ``DTensor`` cannot carry fails with its
    error.  The model code meets DTensors in four places, none of which a
    plain tensor takes: ``models.common.maybe_shard`` (the reference's
    activation anchors), attention on each rank's own rows and heads
    (``common._sdpa_local``), the embedding's gather
    (``common.embed``) and the train step's gradient sync
    (``launch.steps._sync``).  The layout follows ``DTensor``'s own rules,
    so the counts differ between torch versions and from the reference's
    HLO; the accounting is the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
      --shape train_4k --mesh single --collectives
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.distributed import sharding as sh
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (default_optimizer, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models import model as M
from repro_torch.pytree import leaves, tree_map


def _flash_hidden(cfg, spec, chips: int) -> dict:
    """Analytic flops/bytes of the flash-attention kernels (the
    reference's correction for what its cost analysis cannot see).  Causal
    blocking halves the S^2 work; the HBM traffic is the O(S*d) operand
    movement, not the O(S^2) scores."""
    b, s = spec.global_batch, spec.seq_len
    h = cfg.num_heads
    if cfg.use_mla:
        dq = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
    else:
        dq = dv = cfg.head_dim
    fwd_flops = 0.5 * 2.0 * b * h * s * s * (dq + dv) * cfg.num_layers
    mult = 4.0 if spec.kind == "train" else 1.0     # fwd + 3x-fwd backward
    per_layer_io = b * s * h * (2 * dq + 2 * dv) * 2  # Q,K,V,O bf16
    io_mult = 3.0 if spec.kind == "train" else 1.0
    return {
        "flops_per_device": fwd_flops * mult / chips,
        "bytes_per_device": per_layer_io * io_mult * cfg.num_layers / chips,
    }


def local_shape(shape, spec: tuple, mesh: sh.Mesh) -> tuple:
    """One device's shard of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for i, axis in enumerate(spec):
        k = sh._mesh_axis_size(mesh, axis)
        if out[i] % k == 0:
            out[i] //= k
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CellArgs:
    """A cell's step arguments as meta-tensor trees, each with its spec
    tree: params, batch, and the optimizer state (train) or the cache
    (decode)."""

    trees: dict     # name -> meta-tensor tree
    specs: dict     # name -> spec tree of the same structure

    def argument_bytes(self, mesh: sh.Mesh) -> int:
        """One device's bytes of every argument."""
        return sum(math.prod(local_shape(x.shape, s, mesh)) * x.element_size()
                   for name in self.trees
                   for x, s in zip(leaves(self.trees[name]),
                                   leaves(self.specs[name])))


@functools.lru_cache(maxsize=1)
def _param_shapes(cfg) -> dict:
    # every shape and mesh of one arch shares the tree (deepseek-v2's takes
    # seconds to build)
    return M.param_shapes(cfg)


def cell_args(arch: str, cfg, spec, mesh: sh.Mesh,
              layout: str = "2d") -> CellArgs:
    """The arguments of ``arch``'s step at ``spec`` under ``cfg``."""
    params = _param_shapes(cfg)
    pspecs = sh.param_specs(params, mesh, layout=layout)
    batch = registry.get(arch).input_specs(spec, cfg)
    trees = {"params": params, "batch": batch}
    specs = {"params": pspecs,
             "batch": sh.batch_specs(batch, mesh, layout=layout)}
    if spec.kind == "train":
        trees["opt_state"] = default_optimizer(cfg).init(params)
        specs["opt_state"] = sh.opt_state_specs(pspecs, mesh)
    elif spec.kind == "decode":
        cache = M.init_cache(cfg, spec.global_batch, spec.seq_len,
                             device="meta")
        trees["cache"] = cache
        specs["cache"] = sh.cache_specs(cache, mesh, layout=layout)
    return CellArgs(trees, specs)


def cell_config(arch: str, opts: dict):
    """The arch's config with the reference's dry-run knobs applied."""
    knobs = {k: opts[k] for k in
             ("attn_chunk_q", "remat_policy", "moe_ep_shard", "attn_impl",
              "gqa_grouped", "moe_local_dispatch")
             if k in opts}
    if opts.get("layout", "2d") == "dp_only":
        knobs["dp_axes"] = ("pod", "data", "model")
    return dataclasses.replace(
        registry.config(arch), scan_layers=bool(opts.get("scan_layers", False)),
        **knobs)


class CommAudit:
    """A fake process group with one rank a chip of ``mesh``, its device
    mesh, and the collectives counted while it is entered.

    Every set of two or more mesh axes gets a flattened mesh, so that
    ``DTensor`` runs a collective over several axes as one collective
    over their product, as XLA's replica groups do.  Leaving restores the
    process's state: no process group.
    """

    def __init__(self, mesh: sh.Mesh):
        self.mesh = mesh
        self.records: list[hlo_analysis.CommRecord] = []

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.mesh.size)
        try:
            self.device_mesh = init_device_mesh(
                "cpu", self.mesh.axis_sizes,
                mesh_dim_names=self.mesh.axis_names)
            axes_of = {self.device_mesh.get_group(i).group_name: (name,)
                       for i, name in enumerate(self.mesh.axis_names)}
            names = self.mesh.axis_names
            for group in (g for r in range(2, len(names) + 1)
                          for g in itertools.combinations(names, r)):
                flat = self.device_mesh[group]._flatten()
                axes_of[flat.get_group().group_name] = group
        except BaseException:
            dist.destroy_process_group()
            raise
        self.axes_of = axes_of
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()

    def place(self, tree, specs):
        """DTensors of ``tree``'s shapes and dtypes, each with its
        local shard under its spec on the ``meta`` device."""
        from torch.distributed.tensor import DTensor

        def one(x, spec):
            local = torch.empty(local_shape(x.shape, spec, self.mesh),
                                dtype=x.dtype, device="meta")
            return DTensor.from_local(
                local, self.device_mesh, sh.placements(spec, self.mesh),
                run_check=False, shape=x.shape,
                stride=torch.empty(x.shape, device="meta").stride())

        return tree_map(one, tree, specs)

    def counting(self):
        """A ``CommDebugMode`` that also appends a :class:`CommRecord` to
        ``records`` for each collective."""
        from torch.distributed.tensor.debug import CommDebugMode
        audit = self

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counted = sum(self.comm_counts.values())
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if sum(self.comm_counts.values()) > counted:
                    audit.record(func._overloadpacket.__name__, out, args)
                return out

        return Mode()

    def record(self, name: str, out, args) -> None:
        if name not in hlo_analysis.C10D_OPS:
            raise NotImplementedError(f"uncounted collective {name}")
        outs = out if isinstance(out, (list, tuple)) else [out]
        self.records.append(hlo_analysis.CommRecord(
            hlo_analysis.C10D_OPS[name],
            sum(o.numel() * o.element_size() for o in outs),
            self.axes_of[args[-1]]))


def audit_collectives(cfg, spec, mesh: sh.Mesh, args: CellArgs) -> list:
    """Run the cell's step once over DTensors on a fake process
    group of ``mesh``; the records of its collectives."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(cfg, attn_impl="xla")
    meta = torch.device("meta")
    with CommAudit(mesh) as audit:
        placed = {name: audit.place(args.trees[name], args.specs[name])
                  for name in args.trees}
        batch = placed["batch"]
        if spec.kind == "train":
            step = make_train_step(cfg, default_optimizer(cfg), device=meta)
            call = functools.partial(step, placed["params"],
                                     placed["opt_state"], batch)
        elif spec.kind == "prefill":
            step = make_prefill_step(cfg, device=meta)
            call = functools.partial(step, placed["params"], batch)
        else:  # the new token's position, as a host int (serve_step's)
            step = make_serve_step(cfg, device=meta)
            batch = dict(batch, pos=spec.seq_len - 1)
            call = functools.partial(step, placed["params"], placed["cache"],
                                     batch)
        with implicit_replication(), audit.counting():
            call()
    return audit.records


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             opts: dict | None = None, collectives: bool = False) -> dict:
    """Audit one cell; returns the dry-run record (the reference's keys)."""
    opts = opts or {}
    cfg = registry.config(arch)
    spec = SHAPES[shape]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok"}
    ok, reason = shape_applicable(cfg, spec)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    layout = opts.get("layout", "2d")
    cfg = cell_config(arch, opts)
    time_scanned = cfg.family in ("ssm", "hybrid") and spec.kind != "decode"
    rec["flops_source"] = "analytic" if time_scanned else "hlo"
    rec["opts"] = opts
    if cfg.attn_impl == "flash" and spec.kind != "decode":
        rec["flash_hidden"] = _flash_hidden(cfg, spec, mesh.size)
    t0 = time.time()
    args = cell_args(arch, cfg, spec, mesh, layout)
    t_specs = time.time() - t0
    coll, t_audit = None, None
    if collectives:
        t0 = time.time()
        coll = hlo_analysis.comm_stats(
            audit_collectives(cfg, spec, mesh, args), mesh)
        t_audit = time.time() - t0
    rec.update(
        # XLA's lowering and compile times, cost analysis and the memory
        # fields other than the arguments have no counterpart here
        lower_s=None, compile_s=None, specs_s=t_specs, audit_s=t_audit,
        flops_per_device=None, bytes_accessed_per_device=None,
        memory={"argument_bytes": args.argument_bytes(mesh),
                "output_bytes": None, "temp_bytes": None,
                "alias_bytes": None, "code_bytes": None},
        collectives=coll,
        params=M.param_count(args.trees["params"]),
        kind=spec.kind,
        tokens=spec.global_batch * (spec.seq_len if spec.kind != "decode"
                                    else 1),
        seq_len=spec.seq_len, global_batch=spec.global_batch,
    )
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--opts", default="{}",
                    help='JSON perf knobs, e.g. \'{"attn_chunk_q": 512, '
                         '"layout": "dp_only"}\'')
    ap.add_argument("--collectives", action="store_true",
                    help="also run each cell's step over a fake process "
                         "group and count its collectives")
    args = ap.parse_args(argv)
    opts = json.loads(args.opts)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}.{shape}.{'multi' if multi else 'single'}"
                path = outdir / f"{tag}.json"
                if path.exists():
                    print(f"[dryrun] {tag}: cached")
                    continue
                try:
                    rec = run_cell(arch, shape, multi, opts=opts,
                                   collectives=args.collectives)
                except Exception as e:  # a cell the port cannot carry
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if multi else "single",
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    n_fail += 1
                path.write_text(json.dumps(rec, indent=1))
                mem = (rec.get("memory") or {}).get("argument_bytes")
                coll = rec.get("collectives") or {}
                print(f"[dryrun] {tag}: {rec['status']} "
                      f"(args/dev {mem if mem is not None else '-'} B, "
                      f"collective bytes/dev "
                      f"{coll.get('total_bytes', '-')})", flush=True)
    print(f"[dryrun] done, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
