"""The port's production-mesh dry-run (``repro_torch.launch.dryrun``) and
collective accounting (``repro_torch.launch.hlo_analysis``) against the
reference's: each cell's ``status``/``reason``, ``params``, ``tokens`` and
``flash_hidden`` over all 80 cells; ``collective_stats`` on the reference
test's HLO text; ``comm_stats`` on HLO lines rendered from counted
records; and the collective audit over fake process groups at smoke size,
with one known answer (dp_only: one all-reduce per gradient leaf)."""
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import shape_applicable as j_applicable  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun as D, hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.pytree import leaves  # noqa: E402

SMALL = Mesh(("data", "model"), (2, 2))


@pytest.fixture(scope="module")
def jdry():
    """The reference's dryrun module.  Its first statement sets XLA_FLAGS
    to 512 host devices; with the backend already up that has no effect
    here, and the variable is put back so that nothing later in this
    process (or started from it) sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_import_sets_no_process_state():
    src = inspect.getsource(D) + inspect.getsource(H)
    assert "environ" not in src and "XLA_FLAGS" not in src.replace(
        "``XLA_FLAGS``", "")


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_cell_records_match_reference(arch, jdry):
    """Part (a) of every cell of ``arch`` (4 shapes x 2 meshes) with the
    flash knob on, so ``flash_hidden`` is written where the reference
    writes it."""
    opts = {"attn_impl": "flash"}
    jcfg = dataclasses.replace(jreg.config(arch), scan_layers=False,
                               attn_impl="flash")
    jparams = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    n_params = sum(int(x.size) for x in jax.tree.leaves(jparams))
    for shape, spec in JSHAPES.items():
        ok, reason = j_applicable(jcfg, spec)
        for multi in (False, True):
            rec = D.run_cell(arch, shape, multi, opts=opts)
            assert rec["mesh"] == ("pod2x16x16" if multi else "pod16x16")
            if not ok:
                assert rec == {"arch": arch, "shape": shape,
                               "mesh": rec["mesh"], "status": "skip",
                               "reason": reason}
                continue
            assert rec["status"] == "ok"
            assert rec["params"] == n_params
            assert rec["kind"] == spec.kind
            assert rec["tokens"] == spec.global_batch * (
                spec.seq_len if spec.kind != "decode" else 1)
            assert (rec["seq_len"], rec["global_batch"]) == \
                (spec.seq_len, spec.global_batch)
            assert rec["flops_source"] == ("analytic" if jcfg.family in (
                "ssm", "hybrid") and spec.kind != "decode" else "hlo")
            if spec.kind == "decode":
                assert "flash_hidden" not in rec
            else:
                assert rec["flash_hidden"] == jdry._flash_hidden(
                    jcfg, spec, 512 if multi else 256)
            assert rec["memory"]["argument_bytes"] > 0
            assert rec["collectives"] is None
    if arch == "olmo_1b":  # without the knob, XLA attention: no term
        assert "flash_hidden" not in D.run_cell(arch, "train_4k", False)


HLO = """
  %ag = f32[256,256]{1,0} all-gather(%x), replica_groups=[2,4]<=[4,2]T(1,0), dimensions={0}
  %fused = f32[256,256]{1,0} fusion(%ag), kind=kLoop
  %ar = bf16[128]{0} all-reduce(%y), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[32,16]{1,0} reduce-scatter(%z), replica_groups=[8,2]<=[16], dimensions={0}
  %cp = f32[64]{0} collective-permute(%w), source_target_pairs={{0,1}}
  %ars = (f32[8]{0}, f32[8]{0}) all-reduce-start(%a, %b), replica_groups=[1,8]<=[8]
"""


def test_collective_stats_matches_reference():
    """The text of ``test_sharding_and_specs.py::test_hlo_collective_parsing``."""
    assert H.collective_stats(HLO) == jhlo.collective_stats(HLO)
    assert H.collective_stats(HLO)["per_op"]["all-reduce"]["count"] == 2


def _render(records, mesh) -> str:
    """One HLO line per record: its bytes as a u8 result, its group as an
    iota replica group of the axes' size."""
    lines = []
    for i, r in enumerate(records):
        k = 1
        for a in r.axes:
            k *= mesh.shape[a]
        lines.append(f"  %c{i} = u8[{r.nbytes}]{{0}} {r.op}(%x{i}), "
                     f"replica_groups=[{mesh.size // k},{k}]<=[{mesh.size}]")
    return "\n".join(lines)


@pytest.fixture(scope="module")
def smoke_records():
    """The audit of olmo-1b's smoke config at prefill and decode over a
    (data=2, model=2) fake mesh."""
    cfg = treg.smoke_config("olmo_1b")
    out = {}
    for kind in ("prefill", "decode"):
        spec = ShapeSpec("smoke", kind, 32, 4)
        args = D.cell_args("olmo_1b", cfg, spec, SMALL)
        out[kind] = D.audit_collectives(cfg, spec, SMALL, args)
    return out


def test_comm_stats_matches_reference_on_rendered_records(smoke_records):
    mesh = make_production_mesh(multi_pod=True)
    made = [H.CommRecord("all-reduce", 4096, ("pod",)),
            H.CommRecord("all-gather", 1 << 20, ("data", "model")),
            H.CommRecord("reduce-scatter", 96, ("pod", "data", "model")),
            H.CommRecord("all-to-all", 512, ("model",)),
            H.CommRecord("collective-permute", 256, ("data",)),
            H.CommRecord("all-reduce", 8, ())]
    assert H.comm_stats(made, mesh) == jhlo.collective_stats(
        _render(made, mesh))
    for records in smoke_records.values():
        assert records
        assert H.comm_stats(records, SMALL) == jhlo.collective_stats(
            _render(records, SMALL))


def test_audit_at_smoke_size_counts_collectives(smoke_records):
    """Every record is one of the reference's ops over axes of the mesh,
    and each step gathers what the tensor-parallel layout split."""
    for records in smoke_records.values():
        assert {r.op for r in records} <= set(H.C10D_OPS.values())
        assert all(set(r.axes) <= set(SMALL.axis_names) and r.nbytes > 0
                   for r in records)
        assert any(r.op == "all-gather" for r in records)


def test_dp_only_train_step_all_reduces_each_gradient_leaf_once():
    """Known answer.  Under dp_only every smoke weight of olmo-1b is
    replicated on the 256-chip mesh (no FSDP dim divides by 256), so the
    step all-reduces each gradient leaf once, into its replicated param
    (the embedding's gradient arrives split over 'model', is gathered
    there, and is reduced over 'data'): the all-reduce bytes are the
    gradient leaves' bytes, plus the 4 of the one float32 scalar the
    loss's mean divides by (the global count of labelled tokens)."""
    mesh = make_production_mesh()
    cfg = dataclasses.replace(treg.smoke_config("olmo_1b"),
                              dp_axes=("pod", "data", "model"))
    spec = ShapeSpec("smoke", "train", 16, 256)
    args = D.cell_args("olmo_1b", cfg, spec, mesh, "dp_only")
    assert all(s == (None,) * len(s) for s in leaves(args.specs["params"]))
    records = D.audit_collectives(cfg, spec, mesh, args)
    stats = H.comm_stats(records, mesh)
    grads = [p.numel() * p.element_size()
             for p in leaves(args.trees["params"])]
    reduced = sorted(r.nbytes for r in records if r.op == "all-reduce")
    assert reduced == sorted(grads + [4])
    assert stats["per_op"]["all-reduce"]["bytes"] == sum(grads) + 4
    assert stats["per_op"]["all-reduce"]["count"] == len(grads) + 1


def test_cli_records_a_refused_cell_as_a_failure(tmp_path, capsys):
    """smollm-135m's 9 heads do not divide over 16 'model' chips, and
    ``DTensor`` refuses the [B, S, H, hd] view: the cell is a failure
    with ``DTensor``'s error, and the exit status says so."""
    rc = D.main(["--arch", "smollm_135m", "--shape", "prefill_32k",
                 "--mesh", "single", "--collectives", "--out",
                 str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "smollm_135m.prefill_32k.single.json")
                     .read_text())
    assert rec["status"] == "fail"
    assert "unevenly sharded" in rec["error"]
    assert "1 failures" in capsys.readouterr().out
