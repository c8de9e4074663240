"""CPU tests of the benchmark: the manifest against its contract, every
cell's files, the import check, the frozen arithmetic at the cells'
shapes, and each driver run end to end at a small size on the CPU, with
the program sound (``correct``), with faults planted underneath (not
``correct``) and with its control in the program's place (not
``correct``)."""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from bench import harness, traffic, yardstick  # noqa: E402
from bench.reference import router as ref_router  # noqa: E402

ROOT = harness.ROOT
MANIFEST = harness.load_json(harness.MANIFEST)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
CPU = torch.device("cpu")


# -- the manifest -------------------------------------------------------------

def test_manifest_keys_names_and_units():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert m["paths"] == ["bench"] and m["command"][1] == "bench/run.py"
    metric_keys = {"name", "unit", "better", "source", "bound", "layer",
                   "moves", "workloads"}
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert all(harness.NAME_RE.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for e in m["end_to_end"]:
        assert set(e) <= metric_keys - {"layer", "moves"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) <= metric_keys - {"bound"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in p["layer"] and len(p["layer"]) <= 200
    for x in m["end_to_end"] + m["per_layer"]:
        assert harness.UNIT_RE.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
        names.append(x["name"])
    assert all(harness.NAME_RE.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in m[group]}) == len(m[group])
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("kernels/place", True),
                                     ("tokens per s", False), ("", False),
                                     ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(harness.UNIT_RE.match(unit)) == ok


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.resolve(cell)
    for fn in ("setup", "measure", "check", "gap"):
        assert callable(getattr(c.driver, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        reader = harness.load_module(harness.BENCH / "metrics" /
                                     f"{m['name']}.py", f"t_{m['name']}")
        assert callable(reader.read)
    assert c.limits


# the drivers that build the program from a configuration
MODEL_DRIVERS = ("prefill", "train")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    """Besides its manifest entries, a cell brings its limits and its tiny
    sizes, which lay over keys its configuration and mix have; a cell of a
    model driver, its architecture's module, whose reference imports
    nothing of the program."""
    from bench import models
    c = harness.resolve(cell)
    assert (harness.BENCH / "limits" / f"{cell}.json").is_file()
    t = tiny_file(cell)
    assert {"config", "mix", "ticks"} <= set(t)
    assert set(t["config"]) <= set(c.config) and set(t["mix"]) <= set(c.mix)
    if c.mix["driver"] in MODEL_DRIVERS:
        kind = c.config["model_type"]
        assert (harness.BENCH / "arch" / f"{kind}.py").is_file()
        arch = models.arch(c.config)
        assert callable(arch.program_config) and callable(arch.is_norm_leaf)
        assert arch.Model.__module__.startswith("bench.reference.")


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    base = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_stand_in", object())
    assert set(harness.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "repro.core.stand_in", object())
    monkeypatch.setitem(sys.modules, "jaxlib.stand_in", object())
    assert set(harness.forbidden_modules()) == base | {"repro", "jaxlib"}


def test_the_cli_gives_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the run would measure")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          CELLS[0], "--seed", str(2**33 + 1), "--seconds",
                          "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# -- the frozen arithmetic at the cells' shapes ------------------------------

def test_flash_bounds_at_the_cells_shapes():
    assert round(yardstick.flash_bound(32, 2624, 96, 96) * 1e6, 2) == 42.79
    dq = yardstick.flash_bwd_bound(64, 2048, 128, 128, "flash_bwd_dq")
    dkv = yardstick.flash_bwd_bound(64, 2048, 128, 128, "flash_bwd_dkv")
    assert (round(dq * 1e6, 2), round(dkv * 1e6, 2)) == (104.28, 139.04)


def test_model_flops_from_the_configs():
    phi = harness.load_json(harness.BENCH / "configs/phi-3-vision-4.2b.json")
    f = yardstick.forward_flops(phi, 32, 1, 2624, 2048)
    assert math.isclose(f, 2.0775809581056e13, rel_tol=1e-9)
    olmoe = harness.load_json(harness.BENCH / "configs/olmoe-1b-7b-4l.json")
    step = 3 * yardstick.forward_flops(olmoe, 4, 4, 2048, 2048)
    assert math.isclose(step, 1.9108712153088e13, rel_tol=1e-9)


def test_cost_profile_of_the_routed_job():
    cfg = harness.load_json(harness.BENCH / "configs/olmoe-1b-7b.json")
    comp, data = ref_router.cost_profile(cfg, seq_len=2048, batch=1)
    assert comp.shape == (18,) and data.shape == (19,)
    assert data[0] == data[-1] == 8192 and data[1] == 2048 * 2048 * 2


def test_weights_are_drawn_at_the_files_scales():
    from bench import models
    cfg = harness.resolve("olmoe-train").config
    assert models.leaf_std("blocks/attn/wq", (4, 2048, 2048), cfg) == \
        pytest.approx(2048 ** -0.5)
    assert models.leaf_std("embed/tok", (50304, 2048), cfg) == 0.02
    assert models.leaf_std("blocks/ln1/w", (4, 2048), cfg) is None
    fixed = {**cfg, "init": {**cfg["init"], "matrix_std": 0.5}}
    assert models.leaf_std("blocks/attn/wq", (4, 2048, 2048), fixed) == 0.5
    with pytest.raises(ValueError):
        models.leaf_std("blocks/attn/wq", (4, 2048, 2048),
                        {**cfg, "init": {**cfg["init"], "matrix_std": "x"}})


@pytest.mark.parametrize("cell", ["phi3v-prefill", "olmoe-train"])
def test_a_departure_the_port_cannot_run_is_refused(cell):
    """The program runs the configuration as its file states it (published
    values, save its departures), or refuses it."""
    from bench import models
    cfg = harness.resolve(cell).config
    prog = models.program_config(cfg)
    assert prog.tie_embeddings == cfg["tie_word_embeddings"]
    published = {k: v for k, v in cfg.items() if k != "departures"}
    with pytest.raises(ValueError):
        models.program_config(published)


def test_an_unknown_topology_is_refused():
    from bench.drivers import route
    c = tiny("olmoe-route")
    run = harness.Run(dataclasses.replace(
        c, mix={**c.mix, "topology": "mesh-48"}), seed=1, seconds=1,
        trace=False, device=CPU)
    with pytest.raises(ValueError, match="unknown topology"):
        route.setup(run)


def test_traffic_gives_every_seed_the_same_work():
    a, b = traffic.poisson_gaps(500, 2**32 + 3), traffic.poisson_gaps(500, 5)
    assert sorted(a) == sorted(b) and not (a == b).all()
    assert math.isclose(a.mean(), 1.0)
    pairs = traffic.balanced(list(range(16)), 64, 2**40)
    assert sorted(pairs) == sorted(list(range(16)) * 4)


# -- the cells, end to end at a small size on the CPU ---------------------------

def tiny_file(cell: str) -> dict:
    """``bench/tiny/<cell>.json``: the keys laid over the cell's
    configuration (a group merged into the configuration's group), over its
    mix, and the ticks of its window (null: the wall's clock)."""
    return harness.load_json(harness.BENCH / "tiny" / f"{cell}.json")


def tiny(cell: str) -> harness.Cell:
    c = harness.resolve(cell)
    t = tiny_file(cell)
    config = dict(c.config)
    for key, value in t["config"].items():
        if isinstance(value, dict) and isinstance(config.get(key), dict):
            value = {**config[key], **value}
        config[key] = value
    return dataclasses.replace(c, config=config, mix={**c.mix, **t["mix"]})


# a model cell's window runs a fixed number of loop iterations: its driver
# reads a clock that advances a fixed tick a reading (the tiny file's
# ``ticks`` to the window), so the work is the same however loaded the host
class TickClock:
    def __init__(self, tick: float):
        self.now, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


def drive(cell: harness.Cell, seconds: float = 0.5,
          seed: int = 2**32 + 11, trace: bool = False) -> tuple:
    ticks = tiny_file(cell.name)["ticks"]
    if ticks:
        cell.driver.time = TickClock(seconds / ticks)
    run = harness.Run(cell, seed=seed, seconds=seconds, trace=trace,
                      device=CPU)
    st = cell.driver.setup(run)
    with run.window():
        e2e = cell.driver.measure(run, st)
    return run, st, e2e


def checked(cell: harness.Cell, **kw) -> harness.Run:
    run, st, _ = drive(cell, **kw)
    cell.driver.check(run, st)
    return run


@pytest.fixture(scope="module")
def sound():
    """Each cell's sound tiny drive, made on its first use and kept for the
    module.  A call gives the cell, a copy of the run (checks and counters
    its own), a copy of the driver's state (a check that takes from it, as
    the train driver's does, leaves the next caller's whole) and the
    end-to-end values."""
    made = {}

    def get(cell: str) -> tuple:
        if cell not in made:
            c = tiny(cell)
            made[cell] = (c, *drive(c))
        c, run, st, e2e = made[cell]
        mine = copy.copy(run)
        mine.checks, mine.counters = list(run.checks), dict(run.counters)
        return c, mine, dict(st), e2e
    return get


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, sound):
    c, run, st, e2e = sound(cell)
    assert set(e2e) == {m["name"] for m in c.end_to_end} - {"setup_s"}
    assert all(v > 0 for v in e2e.values())
    c.driver.check(run, st)
    assert run.correct, run.checks
    json.dumps(run.checks)


def test_a_traced_run_reads_its_window():
    """The trace's window is the measured one, its gaps cover it, the
    harness keeps its spans, and a reader with nothing on the card gives
    None."""
    run, _, _ = drive(tiny("olmoe-route"), trace=True)
    t = run.trace
    assert t.window_s >= 0.5 and t.busy_s == 0 and not t.kernels
    assert sum(t.gaps.values()) == pytest.approx(t.window_s)
    assert {name for _, _, name in run.spans} == {"bench.submit_jobs",
                                                  "bench.wait"}
    reader = harness.load_module(harness.BENCH / "metrics" /
                                 "idle_share.route.py", "t_idle")
    assert reader.read(run) is None
    assert run.trace.breakdown()["device_ops"] == []


def test_route_reference_equals_the_port_bit_for_bit(sound):
    """Placements, paths, bounds, backlogs and final queues of the port
    equal the NumPy reference's, and the bf16 reference differs."""
    c, run, st, _ = sound("olmoe-route")
    assert run.counters["placements"] >= 10
    assert c.driver.gap(run, st) == 0
    assert c.driver.gap(run, st, control=True) > c.limits[
        "placements_differing"]


def _shift_first_layer(original):
    def altered(total, bps):
        out = original(total, bps).copy()
        out[0] = (out[0] + 1) % total.shape[-1]
        return out
    return altered


def test_route_fault_an_altered_placement(monkeypatch):
    from repro_torch.core import routing
    monkeypatch.setattr(routing, "_dp_back",
                        _shift_first_layer(routing._dp_back))
    assert not checked(tiny("olmoe-route")).correct


def test_route_fault_a_commit_that_leaves_the_queues(monkeypatch):
    from repro_torch.core import routing
    real = routing.commit_with_hops

    def unchanged(net, *args, **kw):
        return net, real(net, *args, **kw)[1]
    monkeypatch.setattr(routing, "commit_with_hops", unchanged)
    assert not checked(tiny("olmoe-route")).correct


@pytest.mark.parametrize("cell", ["phi3v-prefill"])
def test_lm_fault_a_token_altered_where_it_is_produced(cell, monkeypatch):
    from repro_torch.models import common
    real = common.unembed

    def rolled(params, x):
        return real(params, x).roll(1, dims=-1)
    monkeypatch.setattr(common, "unembed", rolled)
    assert not checked(tiny(cell)).correct


def test_train_fault_a_step_that_returns_its_state(monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(self, params, grads, state):
        return params, state, {}
    monkeypatch.setattr(adamw.AdamW, "apply", unchanged)
    run = checked(tiny("olmoe-train"))
    assert not run.correct
    assert dict((n, v) for n, v, _ in run.checks)["train_change_norm_gap"] \
        == pytest.approx(1.0)


def test_train_fault_half_the_batch_left_out(monkeypatch):
    from repro_torch.models import model
    real = model.loss_fn

    def half(cfg, params, batch):
        b = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:b] for k, v in batch.items()})
    monkeypatch.setattr(model, "loss_fn", half)
    assert not checked(tiny("olmoe-train")).correct


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, sound):
    c, run, st, _ = sound(cell)
    got = c.driver.gap(run, st, control=True)
    got = got if isinstance(got, dict) else {None: got}
    limits = list(c.limits.values())
    assert any(v > lim for v, lim in zip(got.values(), limits)), got
