"""CPU tests of the promise that a model cell of a new architecture comes
as new files and manifest entries alone: in a copy of the benchmark, a new
configuration whose ``model_type`` names a new architecture module, with
its own mix, limits and tiny files, resolves, runs correct at its tiny size
and fails with its control, while no file of the repo is written."""
from __future__ import annotations

import hashlib
import json
import shutil

import pytest

torch = pytest.importorskip("torch")

from bench import harness, models  # noqa: E402
from bench.tests.test_bench_harness import drive, tiny  # noqa: E402

CELL, CONFIG, TRAFFIC, KIND = ("standin-prefill", "standin-4b",
                               "prefill_standin", "standin_lm")

# the new architecture: phi-3-vision's mapping, norm rule and reference,
# under a model_type of its own
ARCH = '''"""A stand-in architecture: phi-3-vision's, under another name."""
from bench.arch.phi3_v import Model, is_norm_leaf, program_config  # noqa: F401
'''
MIX = {"driver": "prefill", "batch": 1, "seq_len": 64, "warmup_requests": 1,
       "check_requests": 2}
# float32 at two layers: on seven seeds the program's widest gap read 0
# and the fp8 control's 0.31-0.75
TINY = {"why": "two float32 layers, four patches, 32 tokens",
        "config": {"hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 2,
                   "num_key_value_heads": 2, "vocab_size": 512,
                   "num_patches": 4, "torch_dtype": "float32",
                   "program": {"attn_impl": "xla"}},
        "mix": {"seq_len": 32}, "ticks": 3}
LIMITS = {"limits": {"logit_gap": 0.05}}


def repo_files(bench=harness.BENCH, manifest=harness.MANIFEST) -> dict:
    """Every file of the repo's benchmark, by its SHA-256 (compiled
    bytecode left out)."""
    files = [manifest] + [p for p in bench.rglob("*")
                          if p.is_file() and "__pycache__" not in p.parts]
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def write(path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def write_json(path, obj) -> None:
    write(path, json.dumps(obj, indent=2) + "\n")


def add_cell(root) -> None:
    """A copy of the benchmark under ``root`` with one more LM cell, made
    of new files and manifest entries alone."""
    bench = root / "bench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = harness.load_json(bench / "configs/phi-3-vision-4.2b.json")
    write_json(bench / "configs" / f"{CONFIG}.json",
               {**config, "name": CONFIG, "model_type": KIND})
    write(bench / "arch" / f"{KIND}.py", ARCH)
    write_json(bench / "mixes" / f"{TRAFFIC}.json", MIX)
    write_json(bench / "limits" / f"{CELL}.json", LIMITS)
    write_json(bench / "tiny" / f"{CELL}.json", TINY)
    m = harness.load_json(harness.MANIFEST)
    m["configs"].append({"name": CONFIG, "source": "a stand-in",
                         "file": f"bench/configs/{CONFIG}.json",
                         "reduced": [], "why": "a new architecture"})
    m["workloads"].append({"name": CELL, "config": CONFIG,
                           "traffic": TRAFFIC, "chips": 1,
                           "why": "a new architecture's prefill"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if metric["name"] in ("prefill_tokens_per_s", "idle_share.prefill"):
            metric["workloads"].append(CELL)
    write_json(root / "BENCHMARK.json", m)


def test_a_new_architecture_needs_only_new_files(tmp_path, monkeypatch):
    before = repo_files()
    root = tmp_path / "checkout"
    add_cell(root)
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    monkeypatch.setattr(harness, "MANIFEST", root / "BENCHMARK.json")
    loaded = []
    real = harness.load_module

    def spy(path, name):
        loaded.append(path.relative_to(root).as_posix())
        return real(path, name)
    monkeypatch.setattr(harness, "load_module", spy)

    c = tiny(CELL)
    assert {m["name"] for m in c.end_to_end} == {"prefill_tokens_per_s",
                                                "setup_s"}
    assert [m["name"] for m in c.per_layer] == ["idle_share.prefill"]
    run, st, e2e = drive(c)
    assert f"bench/arch/{KIND}.py" in loaded
    assert e2e["prefill_tokens_per_s"] > 0
    assert run.counters["requests"] >= MIX["check_requests"]
    keep = dict(st)
    c.driver.check(run, st)
    assert run.correct, run.checks
    assert c.driver.gap(run, keep, control=True) > c.limits["logit_gap"]
    assert repo_files() == before


def test_a_missing_architecture_names_its_file():
    cfg = {"name": "nowhere", "model_type": "no_such_arch"}
    for call in (models.program_config,
                 lambda c: models.leaf_std("embed/tok", (8, 8), c)):
        with pytest.raises(harness.BenchError,
                           match="bench/arch/no_such_arch.py"):
            call(cfg)
