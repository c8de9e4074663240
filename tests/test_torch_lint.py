"""The port's lint (``repro_torch.lint``) against the reference's
(``repro.lint``): every fixture that ``tests/test_lint.py`` lints gives the
same ``(code, line, col)`` list under both, at the fixture's own path and
at the port's counterpart of it; the CLI lists the six rules and lints the
shipped tree clean."""
import ast
import importlib.util
import pathlib
import subprocess
import sys

import pytest

from repro.lint import lint_source as ref_lint_source
from repro_torch.lint import lint_source, registered_rules

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "test_lint.py"
# the reference's tests that lint no fixture (the CLI's and the registry's
# have their counterparts below)
NOT_FIXTURES = ("test_shipped_tree_lints_clean", "test_cli_list_rules",
                "test_all_six_rules_registered")
TEST_NAMES = [n.name for n in ast.parse(FIXTURES.read_text()).body
              if isinstance(n, ast.FunctionDef)
              and n.name.startswith("test_") and n.name not in NOT_FIXTURES]


@pytest.fixture(scope="module")
def fixture_module():
    spec = importlib.util.spec_from_file_location("_lint_fixtures", FIXTURES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _where(violations):
    return [(v.code, v.line, v.col) for v in violations]


@pytest.mark.parametrize("name", TEST_NAMES)
def test_port_lint_matches_reference_on_fixture(fixture_module, name,
                                                monkeypatch):
    """Run the reference's test (its assertions included) while recording
    every source it lints, then lint each with both packages."""
    seen = []

    def recording(src, path="<string>", codes=None):
        seen.append((src, path, codes))
        return ref_lint_source(src, path, codes)

    monkeypatch.setattr(fixture_module, "lint_source", recording)
    fn = getattr(fixture_module, name)
    calls = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "parametrize":
            arg, values = mark.args
            calls = [{arg: v} for v in values]
    for kwargs in calls:
        fn(**kwargs)
    assert seen
    for src, path, codes in seen:
        want = _where(ref_lint_source(src, path, codes))
        assert _where(lint_source(src, path, codes)) == want
        port_path = path.replace("src/repro/", "src/repro_torch/")
        assert _where(lint_source(src, port_path, codes)) == want


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", *args], cwd=REPO,
        capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def test_cli_lists_six_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    listed = [line.split()[0] for line in proc.stdout.splitlines()]
    assert listed == sorted(registered_rules()) == [
        "RL001", "RL002", "RL003", "RL004", "RL005", "RL006"]


def test_shipped_tree_lints_clean_through_port_cli():
    proc = _cli("src/", "tests/", "benchmarks/", "chip_smoke.py", "--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violations" in proc.stdout
