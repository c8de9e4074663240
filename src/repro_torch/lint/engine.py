"""Rule engine: registry, pragma suppression, file runner, CLI.

A *rule* is a function ``(module: LintModule) -> Iterable[Violation]``
registered under a stable code (``RL001`` ...).  The engine owns everything
rule-independent: parsing, the per-module device-region resolver cache,
``# repro-lint: disable=<code> -- <reason>`` pragma collection and
application, and the CLI entry (:func:`run_cli`, wired to
``python -m repro_torch.lint``).

Pragma semantics
----------------
* ``# repro-lint: disable=RL001 -- reason`` on any line spanned by the
  flagged expression/statement (or on the line directly above it)
  suppresses that code there.
* ``# repro-lint: disable-file=RL003 -- reason`` anywhere in a file
  suppresses the code for the whole file.
* Multiple codes separate with commas: ``disable=RL001,RL005 -- reason``.
* The ``-- reason`` is **mandatory** and the code must exist: a malformed
  pragma is reported as RL000 and is itself unsuppressable — tribal
  knowledge got us here, so every suppression carries its justification.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Iterable, Iterator

from .resolver import DeviceRegionResolver

PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*(?P<kind>disable(?:-file)?)\s*=\s*"
    r"(?P<codes>[A-Za-z0-9_,\s]+?)\s*(?:--\s*(?P<reason>\S.*))?$")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: where, which rule, and the human-facing message."""

    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    doc: str              # one-line invariant summary (README rule table)
    check: Callable[["LintModule"], Iterable[Violation]]


_RULES: dict[str, Rule] = {}

# RL000 is reserved for the engine itself (malformed pragmas) so rules and
# pragma bookkeeping share one reporting path.
BAD_PRAGMA = "RL000"


def register_rule(code: str, name: str, doc: str):
    """Decorator: register a check function under a rule code."""

    def deco(fn):
        if code in _RULES:
            raise ValueError(f"duplicate lint rule code {code!r}")
        _RULES[code] = Rule(code=code, name=name, doc=doc, check=fn)
        return fn

    return deco


def registered_rules() -> dict[str, Rule]:
    """Copy of the {code: Rule} registry (import order registers RL001+)."""
    return dict(_RULES)


class _Pragmas:
    """Per-file pragma index: which codes are disabled on which lines."""

    def __init__(self, source: str, path: str, known: set[str]):
        self.line_codes: dict[int, set[str]] = {}
        self.file_codes: set[str] = set()
        self.bad: list[Violation] = []
        for ln, text in self._comments(source):
            if "repro-lint" not in text:
                continue
            m = PRAGMA_RE.search(text)
            if m is None:
                self.bad.append(Violation(
                    path, ln, 0, BAD_PRAGMA,
                    "unparseable repro-lint pragma (expected "
                    "'# repro-lint: disable=<CODE> -- <reason>')"))
                continue
            codes = {c.strip() for c in m.group("codes").split(",") if c.strip()}
            unknown = sorted(c for c in codes if c not in known)
            if unknown:
                self.bad.append(Violation(
                    path, ln, 0, BAD_PRAGMA,
                    f"pragma names unknown rule code(s): {', '.join(unknown)}"))
            if not m.group("reason"):
                self.bad.append(Violation(
                    path, ln, 0, BAD_PRAGMA,
                    "pragma is missing its '-- <reason>' justification"))
                continue
            codes &= known
            if m.group("kind") == "disable-file":
                self.file_codes |= codes
            else:
                self.line_codes.setdefault(ln, set()).update(codes)

    @staticmethod
    def _comments(source: str) -> list[tuple[int, str]]:
        """(line, text) of actual COMMENT tokens — docstrings and string
        literals that merely *mention* the pragma syntax don't count."""
        try:
            return [(tok.start[0], tok.string)
                    for tok in tokenize.generate_tokens(
                        io.StringIO(source).readline)
                    if tok.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):
            return []   # syntax problems surface via ast.parse instead

    def suppressed(self, v: Violation, span: tuple[int, int]) -> bool:
        if v.code == BAD_PRAGMA:
            return False
        if v.code in self.file_codes:
            return True
        lo, hi = span
        for ln in range(lo - 1, hi + 1):   # line above the span counts too
            if v.code in self.line_codes.get(ln, ()):
                return True
        return False


class LintModule:
    """One parsed file plus the lazy per-module analyses rules share."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.posix = Path(path).as_posix()
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self._resolver: DeviceRegionResolver | None = None
        self._parents: dict[ast.AST, ast.AST] | None = None

    # -- shared analyses ----------------------------------------------------
    @property
    def resolver(self) -> DeviceRegionResolver:
        if self._resolver is None:
            self._resolver = DeviceRegionResolver(self.tree)
        return self._resolver

    @property
    def parents(self) -> dict[ast.AST, ast.AST]:
        """child -> parent map over the whole tree (lazily built once)."""
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def enclosing(self, node: ast.AST, *types) -> ast.AST | None:
        """Nearest ancestor of one of the given AST types (or None)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, types):
                return cur
            cur = self.parents.get(cur)
        return None

    def in_module(self, *fragments: str) -> bool:
        """Does this file live under any of the given path fragments?"""
        return any(f in self.posix for f in fragments)

    # -- violation helper ---------------------------------------------------
    def flag(self, node: ast.AST, code: str, message: str) -> Violation:
        return Violation(self.path, getattr(node, "lineno", 0),
                         getattr(node, "col_offset", 0), code, message)


def node_span(node: ast.AST) -> tuple[int, int]:
    lo = getattr(node, "lineno", 0)
    hi = getattr(node, "end_lineno", lo) or lo
    return lo, hi


def lint_module(module: LintModule,
                codes: Iterable[str] | None = None) -> list[Violation]:
    known = set(_RULES)
    pragmas = _Pragmas(module.source, module.path, known)
    out: list[Violation] = list(pragmas.bad)
    selected = known if codes is None else set(codes) & known
    # Rules report (violation, node) pairs internally via closure on the
    # module; the engine re-derives the span from the reported line by
    # walking the tree once per file below.
    spans: dict[tuple[int, int, str], tuple[int, int]] = {}
    for code in sorted(selected):
        rule = _RULES[code]
        for item in rule.check(module):
            if isinstance(item, tuple):      # (violation, node) from a rule
                v, node = item
                span = node_span(node)
            else:
                v, span = item, (item.line, item.line)
            spans[(v.line, v.col, v.code)] = span
            if not pragmas.suppressed(v, span):
                out.append(v)
    out.sort(key=lambda v: (v.line, v.col, v.code))
    return out


def lint_source(source: str, path: str = "<string>",
                codes: Iterable[str] | None = None) -> list[Violation]:
    """Lint one source string (the test-fixture entry point)."""
    try:
        module = LintModule(path, source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, e.offset or 0, BAD_PRAGMA,
                          f"syntax error: {e.msg}")]
    return lint_module(module, codes)


def iter_py_files(paths: Iterable[str]) -> Iterator[Path]:
    for p in paths:
        root = Path(p)
        if root.is_file() and root.suffix == ".py":
            yield root
        elif root.is_dir():
            yield from sorted(root.rglob("*.py"))


def lint_paths(paths: Iterable[str],
               codes: Iterable[str] | None = None) -> list[Violation]:
    out: list[Violation] = []
    for f in iter_py_files(paths):
        out.extend(lint_source(f.read_text(), str(f), codes))
    return out


def run_cli(argv: list[str] | None = None) -> int:
    """``python -m repro_torch.lint <paths...> [--strict] [--list-rules]``.

    Exit status 0 = clean, 1 = violations found, 2 = usage error.
    ``--strict`` is accepted for CI symmetry; every rule here is an error
    already (there is no warning tier to promote), so it only asserts the
    flag is wired.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="trace-safety & numerics static analysis "
                    "(see src/repro_torch/lint/__init__.py)")
    parser.add_argument("paths", nargs="*", default=["src"],
                        help="files or directories to lint (default: src)")
    parser.add_argument("--strict", action="store_true",
                        help="CI mode (all rules are errors either way)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for code, rule in sorted(registered_rules().items()):
            print(f"{code}  {rule.name}: {rule.doc}")
        return 0

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        parser.error(f"no such path(s): {', '.join(missing)}")
        return 2
    violations = lint_paths(args.paths)
    for v in violations:
        print(v.render())
    n = len(violations)
    print(f"repro_torch.lint: {n} violation{'s' if n != 1 else ''} "
          f"in {sum(1 for _ in iter_py_files(args.paths))} files"
          + (" (clean)" if n == 0 else ""))
    return 1 if violations else 0
