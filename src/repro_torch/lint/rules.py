"""The six rule families, each grounded in a real past regression.

Counterpart of ``repro.lint.rules``, the same rules under the same codes;
:data:`NUMERICS_MODULES` also names the port's ``core`` and ``kernels``.

Every rule documents the invariant it machine-checks and points back at the
docstring where the full story lives, so a lint failure is a teaching
moment, not a style nit.  Scoping:

* RL001/RL002 fire only in **numerics-contract modules**
  (:data:`NUMERICS_MODULES`) — the solver/kernel hot paths whose outputs
  are bit-parity-gated in CI.  Model code has no cross-program bit
  contract, so FMA contraction there is a non-event.
* RL003 fires in any *device region* (see
  :mod:`repro_torch.lint.resolver`) of any module.
* RL004-RL006 are structural and fire everywhere (RL006 outside tests
  and benchmarks).
"""
from __future__ import annotations

import ast
import re

from .engine import LintModule, register_rule
from .resolver import FuncNode, call_head

# Path fragments of modules whose device code carries a bit-parity contract
# (the fused<->ref solver gates in BENCH_solver.json / test_fused.py).
# Extend this list when a new subsystem grows a golden-bit contract.
NUMERICS_MODULES = ("repro/core/", "repro/kernels/", "repro_torch/core/",
                    "repro_torch/kernels/")

# meta keys that satisfy the dispatch-accounting contract (RL006).
ACCOUNTING_KEYS = {"dispatches", "n_routings"}


# ---------------------------------------------------------------------------
# shared expression classifiers
# ---------------------------------------------------------------------------

_INT_NAME = re.compile(
    r"^(i|j|k|l|m|n|p|idx|axis|dim|ndim|rank|seq|ptr|off|offset|stride"
    r"|lmax|length|width|steps|src|dst|cur|nxt|prev|node|layer|hop|round"
    r"|order|routed|valid|keep|active|done|dead|mask|arrived"
    r"|num_\w+|n_\w+|max_\w+|min_\w+"
    r"|\w+_(?:idx|id|ids|index|i|j|k|n|len|count|size|dim|dims|steps|hops"
    r"|layers|jobs|nodes|rounds|windows|bp|ids32))$")

_INT_CALLS = {"int", "len", "ord", "range", "arange", "argmin", "argmax",
              "bit_length", "astype", "searchsorted", "argsort", "sum"}


def _intish(node: ast.AST) -> bool:
    """Conservatively: does this expression look integer/bool-valued?

    Integer multiply-adds cannot FMA-contract, so RL001/RL002 skip them.
    Unknown expressions report False (checked, not skipped).
    """
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, bool)) and not isinstance(
            node.value, float)
    if isinstance(node, ast.Name):
        return bool(_INT_NAME.match(node.id))
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim", "size") or bool(
            _INT_NAME.match(node.attr))
    if isinstance(node, ast.Subscript):
        return _intish(node.value)
    if isinstance(node, ast.Call):
        head = call_head(node.func)
        if head == "astype":
            return any("int" in ast.dump(a) or "bool" in ast.dump(a)
                       for a in node.args)
        return head in _INT_CALLS
    if isinstance(node, ast.BinOp):
        return _intish(node.left) and _intish(node.right)
    if isinstance(node, ast.UnaryOp):
        return _intish(node.operand)
    if isinstance(node, ast.Compare):
        return True          # comparisons are bool
    return False


def _contraction_sites(tree: ast.AST):
    """Yield Add/Sub BinOps fed by a float multiply — the FMA-contractible
    shape ``a*x + b`` / ``a + b*x`` (and the fused-multiply-subtract
    variants)."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, (ast.Add, ast.Sub))):
            continue
        for side in (node.left, node.right):
            if (isinstance(side, ast.BinOp) and isinstance(side.op, ast.Mult)
                    and not (_intish(side.left) and _intish(side.right))):
                yield node
                break


def _enclosing_function(module: LintModule, node: ast.AST) -> ast.AST | None:
    return module.enclosing(node, *FuncNode)


def _in_device_code(module: LintModule, node: ast.AST) -> bool:
    fn = _enclosing_function(module, node)
    return fn is not None and module.resolver.is_device(fn)


# ---------------------------------------------------------------------------
# RL001 — contraction hazard
# ---------------------------------------------------------------------------

@register_rule(
    "RL001", "contraction-hazard",
    "float multiply feeding an add/sub in parity-gated device code "
    "(FMA contraction flips last-ulp argmin ties)")
def rl001_contraction_hazard(module: LintModule):
    """The split edge-weight form ``d*inv + Q*inv`` contracted into
    an FMA *or not* depending on the surrounding program, so the fused
    round scan, the standalone closure build, and eager execution each
    rounded the last ulp differently — flipping argmin ties and breaking
    bitwise solver parity (``lax.optimization_barrier`` does not stop the
    contraction on CPU).  The fix is algebraic: write the expression so
    the multiply is the LAST rounding — ``(d + Q) * inv`` — which no
    backend can contract.  See the ``layer_edge_weights`` docstring in
    ``src/repro/core/shortest_path.py`` for the full story.
    """
    if not module.in_module(*NUMERICS_MODULES):
        return
    for site in _contraction_sites(module.tree):
        if not _in_device_code(module, site):
            continue
        yield module.flag(
            site, "RL001",
            "contraction-hazard: float multiply feeding an add/sub in "
            "bit-parity-gated device code; FMA contraction is program-"
            "context dependent and flips last-ulp argmin ties. "
            "Prefer the fused form `(a + b) * x` (multiply last) — see "
            "layer_edge_weights in src/repro/core/shortest_path.py — or "
            "suppress with a justification."), site


# ---------------------------------------------------------------------------
# RL002 — unsafe unroll
# ---------------------------------------------------------------------------

def _resolve_scan_body(module: LintModule, call: ast.Call) -> ast.AST | None:
    if not call.args:
        return None
    cand = call.args[0]
    if isinstance(cand, ast.Call) and call_head(cand.func) == "partial":
        cand = cand.args[0] if cand.args else None
    if isinstance(cand, ast.Lambda):
        return cand
    if isinstance(cand, ast.Name):
        for node in ast.walk(module.tree):
            if isinstance(node, FuncNode) and getattr(node, "name", None) \
                    == cand.id:
                return node
    return None


@register_rule(
    "RL002", "unsafe-unroll",
    "lax.scan(..., unroll>1) whose body carries a float multiply-add "
    "chain (unroll factor changes FMA contraction, hence golden values)")
def rl002_unsafe_unroll(module: LintModule):
    """Only contraction-free scan bodies may unroll.  Unrolling
    re-schedules the body's float ops, so LLVM contracts a multiply-add
    chain differently at each unroll factor — hoisting the DP forward
    scan's ``c_l * cinv`` changed golden values, while ``reconstruct_path``
    (gathers, adds, argmin — nothing to contract) unrolls bit-identically.
    See the ``reconstruct_path`` docstring in
    ``src/repro/core/shortest_path.py`` and ``_dp_back`` in
    ``src/repro/core/routing.py``.
    """
    if not module.in_module(*NUMERICS_MODULES):
        return
    for call in ast.walk(module.tree):
        if not (isinstance(call, ast.Call)
                and call_head(call.func) == "scan"):
            continue
        unroll = next((kw.value for kw in call.keywords
                       if kw.arg == "unroll"), None)
        if unroll is None:
            continue
        if isinstance(unroll, ast.Constant):
            if unroll.value in (1, False):
                continue
        else:
            yield module.flag(
                call, "RL002",
                "unsafe-unroll: non-literal unroll factor cannot be "
                "checked for contraction safety; use a literal (or "
                "suppress with a justification)"), call
            continue
        body = _resolve_scan_body(module, call)
        if body is None:
            yield module.flag(
                call, "RL002",
                "unsafe-unroll: cannot resolve the scan body to check it "
                "for float multiply-add chains; pass a local function or "
                "suppress with a justification"), call
            continue
        if any(True for _ in _contraction_sites(body)):
            yield module.flag(
                call, "RL002",
                "unsafe-unroll: scan body contains a float multiply-add "
                "chain; unrolling changes FMA contraction and hence "
                "golden values. Only gather/add/argmin bodies like "
                "reconstruct_path may unroll — see its docstring in "
                "src/repro/core/shortest_path.py."), call


# ---------------------------------------------------------------------------
# RL003 — host sync in device code
# ---------------------------------------------------------------------------

_SYNC_ATTRS = {"item", "block_until_ready", "tolist", "copy_to_host_async"}
_NP_NAMES = {"np", "numpy", "onp"}
_NP_CONVERTERS = {"asarray", "array", "ascontiguousarray", "frombuffer"}
_SCALAR_CASTS = {"float", "int", "bool", "complex"}


@register_rule(
    "RL003", "host-sync-in-device",
    "host synchronization (.item()/float(tracer)/np.asarray/device_get/"
    "block_until_ready) lexically inside a jit/scan/while_loop region")
def rl003_host_sync(module: LintModule):
    """The fused solver's contract is exactly one dispatch and one host
    sync per solve (``meta["dispatches"] == 1``, asserted in
    tests/test_fused.py).  A host sync inside a function traced by
    ``jax.jit`` / ``lax.scan`` / ``lax.while_loop`` either fails at trace
    time (on a tracer) or — worse — silently executes at *trace* time on a
    constant and bakes a stale value into the compiled program.  Host
    reads belong in the host loop, after the one explicit ``device_get``.
    """
    for call in ast.walk(module.tree):
        if not isinstance(call, ast.Call):
            continue
        if not _in_device_code(module, call):
            continue
        msg = None
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SYNC_ATTRS:
            msg = f".{call.func.attr}() forces a host sync"
        elif call_head(call.func) == "device_get":
            msg = "jax.device_get forces a device->host transfer"
        elif (isinstance(call.func, ast.Attribute)
              and isinstance(call.func.value, ast.Name)
              and call.func.value.id in _NP_NAMES
              and call.func.attr in _NP_CONVERTERS):
            msg = (f"{call.func.value.id}.{call.func.attr} materializes on "
                   "host (a sync on traced values, a stale trace-time "
                   "constant otherwise)")
        elif (isinstance(call.func, ast.Name)
              and call.func.id in _SCALAR_CASTS and len(call.args) == 1
              and not _intish(call.args[0])
              and not isinstance(call.args[0], ast.Constant)):
            msg = (f"{call.func.id}(...) of a traced value forces a host "
                   "sync")
        if msg:
            yield module.flag(
                call, "RL003",
                f"host-sync-in-device: {msg} inside a jit/scan-traced "
                "function, breaking the one-dispatch-per-solve contract "
                "(meta[\"dispatches\"] == 1; see "
                "src/repro/core/greedy.py). Move the read to the host "
                "loop or suppress with a justification."), call


# ---------------------------------------------------------------------------
# RL004 — frozen-dataclass mutation
# ---------------------------------------------------------------------------

_MUTABLE_ANNOTATIONS = {"list", "dict", "set", "List", "Dict", "Set"}


def _annotation_head(node: ast.AST) -> str | None:
    if isinstance(node, ast.Subscript):
        return _annotation_head(node.value)
    if isinstance(node, (ast.Name, ast.Attribute)):
        return call_head(node)
    return None


@register_rule(
    "RL004", "frozen-mutation",
    "object.__setattr__ outside __post_init__/blessed cache slots, or a "
    "pytree-registered dataclass that is not frozen")
def rl004_frozen_mutation(module: LintModule):
    """Pytree dataclasses flow through jit boundaries by value; in-place
    mutation desynchronizes host copies from traced ones.  The blessed
    exceptions are ``__post_init__`` normalization (standard frozen-
    dataclass idiom) and the stamp-guarded engine cache slot documented in
    ``src/repro/core/completions.py`` ("the persistent engine cache") —
    a slot set via ``object.__setattr__`` precisely so
    ``dataclasses.replace`` never copies it; such sites carry a pragma.
    Mutable (list/dict/set) fields on pytree classes are flagged for the
    same reason: leaves must be immutable values or arrays.
    """
    for call in ast.walk(module.tree):
        if (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "__setattr__"
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "object"):
            fn = _enclosing_function(module, call)
            if fn is not None and getattr(fn, "name", "") == "__post_init__":
                continue
            yield module.flag(
                call, "RL004",
                "frozen-mutation: object.__setattr__ outside "
                "__post_init__ mutates a frozen dataclass in place; only "
                "the stamp-guarded cache-slot sites (see 'the persistent "
                "engine cache' in src/repro/core/completions.py) may do "
                "this, each under a justified pragma."), call

    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not any(call_head(d) == "register_dataclass"
                   for d in cls.decorator_list):
            continue
        frozen = False
        for d in cls.decorator_list:
            if isinstance(d, ast.Call) and call_head(d.func) == "dataclass":
                frozen = any(kw.arg == "frozen"
                             and isinstance(kw.value, ast.Constant)
                             and kw.value.value is True
                             for kw in d.keywords)
        if not frozen:
            yield module.flag(
                cls, "RL004",
                f"frozen-mutation: pytree class {cls.name} is registered "
                "with jax.tree_util.register_dataclass but not declared "
                "@dataclasses.dataclass(frozen=True); pytrees flow "
                "through jit by value and must be immutable."), cls
        for stmt in cls.body:
            if isinstance(stmt, ast.AnnAssign) \
                    and _annotation_head(stmt.annotation) \
                    in _MUTABLE_ANNOTATIONS:
                yield module.flag(
                    stmt, "RL004",
                    f"frozen-mutation: pytree class {cls.name} declares a "
                    "mutable container field; pytree leaves must be "
                    "immutable values or arrays."), stmt


# ---------------------------------------------------------------------------
# RL005 — clock hygiene
# ---------------------------------------------------------------------------

_CLOCK_NAME = re.compile(r"^(clock|\w*_clock)$")


def _clockish(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return bool(_CLOCK_NAME.match(node.id))
    if isinstance(node, ast.Attribute):
        return bool(_CLOCK_NAME.match(node.attr))
    return False


def _unwrap_casts(node: ast.AST) -> ast.AST:
    while (isinstance(node, ast.Call) and node.args
           and call_head(node.func) in ("float", "float32", "float64",
                                        "asarray")):
        node = node.args[0]
    return node


def _accumulates_clock(value: ast.AST) -> bool:
    value = _unwrap_casts(value)
    if not (isinstance(value, ast.BinOp)
            and isinstance(value.op, (ast.Add, ast.Sub))):
        return False
    return any(_clockish(n) for n in ast.walk(value))


@register_rule(
    "RL005", "clock-hygiene",
    "arithmetic accumulation into a clock instead of stamping it from "
    "the authoritative float64 host clock")
def rl005_clock_hygiene(module: LintModule):
    """``state.clock`` is a float32 pytree leaf: accumulating it
    (``clock = clock + dt``) loses sub-second ticks past ~2^24 s and
    drifts from the host's float64 ``_now``.  Long-lived host loops keep ONE
    authoritative float64 clock host-side and *stamp* the device clock
    from it (``_stamp_clock`` in ``src/repro/serving/scheduler.py``;
    design note on ``advance`` in ``src/repro/core/state.py``).
    Accumulating into any ``clock``/``*_clock`` target is flagged;
    stamping (assigning a non-arithmetic value) is the sanctioned form.
    """
    for node in ast.walk(module.tree):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.op, (ast.Add, ast.Sub)) \
                and _clockish(node.target):
            yield module.flag(
                node, "RL005",
                "clock-hygiene: augmented accumulation into a clock; "
                "stamp it from the authoritative float64 host clock "
                "instead (see _stamp_clock in "
                "src/repro/serving/scheduler.py)."), node
        elif isinstance(node, ast.Assign):
            if any(_clockish(t) for t in node.targets) \
                    and _accumulates_clock(node.value):
                yield module.flag(
                    node, "RL005",
                    "clock-hygiene: clock assigned from clock arithmetic "
                    "(accumulation); stamp it from the authoritative "
                    "float64 host clock instead (see _stamp_clock in "
                    "src/repro/serving/scheduler.py)."), node
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "clock" and _accumulates_clock(kw.value):
                    yield module.flag(
                        kw.value, "RL005",
                        "clock-hygiene: clock= built by accumulating a "
                        "previous clock; float32 accumulation loses "
                        "sub-second ticks past ~2^24 s — stamp from the "
                        "float64 host clock (see the advance docstring "
                        "in src/repro/core/state.py)."), kw.value


# ---------------------------------------------------------------------------
# RL006 — dispatch-count accounting
# ---------------------------------------------------------------------------

def _dict_literal_keys(node: ast.AST) -> set[str] | None:
    """String keys of a dict literal, or None when not statically a dict.

    A ``**spread`` entry makes the dict unresolvable (None): the spread
    may carry the accounting keys.
    """
    if not isinstance(node, ast.Dict):
        return None
    keys: set[str] = set()
    for k in node.keys:
        if k is None:                      # ** spread
            return None
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.add(k.value)
    return keys


def _resolve_meta_keys(module: LintModule, call: ast.Call,
                       value: ast.AST) -> set[str] | None:
    """Best-effort static resolution of a ``meta=`` expression to its
    string keys: dict literals directly, names assigned from dict
    literals in the enclosing function, and calls to module-local helpers
    that return a dict literal.  None = unresolvable (give the benefit of
    the doubt)."""
    keys = _dict_literal_keys(value)
    if keys is not None:
        return keys
    if isinstance(value, ast.Name):
        fn = _enclosing_function(module, call)
        if fn is None:
            return None
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == value.id
                            for t in stmt.targets):
                return _dict_literal_keys(stmt.value)
        return None
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name):
        for node in ast.walk(module.tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == value.func.id:
                for ret in ast.walk(node):
                    if isinstance(ret, ast.Return) and ret.value is not None:
                        return _dict_literal_keys(ret.value)
    return None


@register_rule(
    "RL006", "dispatch-accounting",
    "a solver building a Plan must thread dispatch accounting "
    "(meta['dispatches'] or meta['n_routings']) into plan.meta")
def rl006_dispatch_accounting(module: LintModule):
    """The one-dispatch-per-solve contract is only *checkable* because
    every solver reports its work: ``meta["dispatches"]`` (fused paths),
    ``meta["n_routings"]`` (host loops), with ``solvers.solve`` layering
    ``closure_builds``/``solve_s`` on top.  A solver that builds a Plan
    without accounting silently exits the regression net — so every
    ``Plan.from_order(...)`` call site outside the Plan class itself must
    pass a ``meta=`` whose statically-visible keys include one of
    ``dispatches`` / ``n_routings`` (unresolvable expressions pass; dict
    literals and local helpers are checked).
    """
    if "/tests/" in module.posix or module.posix.startswith("tests/") \
            or "/benchmarks/" in module.posix \
            or module.posix.startswith("benchmarks/"):
        return
    for call in ast.walk(module.tree):
        if not (isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "from_order"
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "Plan"):
            continue
        cls = module.enclosing(call, ast.ClassDef)
        if cls is not None and cls.name == "Plan":
            continue                        # (de)serialization internals
        meta = next((kw.value for kw in call.keywords if kw.arg == "meta"),
                    None)
        if meta is None:
            yield module.flag(
                call, "RL006",
                "dispatch-accounting: Plan built without meta=; solver "
                "entry points must thread meta['dispatches'] or "
                "meta['n_routings'] so the one-dispatch contract stays "
                "checkable (see fused_dispatch_count in "
                "src/repro/core/greedy.py)."), call
            continue
        keys = _resolve_meta_keys(module, call, meta)
        if keys is not None and not (keys & ACCOUNTING_KEYS):
            yield module.flag(
                call, "RL006",
                "dispatch-accounting: plan meta carries no dispatch "
                "accounting key (need one of "
                f"{sorted(ACCOUNTING_KEYS)}); see fused_dispatch_count "
                "in src/repro/core/greedy.py."), call
