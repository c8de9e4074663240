"""Device-region resolver: which functions get traced into jax programs.

Counterpart of ``repro.lint.resolver``, unchanged: it names JAX's
tracing constructs and reads them from source text in either package.

RL001-RL003 must fire only in *device* code — arithmetic and host syncs in
eager host code is fine (eager ops never cross-fuse, and host code is
allowed to sync).  A function is device-reachable when:

* it is decorated with ``jax.jit`` (directly, via ``functools.partial(
  jax.jit, ...)``, or through ``jax.jit(...)`` as an expression decorator),
  ``jax.vmap``, ``jax.pmap``, ``jax.grad``/``value_and_grad``,
  ``jax.checkpoint``/``remat``, or a Pallas ``pallas_call``; or
* it is passed (possibly wrapped in ``functools.partial``) as a function
  argument to ``lax.scan`` / ``lax.while_loop`` / ``lax.fori_loop`` /
  ``lax.cond`` / ``lax.switch`` / ``lax.map`` / ``lax.associative_scan`` /
  ``jax.jit`` / ``jax.vmap`` / ``pl.pallas_call`` / ``jax.custom_vjp`` —
  these primitives *always trace* their callee, even from eager code; or
* it is defined inside, or called (module-locally, by name) from, a
  function that is itself device-reachable.

The call graph is module-local and name-based on purpose: a lint pass must
not import the code it checks, and cross-module device entry points
(``ops.minplus_closure`` & co.) are jit-decorated in their own module, so
each file's regions resolve locally.  Name collisions over-approximate
(every local def sharing the name is marked), which for a linter errs on
the side of checking more code.
"""
from __future__ import annotations

import ast

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

# Call targets whose function-valued arguments are traced.
_TRACING_CALLS = {
    "scan", "while_loop", "fori_loop", "cond", "switch", "map",
    "associative_scan", "jit", "vmap", "pmap", "grad", "value_and_grad",
    "checkpoint", "remat", "pallas_call", "custom_vjp", "custom_jvp",
}

# Decorator heads that make the decorated function device code.
_TRACING_DECORATORS = {
    "jit", "vmap", "pmap", "grad", "value_and_grad", "checkpoint", "remat",
    "custom_vjp", "custom_jvp", "pallas_call", "kernel",
}


def call_head(node: ast.AST) -> str | None:
    """Rightmost name of a call target: ``jax.lax.scan`` -> ``scan``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _unwrap_partial(node: ast.AST) -> list[ast.AST]:
    """``functools.partial(f, ...)`` -> ``[f]``; anything else -> [node]."""
    if isinstance(node, ast.Call) and call_head(node.func) == "partial":
        return list(node.args[:1])
    return [node]


class DeviceRegionResolver:
    """Marks every function def in one module as device-reachable or host."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self._defs_by_name: dict[str, list[ast.AST]] = {}
        self._enclosing_def: dict[ast.AST, ast.AST | None] = {}
        self._device: set[ast.AST] = set()
        self._collect(tree, None)
        self._mark_roots()
        self._propagate()

    # -- construction -------------------------------------------------------
    def _collect(self, node: ast.AST, owner: ast.AST | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, FuncNode):
                name = getattr(child, "name", None)
                if name is not None:
                    self._defs_by_name.setdefault(name, []).append(child)
                self._enclosing_def[child] = owner
                self._collect(child, child)
            else:
                self._collect(child, owner)

    def _mark_roots(self) -> None:
        for fn in self._enclosing_def:
            if not isinstance(fn, ast.Lambda) and any(
                    self._is_tracing_decorator(d) for d in fn.decorator_list):
                self._device.add(fn)
        for call in ast.walk(self.tree):
            if not isinstance(call, ast.Call):
                continue
            if call_head(call.func) not in _TRACING_CALLS:
                continue
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                for cand in _unwrap_partial(arg):
                    if isinstance(cand, ast.Lambda):
                        self._device.add(cand)
                    elif isinstance(cand, ast.Name):
                        for d in self._defs_by_name.get(cand.id, ()):
                            self._device.add(d)

    @staticmethod
    def _is_tracing_decorator(dec: ast.AST) -> bool:
        if call_head(dec) in _TRACING_DECORATORS:
            return True
        if isinstance(dec, ast.Call):
            head = call_head(dec.func)
            if head in _TRACING_DECORATORS:
                return True
            if head == "partial":
                return any(call_head(a) in _TRACING_DECORATORS
                           for a in dec.args[:1])
        return False

    def _propagate(self) -> None:
        changed = True
        while changed:
            changed = False
            for fn in list(self._enclosing_def):
                if fn in self._device:
                    continue
                owner = self._enclosing_def[fn]
                if owner is not None and owner in self._device:
                    # defined inside a traced function => traced with it
                    self._device.add(fn)
                    changed = True
                    continue
            # calls from device functions mark their local callees
            for fn in list(self._device):
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    head = call_head(call.func)
                    for d in self._defs_by_name.get(head or "", ()):
                        if d not in self._device:
                            self._device.add(d)
                            changed = True

    # -- queries ------------------------------------------------------------
    def is_device(self, fn: ast.AST) -> bool:
        return fn in self._device

    def device_functions(self) -> list[ast.AST]:
        """Device-reachable defs, outermost first (document order)."""
        return sorted(self._device, key=lambda n: (n.lineno, n.col_offset))

    def enclosing_function(self, fn: ast.AST) -> ast.AST | None:
        return self._enclosing_def.get(fn)
