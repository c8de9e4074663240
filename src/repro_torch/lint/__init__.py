"""repro_torch.lint — trace-safety & numerics static analysis for this codebase.

Counterpart of ``repro.lint``: the same engine, the same six rules under
the same codes, and the same ``# repro-lint:`` pragma spelling, so one
pragma holds under both linters.  Bit-exactness and the solvers'
one-dispatch contract rest on fragile invariants: the FMA-proof
``(d + Q) * inv`` edge-weight form, the "unroll only contraction-free scan
bodies" rule, host-sync-free device loops, frozen-dataclass cache slots,
and the stamped-never-accumulated float64 clock.  This package makes those
invariants machine-checked:

    python -m repro_torch.lint src/ tests/ benchmarks/ chip_smoke.py [--strict]

Rule families (see :mod:`repro_torch.lint.rules` for the full docs):

=======  ====================  ==============================================
code     name                  invariant
=======  ====================  ==============================================
RL001    contraction-hazard    no ``a*x + b`` float multiply-add in device
                               code of numerics modules (FMA contraction
                               flips last-ulp argmin ties)
RL002    unsafe-unroll         ``lax.scan(..., unroll>1)`` only for
                               contraction-free (gather/add/argmin) bodies
RL003    host-sync-in-device   no ``.item()`` / ``float(tracer)`` /
                               ``np.asarray`` / ``device_get`` /
                               ``block_until_ready`` inside jit/scan regions
RL004    frozen-mutation       ``object.__setattr__`` only in
                               ``__post_init__`` or blessed cache slots;
                               pytree dataclasses must be frozen
RL005    clock-hygiene         never *accumulate* into a clock — stamp it
                               from the authoritative float64 host clock
RL006    dispatch-accounting   solver entry points thread
                               ``meta["dispatches"]`` / ``n_routings``
=======  ====================  ==============================================

RL001-RL003 recognise device code by its JAX tracing constructs, as the
reference's rules do: the linter reads source text and imports nothing
it lints, so it checks either package.

Suppression::

    bad_expr()  # repro-lint: disable=RL001 -- one-line justification

A pragma without a ``-- reason`` (or naming an unknown code) is itself an
error (RL000).  The analyzer is pure stdlib ``ast`` — no runtime imports of
the linted code, no new dependencies.
"""
from __future__ import annotations

from .engine import (Violation, lint_paths, lint_source, registered_rules,
                     run_cli)
from . import rules as _rules  # noqa: F401  (registers the rule families)

__all__ = ["Violation", "lint_paths", "lint_source", "registered_rules",
           "run_cli"]
