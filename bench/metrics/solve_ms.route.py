"""Median of the scheduler's own solve time a placement
(``ArrivalRecord.solve_s``), in ms: ``core/solvers`` -> ``core/greedy``."""
import statistics


def read(run):
    solve = run.counters.get("solve_s")
    return statistics.median(solve) * 1e3 if solve else None
