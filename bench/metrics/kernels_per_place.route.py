"""Device operations a placement launches: the traced window's count over
the placements made in it (``core/shortest_path``, ``core/numerics``,
``kernels/minplus``)."""


def read(run):
    n = run.counters.get("placements")
    if run.trace is None or not n:
        return None
    return run.trace.launches / n
