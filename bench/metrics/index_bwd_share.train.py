"""Per cent of the card's busy time in ``indexing_backward_kernel``: the
sort-based backward of the embedding's and the MoE dispatch's gathers
(``models/moe``)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    secs, n = t.time_of("indexing_backward_kernel")
    return 100.0 * secs / t.busy_s if n else None
