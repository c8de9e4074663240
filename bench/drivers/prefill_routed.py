"""Back-to-back prefill of an expert model, checked on the program's own
expert choices.

Set-up, requests and the measured window are ``prefill``'s (its
functions).  The check differs.  A bf16 program's router breaks some
near-ties among the experts' probabilities otherwise than a float32
reference does, and with seeded weights each such choice rewrites that
token's later layers (and, through attention, a little of the tokens
after it): over thousands of positions the plain widest gap then reads
as high for a sound bf16 program as for the fp8 control.  So the
comparison is made in two parts, on a sample of the finished requests
drawn from the seed:

* ``logit_gap``: each sampled request runs through the program's step
  again with its router watched (the [N, k] choices of every expert
  layer), and the float32 reference follows those choices, weighting
  each by its own router's probability; the widest gap by which a served
  token's logit lies below the best, under the reference's logits.
* ``route_share``: the share of (token, expert layer) pairs at which the
  program's chosen experts differ from those the reference's own router
  picks at its own inputs, on that same followed stream.  A near-tie
  decided the other way counts here, and the following keeps it out of
  the logit gap; a router that chooses otherwise (another grouping,
  another top-k) shows as a share of a different order.

The control puts the fp8 reference in the program's place: it follows
the program's choices, and its tokens and its own choices are compared.
"""
from __future__ import annotations

import contextlib
import time

import torch

from bench import models, traffic
from bench.drivers import prefill

setup = prefill.setup


def measure(run, st) -> dict:
    """``prefill``'s window, on this module's clock (a test replaces
    ``time``)."""
    prefill.time = time
    return prefill.measure(run, st)


@contextlib.contextmanager
def watched_router():
    """The program's expert choices, one [N, k] tensor an expert layer in
    the order the layers run, while the block is open."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(p, xf, cfg):
        out = real(p, xf, cfg)
        seen.append(out[1])
        return out
    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def differing(a: list, b: list) -> tuple[int, int]:
    """(pairs whose chosen sets differ, pairs) over layers of [N, k]
    choices."""
    n = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b))
    return n, sum(x.shape[0] for x in a)


def gap(run, st, control: bool = False) -> dict:
    """The compared numbers of the program's served tokens and choices,
    or (``control``) of the fp8 reference's, against the float32
    reference on the program's choices."""
    cfg, served = st["cfg"], st["served"]
    picks = traffic.sample(len(served), run.mix["check_requests"], run.seed)
    model = models.arch(run.config).Model
    ref = model(run.config, st["params"])
    low = model(run.config, st["params"], matmul="fp8") if control else None
    widest, differ, pairs = 0.0, 0, 0
    with torch.no_grad():
        for i in picks:
            batch = prefill.request(run, cfg, i)
            with watched_router() as chosen:
                st["step"](st["params"], batch)
            args = (batch["tokens"], batch.get("patches"))
            logits = ref.forward(*args, experts=chosen)
            own = ref.choices
            if control:
                tokens = low.forward(*args, experts=chosen).argmax(-1)
                chosen = low.choices
            else:
                tokens = served[i]
            widest = max(widest, prefill.widest_gap(logits, tokens))
            del logits
            n, total = differing(chosen, own)
            differ, pairs = differ + n, pairs + total
    return {"logit_gap": widest, "route_share": differ / max(pairs, 1)}


def check(run, st) -> None:
    for name, value in gap(run, st).items():
        run.check(f"prefill_{name}", value, run.limits[name])
