"""Back-to-back prefill: one request (a batch of the mix's ``batch``
prompts) at a time through the port's ``launch.steps.make_prefill_step``,
each with new seeded tokens (and, for a vision model, new standard-normal
patch embeddings).  Requests are sent without waiting for the one before,
so the card works through the launch queue while the host stalls; once
the window's time is up nothing more is sent, every request sent is
waited for, and the clock is read after that wait, so the rate covers all
the work sent over all of its time.

Every request's greedy token at every position (the argmax of its
logits) is kept on the card.  After the window a sample of the finished
requests, drawn from the seed, is run through the float32 reference (the
configuration's architecture module's ``Model``), and the widest gap by
which a served token's logit lies below the reference's best is compared
with its limit.
"""
from __future__ import annotations

import time

import torch

from bench import models, traffic

REQUEST_STREAM = 1000


def request(run, prog_cfg, i: int) -> dict:
    """Request ``i``'s inputs, from the seed, on the card."""
    mix = run.mix
    gen = torch.Generator(device=run.device)
    gen.manual_seed(traffic.torch_seed(run.seed, REQUEST_STREAM + i))
    b, s = mix["batch"], mix["seq_len"]
    batch = {"tokens": torch.randint(0, prog_cfg.vocab_size, (b, s),
                                     generator=gen, device=run.device)}
    if prog_cfg.num_patches:
        batch["patches"] = torch.randn(
            (b, prog_cfg.num_patches, prog_cfg.d_model), generator=gen,
            device=run.device).to(prog_cfg.dtype)
    return batch


def positions(run, prog_cfg) -> int:
    """Positions (patches and tokens) of one request."""
    return run.mix["batch"] * (run.mix["seq_len"] + prog_cfg.num_patches)


def setup(run):
    from repro_torch.launch.steps import make_prefill_step
    prog_cfg = models.program_config(run.config)
    params = models.make_weights(run.config, prog_cfg, run.seed, run.device)
    step = make_prefill_step(prog_cfg, device=run.device)
    for i in range(run.mix["warmup_requests"]):
        step(params, request(run, prog_cfg, -1 - i)).argmax(-1)
    run.sync()
    return {"cfg": prog_cfg, "params": params, "step": step}


def measure(run, st) -> dict:
    cfg, params, step = st["cfg"], st["params"], st["step"]
    served = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        with run.span("inputs"):
            batch = request(run, cfg, len(served))
        with run.span("prefill_step"):
            served.append(step(params, batch).argmax(-1))
    run.sync()
    wall = time.perf_counter() - t0
    st["served"] = served
    n = len(served)
    run.counters.update({"attempted": n, "failed": 0, "requests": n,
                         "positions": n * positions(run, cfg)})
    return {"prefill_tokens_per_s": n * positions(run, cfg) / wall}


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The largest amount by which the logit of a served token lies below
    the best logit, under the reference's logits."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long()[..., None])[..., 0]
    return float((best - got).max())


def gap(run, st, control: bool = False) -> float:
    """The widest gap over a sample of the finished requests drawn from
    the seed: of the program's served tokens, or (``control``) of the
    tokens the fp8 reference puts first at the same inputs."""
    cfg, served = st["cfg"], st["served"]
    picks = traffic.sample(len(served), run.mix["check_requests"], run.seed)
    model = models.arch(run.config).Model
    ref = model(run.config, st["params"])
    low = model(run.config, st["params"], matmul="fp8")
    out = 0.0
    with torch.no_grad():
        for i in picks:
            batch = request(run, cfg, i)
            args = (batch["tokens"], batch.get("patches"))
            tokens = low.forward(*args).argmax(-1) if control else served[i]
            out = max(out, widest_gap(ref.forward(*args), tokens))
    return out


def check(run, st) -> None:
    run.check("prefill_logit_gap", gap(run, st), run.limits["logit_gap"])
