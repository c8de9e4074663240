"""Back-to-back training steps through the port's
``launch.steps.make_train_step`` (loss, autograd through the flash and
MoE backward, AdamW), each on new seeded rows.

Set-up draws the weights, builds the step and its optimizer state (the
counter at ``start_step``: a job past its warm-up, where a step's update
is larger than a bf16 parameter's rounding), and runs the first
``check_steps`` steps, which also warm every shape up.  The window takes
that same state on from there.  After the window the float32 reference
(the configuration's architecture module's ``Model`` under
:mod:`bench.reference.train`) follows the first steps from the same
weights and rows.  Three numbers are compared, each by the worst leaf
and over the larger of the reference's norm of that leaf and of the
median leaf: the gap between the norms of the first clipped gradient,
the gap between the norms of the change the steps made, and the norm of
the first clipped gradient's difference from the reference's.
"""
from __future__ import annotations

import statistics
import time

import torch

from bench import models, traffic
from bench.reference import train as ref

BATCH_STREAM = 2000


def batch(run, cfg, i: int) -> dict:
    """Step ``i``'s rows: seeded tokens, the labels the next tokens."""
    gen = torch.Generator(device=run.device)
    gen.manual_seed(traffic.torch_seed(run.seed, BATCH_STREAM + i))
    toks = torch.randint(0, cfg.vocab_size,
                         (run.mix["batch"], run.mix["seq_len"] + 1),
                         generator=gen, device=run.device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def setup(run):
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from repro_torch.pytree import leaves
    cfg = models.program_config(run.config)
    params = models.make_weights(run.config, cfg, run.seed, run.device)
    opt = default_optimizer(cfg)
    state = opt.init(params)
    state["step"].fill_(run.mix["start_step"])
    step = make_train_step(cfg, opt, device=run.device)
    start, losses = params, []
    for i in range(run.mix["check_steps"]):
        loss, params, state = step(params, state, batch(run, cfg, i))
        losses.append(float(loss))
        if i == 0:   # the clipped gradient, from m = (1 - b1) g
            grad1_t = [(m / (1 - opt.b1)).cpu() for m in leaves(state["m"])]
    with torch.no_grad():
        change = [float((a.float() - b.float()).norm())
                  for a, b in zip(leaves(params), leaves(start))]
    del start
    return {"cfg": cfg, "params": params, "state": state, "step": step,
            "program": {"loss": losses, "grad1_t": grad1_t,
                        "grad1": [float(g.norm()) for g in grad1_t],
                        "change": change}}


def measure(run, st) -> dict:
    cfg, step = st["cfg"], st["step"]
    params, state = st["params"], st["state"]
    first, steps = run.mix["check_steps"], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        with run.span("inputs"):
            rows = batch(run, cfg, first + steps)
        with run.span("train_step"):
            loss, params, state = step(params, state, rows)
            float(loss)
        steps += 1
    wall = time.perf_counter() - t0
    st.update(params=params, state=state)
    tokens = steps * run.mix["batch"] * run.mix["seq_len"]
    run.counters.update({"attempted": steps, "failed": 0, "steps": steps,
                         "tokens": tokens})
    return {"train_tokens_per_s": tokens / wall}


def leaf_gap(got: list, want: list, keep: list, base: list | None = None
             ) -> float:
    """The largest |got - want| over the kept leaves, each over the
    larger of that leaf's ``base`` (default ``want``) and the median kept
    one."""
    base = want if base is None else base
    med = statistics.median(b for b, k in zip(base, keep) if k)
    return max(abs(g - w) / max(b, med)
               for g, w, b, k in zip(got, want, base, keep) if k)


def gaps(run, got: dict, want: dict) -> dict:
    """The compared numbers of ``got`` against the reference ``want``,
    which judged ``got``'s first gradients.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out.  The loss gap is kept apart: it
    separates no control or fault (PERF.md) and is not compared."""
    med = statistics.median(want["grad1"])
    keep = [g >= 1e-3 * med for g in want["grad1"]]
    run.counters["loss_gap"] = max(abs(a - b) / abs(b)
                                   for a, b in zip(got["loss"], want["loss"]))
    return {
        "grad_norm": leaf_gap(got["grad1"], want["grad1"], keep),
        "change_norm": leaf_gap(got["change"], want["change"], keep),
        "grad_diff": leaf_gap(want["grad1_diff"], [0.0] * len(keep), keep,
                              base=want["grad1"])}


def reference(run, st, matmul: str = "float32", judge=None) -> dict:
    for name in ("params", "state", "step"):
        st.pop(name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    params = models.make_weights(run.config, st["cfg"], run.seed, run.device)
    rows = [batch(run, st["cfg"], i) for i in range(run.mix["check_steps"])]
    return ref.steps(run.config, params, rows, run.mix["start_step"],
                     model=models.arch(run.config).Model, matmul=matmul,
                     judge=judge)


def gap(run, st, control: bool = False) -> dict:
    """The compared numbers: of the program, or (``control``) of the fp8
    reference, each against the float32 reference."""
    got = reference(run, st, "fp8") if control else st["program"]
    return gaps(run, got, reference(run, st, judge=got["grad1_t"]))


def check(run, st) -> None:
    for name, value in gap(run, st).items():
        run.check(f"train_{name}_gap", value, run.limits[f"{name}_gap"])
