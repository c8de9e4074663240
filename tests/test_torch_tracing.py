"""The port's span recorder (``repro_torch.tracing``) and the spans the
placement path and the train step open: nesting, request ids, threads,
the no-op while recording is off and its cost, the clock the spans are
mapped onto, and ``meta["solve_s"]`` read from the solver's own span."""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import jobs as J, solvers  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.scenarios import make_scenario  # noqa: E402
from repro_torch.serving.online import OnlineScheduler  # noqa: E402


@pytest.fixture(autouse=True)
def _stopped():
    tracing.stop()
    yield
    tracing.stop()


def names(spans):
    return [s.name for s in spans]


def test_spans_nest_and_inherit_the_request_id():
    tracing.start()
    with tracing.span("a", rid="r1"):
        with tracing.span("b"):
            with tracing.span("c", rid="r2"):
                pass
        with tracing.span("d"):
            pass
    with tracing.span("e"):
        pass
    got = tracing.stop()
    assert names(got) == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in got] == [None, 0, 1, 0, None]
    assert [s.rid for s in got] == ["r1", "r1", "r2", "r1", None]
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = got[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_each_thread_nests_on_its_own_stack():
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"outer.{tag}", rid=tag):
            barrier.wait()        # both outer spans open at once
            with tracing.span(f"inner.{tag}"):
                barrier.wait()

    tracing.start()
    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    got = tracing.stop()
    assert sorted(names(got)) == ["inner.x", "inner.y", "outer.x", "outer.y"]
    for s in got:
        if s.name.startswith("inner."):
            tag = s.name[-1]
            assert got[s.parent].name == f"outer.{tag}" and s.rid == tag
        else:
            assert s.parent is None


def test_off_a_span_is_one_shared_no_op_and_records_nothing():
    a, b = tracing.span("x"), tracing.span("y", rid=3)
    assert a is b
    with a:
        with b:
            pass
    with tracing.span("t", timed=True) as timed:
        time.sleep(0.001)
    assert timed.seconds >= 0.001
    tracing.start()
    assert tracing.stop() == []


def test_off_a_span_costs_under_a_microsecond_or_so():
    n, best = 20_000, float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 5e-6     # loose: a span off takes about 0.3-0.6 us on a CPU


def test_start_clears_and_stop_hands_back_once():
    tracing.start()
    with tracing.span("old"):
        pass
    tracing.start()
    with tracing.span("new"):
        pass
    assert names(tracing.stop()) == ["new"]
    assert tracing.stop() == []
    with tracing.span("after"):
        pass
    tracing.start()
    assert tracing.stop() == []


def test_spans_are_on_the_time_ns_clock():
    tracing.start()
    w0 = time.time_ns()
    with tracing.span("s"):
        time.sleep(0.002)
    w1 = time.time_ns()
    (s,) = tracing.stop()
    slack = 2_000_000       # the offset's error and the clocks' steps
    assert w0 - slack <= s.start_ns < s.end_ns <= w1 + slack
    assert s.end_ns - s.start_ns >= 2_000_000


def test_placement_spans_and_solve_s_from_the_solver_span():
    sc = make_scenario("edge-cloud", traffic="synthetic", seed=0,
                       device="cpu")
    sched = OnlineScheduler(sc.topology, extract_paths=True)
    rng = np.random.default_rng(0)
    arrivals = [sc.sample_jobs(rng, 1) for _ in range(3)]
    sched.submit_jobs(0.5, arrivals[0], pad_to=sc.max_layers)
    tracing.start()
    for i, jobs in enumerate(arrivals[1:]):
        sched.submit_jobs(1.0 + i, jobs, pad_to=sc.max_layers)
    got = tracing.stop()
    submits = [i for i, s in enumerate(got) if s.name == "online.submit"]
    assert len(submits) == 2
    for i, jobs in zip(submits, arrivals[1:]):
        kids = [s for s in got if s.parent == i]
        assert names(kids) == ["online.drain", "solvers.solve"]
        solve = got.index(kids[1])
        rounds = [s for s in got if s.parent == solve]
        assert names(rounds) == ["greedy.closures", "greedy.dp",
                                 "greedy.commit"]
        assert {s.rid for s in got if s.start_ns >= got[i].start_ns
                and s.end_ns <= got[i].end_ns} == {jobs[0].name}
    spans_s = [(s.end_ns - s.start_ns) / 1e9 for s in got
               if s.name == "solvers.solve"]
    assert spans_s == [r.solve_s for r in sched.trace.records[1:]]
    assert sched.last_plan.meta["solve_s"] == spans_s[-1]
    assert not hasattr(sched, "total_solve_s")


def test_solve_fused_solve_s_is_its_span():
    sc = make_scenario("edge-cloud", traffic="synthetic", seed=1,
                       device="cpu")
    rng = np.random.default_rng(1)
    batches = [J.batch_jobs(sc.sample_jobs(rng, 2), pad_to=sc.max_layers,
                            device="cpu") for _ in range(2)]
    tracing.start()
    plans = solvers.solve_fused(sc.topology, batches,
                                state=sc.topology.empty_state(),
                                pad_to=sc.max_layers)
    got = tracing.stop()
    (solve,) = [s for s in got if s.name == "solvers.solve"]
    assert plans[0].meta["solve_s"] == (solve.end_ns - solve.start_ns) / 1e9
    rounds = [s.name for s in got if s.name.startswith("greedy.")]
    assert rounds == ["greedy.closures", "greedy.dp", "greedy.commit"] * 4


def test_train_step_spans_carry_the_step_index():
    cfg = dataclasses.replace(registry.smoke_config("smollm_135m"),
                              dtype=torch.float32, attn_impl="xla")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    step = steps.make_train_step(cfg, device="cpu")
    opt_state = steps.default_optimizer(cfg).init(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step(params, opt_state, batch)
    tracing.start()
    step(params, opt_state, batch)
    got = tracing.stop()
    assert names(got) == ["steps.train", "steps.forward", "steps.backward",
                          "adamw.apply"]
    assert [s.parent for s in got] == [None, 0, 0, 0]
    assert {s.rid for s in got} == {1}
