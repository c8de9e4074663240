"""Open-loop placement of split-inference jobs by the port's online
scheduler (``serving.online.OnlineScheduler``, greedy Algorithm 1, fluid
drain), one job an arrival through ``submit_jobs``.

One Poisson sequence drives two clocks: the network's, at ``network_load``
times the nominal rate, and the wall's, at ``rate_per_s`` placements a
second.  Each arrival is timed from when it was due: its latency is the
time ``submit_jobs`` returned minus that instant, so a late generator
charges its wait to the request.  After the window the NumPy reference
replays every arrival and each placement, bound and backlog is compared
for equality.
"""
from __future__ import annotations

import time

import numpy as np

from bench import traffic
from bench.reference import router as ref

# the networks a mix may name: the program's builder in
# ``repro_torch.scenarios.topologies``, and the reference's copy of the
# same network (capacities at a scale, ingress and egress nodes)
TOPOLOGIES = {"us-backbone": ("us_backbone", ref.us_backbone,
                              ref.US_BACKBONE_INGRESS,
                              ref.US_BACKBONE_EGRESS)}


def topology(run) -> tuple:
    """The mix's network: (the program's builder's name, the reference's
    capacities per node and link, ingress, egress)."""
    name = run.mix["topology"]
    if name not in TOPOLOGIES:
        raise ValueError(f"unknown topology {name!r}; known: "
                         f"{sorted(TOPOLOGIES)}")
    builder, capacities, ingress, egress = TOPOLOGIES[name]
    return (builder, *capacities(run.mix["capacity_scale"]), ingress,
            egress)


def _jobs(run):
    cfg, mix = run.config, run.mix
    comp, data = ref.cost_profile(cfg, seq_len=mix["seq_len"],
                                  batch=mix["batch"])
    return comp.astype(np.float32), data.astype(np.float32)


def schedule(run, n: int) -> dict:
    """The run's arrivals: due instants on the wall (s from the window's
    start), instants on the network clock, and (src, dst) pairs."""
    mix = run.mix
    _, mu_node, mu_link, ingress, egress = topology(run)
    comp, data = _jobs(run)
    pairs = [(s, d) for s in ingress for d in egress]
    mean_s = ref.mean_service_s(mu_node, mu_link, comp, data, pairs)
    net_rate = ref.nominal_rate(mix["network_load"], mean_s)
    unit = np.cumsum(traffic.poisson_gaps(n, run.seed))
    return {"wall": unit / mix["rate_per_s"], "net": unit / net_rate,
            "pairs": traffic.balanced(pairs, n, run.seed),
            "comp": comp, "data": data, "mean_service_s": mean_s}


def setup(run):
    from repro_torch.core.jobs import InferenceJob
    from repro_torch.scenarios import topologies
    from repro_torch.serving.online import OnlineScheduler
    mix = run.mix
    n = int(round(mix["rate_per_s"] * run.seconds))
    sch = schedule(run, n)
    builder, _, _, want_in, want_out = topology(run)
    net, _, ingress, egress = getattr(topologies, builder)(
        run.seed, capacity_scale=mix["capacity_scale"], device=run.device)
    if (tuple(ingress), tuple(egress)) != (want_in, want_out):
        raise RuntimeError(f"the program's ingress/egress {ingress}/{egress} "
                           "are not the reference's")
    jobs = [InferenceJob(f"job{i}", s, d, sch["comp"], sch["data"])
            for i, (s, d) in enumerate(sch["pairs"])]

    def scheduler():
        return OnlineScheduler(net.topology, method=mix["method"],
                               drain=mix["drain"], extract_paths=True)

    # warm-up on a scheduler of its own: every (src, dst) pair once, at
    # the network clock's pace, so the kernels are built and loaded
    warm = scheduler()
    for i in range(mix["warmup_placements"]):
        s, d = sch["pairs"][i % len(sch["pairs"])]
        warm.submit_jobs(float(sch["net"][i]),
                         [InferenceJob(f"warm{i}", s, d, sch["comp"],
                                       sch["data"])], pad_to=mix["pad_to"])
    return {"sched": scheduler(), "jobs": jobs, "sch": sch, "n": n}


def measure(run, st) -> dict:
    sched, jobs, sch, n = st["sched"], st["jobs"], st["sch"], st["n"]
    pad_to = run.mix["pad_to"]
    lat = np.full(n, np.inf)
    late = np.zeros(n)
    placements: list = [None] * n
    failed = 0
    t0 = time.perf_counter()
    for i in range(n):
        due = t0 + sch["wall"][i]
        wait = due - time.perf_counter()
        if wait > 0:
            with run.span("wait"):
                time.sleep(wait)
        late[i] = time.perf_counter() - due
        try:
            with run.span("submit_jobs"):
                placements[i] = sched.submit_jobs(float(sch["net"][i]),
                                                  [jobs[i]], pad_to=pad_to)
        except Exception as exc:  # a placement that fails misses the tail
            failed += 1
            run.counters.setdefault("errors", []).append(repr(exc))
            continue
        lat[i] = time.perf_counter() - due
    st["placements"] = placements
    half = n // 2
    run.counters.update({
        "attempted": n, "failed": failed, "placements": n - failed,
        "solve_s": [r.solve_s for r in sched.trace.records],
        "lateness_ms": [float(np.median(late[:half]) * 1e3),
                        float(np.median(late[half:]) * 1e3),
                        float(late.max() * 1e3)]})
    finite = np.where(np.isfinite(lat), lat, time.perf_counter() - t0)
    return {"place_p95_ms": float(np.percentile(finite, 95) * 1e3)}


def replay(run, st, router) -> int:
    """Arrivals whose placement, bound or backlog differ from
    ``router``'s replay of the same arrivals (a placement that never came
    differs), plus one if the final queues differ."""
    sch, sched = st["sch"], st["sched"]
    records = {r.names[0]: r for r in sched.trace.records}
    bad = 0
    for i, placed in enumerate(st["placements"]):
        router.advance_to(float(sch["net"][i]))
        s, d = sch["pairs"][i]
        want = router.place(sch["comp"], sch["data"], s, d)
        if not placed:
            bad += 1
            continue
        p = placed[0]
        rec = records.get(p.job_name)
        got_paths = [list(map(tuple, hops)) for hops in p.plan.paths[p.job]]
        same = (np.array_equal(p.assign, want["assign"])
                and got_paths == want["paths"]
                and p.priority == want["priority"]
                and p.bound_s == want["bound"]
                and rec is not None
                and rec.backlog_before == want["backlog_before"]
                and rec.backlog_after == want["backlog_after"])
        bad += not same
    q_node = sched.state.q_node.cpu().numpy()
    q_link = sched.state.q_link.cpu().numpy()
    bad += not (np.array_equal(q_node, router.q_node)
                and np.array_equal(q_link, router.q_link))
    return bad


def gap(run, st, control: bool = False) -> int:
    """Arrivals placed otherwise than by the float32 reference: the
    program's, or (``control``) the bfloat16 reference's placements."""
    _, mu_node, mu_link, _, _ = topology(run)
    if not control:
        return replay(run, st, ref.Router(mu_node, mu_link))
    sch, bad = st["sch"], 0
    want = ref.Router(mu_node, mu_link)
    got = ref.Router(mu_node, mu_link, precision="bfloat16")
    for i, (s, d) in enumerate(sch["pairs"]):
        for r in (want, got):
            r.advance_to(float(sch["net"][i]))
        a, b = (r.place(sch["comp"], sch["data"], s, d) for r in (want, got))
        bad += not (np.array_equal(a["assign"], b["assign"])
                    and a["paths"] == b["paths"] and a["bound"] == b["bound"]
                    and a["backlog_after"] == b["backlog_after"])
    return bad


def check(run, st) -> None:
    bad = gap(run, st)
    run.check("placements_differing", bad, run.limits["placements_differing"])
    run.check("placements_failed", run.counters["failed"],
              run.limits["placements_failed"])
