"""The port on a CUDA card: the min-plus product and closure kernels
against their plain versions, the greedy solve on the card against the
same solve on the CPU, bit for bit (the §V instance, a window of each
catalog scenario, an online window, a migrate solve and a fused stream
window; SA on one draw tape, the exact solver and Lemma 8's bounds, with
their closure launches), the olmoe and deepseek-v2 smoke prefills against
the CPU port, the xLSTM, Zamba2, Whisper and phi-3-vision smoke models
(prefill, decode with states, engine tokens, whisper's served plan)
against the CPU port, a float32 train step of each non-dense smoke
config against the CPU port, ``grad_compress`` card == CPU bit for bit, a
bf16 step under ``remat_policy="dots"`` against "full", the fused AdamW
kernel against the optimizer's per-leaf PyTorch path, and the
flash-attention kernels (forward, dq, dk/dv, each on the CUDA cores and
the tensor cores, in bf16 at head widths 64, 128, 96 and 192 -> 128 on
the tensor cores; the tensor-core tile products alone) against their
plain versions.  Marked ``cuda``; each test skips without a card.
On a GPU machine:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import jobs as J, network as N, solvers  # noqa: E402
from repro_torch.kernels import minplus, ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _operand(rng, shape, device):
    x = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.25] = np.float32(1e30)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("sa,sb", [((62, 24, 24), (62, 24, 24)),
                                   ((1, 1), (1, 1)), ((5, 32, 7), (5, 7, 32)),
                                   ((2, 33, 65), (2, 65, 31)),
                                   ((3, 257, 129), (3, 129, 200))])
def test_kernel_matches_plain_on_card(cuda, sa, sb):
    rng = np.random.default_rng(sa[-1])
    a, b = _operand(rng, sa, cuda), _operand(rng, sb, cuda)
    n0 = minplus.launch_count()
    got = minplus.minplus_matmul_batched(a, b)
    torch.cuda.synchronize()
    assert minplus.launch_count() == n0 + 1
    assert torch.equal(got, ref.minplus_matmul_ref(a, b))


def test_closure_and_wrapper_checks_on_card(cuda):
    rng = np.random.default_rng(1)
    w = _operand(rng, (16, 24, 24), cuda)
    assert torch.equal(ops.minplus_closure(w), ref.minplus_closure_ref(w))
    with pytest.raises(ValueError):
        minplus.minplus_matmul_batched(w, w.cpu())
    with pytest.raises(ValueError):
        minplus.minplus_matmul_batched(w.transpose(1, 2), w)


@pytest.mark.parametrize("shape", [(64, 24, 24), (8, 32, 32), (5, 17, 17),
                                   (3, 1, 1), (24, 24), (2, 3, 9, 9)])
def test_closure_kernel_matches_plain_on_card(cuda, shape):
    """One launch of the closure kernel closes the whole stack, bit for bit
    the plain closure with closure_steps(V) squarings; negative diagonal
    entries (never a fixed point) show that the counts agree."""
    rng = np.random.default_rng(sum(shape))
    w = _operand(rng, shape, cuda)
    eye = torch.arange(shape[-1], device=cuda)
    w[..., eye, eye] = torch.from_numpy(rng.uniform(
        -2.0, 10.0, shape[:-1]).astype(np.float32)).to(cuda)
    steps = ops.closure_steps(shape[-1])
    minplus.reset_launch_count()
    got = ops.minplus_closure(w)
    direct = minplus.minplus_closure_batched(
        w.reshape(-1, shape[-1], shape[-1]))
    torch.cuda.synchronize()
    assert (minplus.launch_count("closure"),
            minplus.launch_count("product")) == (2, 0)
    want = ref.minplus_closure_ref(w, steps=steps)
    assert torch.equal(got, want)
    assert torch.equal(direct.view(shape), want)


def test_wide_closure_takes_the_product_loop_on_card(cuda):
    """V = 40 is past the closure kernel's 32: ops.minplus_closure squares
    with one product launch a step, and the closure wrapper raises."""
    w = _operand(np.random.default_rng(40), (2, 40, 40), cuda)
    minplus.reset_launch_count()
    got = ops.minplus_closure(w)
    torch.cuda.synchronize()
    assert (minplus.launch_count("closure"),
            minplus.launch_count("product")) == (0, ops.closure_steps(40))
    assert torch.equal(got, ref.minplus_closure_ref(
        w, steps=ops.closure_steps(40)))
    with pytest.raises(ValueError, match="V <= 32"):
        minplus.minplus_closure_batched(w)


def test_greedy_solve_closes_each_round_in_one_launch_on_card(cuda):
    """Ten jobs on the 24-node US backbone: one closure launch a greedy
    round, no product launch, and the same plan as on the CPU."""
    def solve(device):
        net, _ = N.us_backbone(capacity_scale=1e-4, device=device)
        jobs = [J.synthetic_job(f"s{i}", i, 23 - i, 4 + i, seed=i)
                for i in range(10)]
        return solvers.solve(net, J.batch_jobs(jobs, device=device),
                             method="greedy")

    minplus.reset_launch_count()
    gpu = solve(cuda)
    torch.cuda.synchronize()
    assert gpu.meta["kernel_launches"] == 10
    assert (minplus.launch_count("closure"),
            minplus.launch_count("product")) == (10, 0)
    cpu = solve("cpu")
    assert gpu.order.tolist() == cpu.order.tolist()
    assert gpu.bounds.tolist() == cpu.bounds.tolist()


def test_greedy_on_card_matches_cpu(cuda):
    def solve(device):
        net, _ = N.us_backbone(capacity_scale=1e-4, device=device)
        jobs = [J.synthetic_job(f"s{i}", i, 23 - i, 6 + i, seed=i)
                for i in range(5)]
        return solvers.solve(net, J.batch_jobs(jobs, device=device),
                             method="greedy", extract_paths=True)

    gpu, cpu = solve(cuda), solve("cpu")
    assert gpu.meta["kernel_launches"] > 0
    assert gpu.order.tolist() == cpu.order.tolist()
    assert gpu.bounds.tolist() == cpu.bounds.tolist()
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    assert torch.equal(gpu.net.q_link.cpu(), cpu.net.q_link)
    assert gpu.paths == cpu.paths


@pytest.mark.parametrize("family,opts", [
    ("paper-small", {}), ("us-backbone", {}), ("edge-cloud", {}),
    ("random-geometric", {}), ("star", {}),
    ("random-geometric", {"num_nodes": 48})])
def test_catalog_solve_on_card_matches_cpu(cuda, family, opts):
    """A window of the scenario catalog solved on the card, fresh and at
    the queued state a committed, exactly drained first window leaves:
    the CPU's plans and ledger bit for bit; V <= 32 closes each round in
    one closure launch, V = 48 through the loop of products."""
    from repro_torch.core import completions as C
    from repro_torch.scenarios import make_scenario

    def run(device):
        sc = make_scenario(family, 0, device=device, **opts)
        rng = np.random.default_rng(5)
        jobs1, jobs2 = sc.sample_jobs(rng, 4), sc.sample_jobs(rng, 4)
        b1, b2 = (J.batch_jobs(j, pad_to=sc.max_layers, device=device)
                  for j in (jobs1, jobs2))
        minplus.reset_launch_count()
        p1 = solvers.solve(sc.topology, b1, method="greedy",
                           state=sc.topology.empty_state(),
                           extract_paths=True)
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        led = C.CommittedWork.empty(sc.num_nodes).commit(
            b1, p1, names=[j.name for j in jobs1])
        led = C.drain_exact(sc.topology, led, 0.5 * p1.makespan_bound)
        p2 = solvers.solve(sc.topology, b2, method="greedy",
                           state=led.queue_state(device=device),
                           extract_paths=True)
        done, _ = C.run_to_completion(sc.topology, led.commit(
            b2, p2, names=[j.name for j in jobs2]))
        return sc.num_nodes, counts, (p1, p2), led, done

    v, counts, gpu, gled, gdone = run(cuda)
    torch.cuda.synchronize()
    _, _, cpu, cled, cdone = run("cpu")
    if v <= minplus.CLOSURE_MAX_V:
        assert counts == {"product": 0, "closure": 4}
    else:
        assert counts["closure"] == 0 and counts["product"] == \
            4 * minplus.closure_steps(v)
    for a, b in zip(gpu, cpu):
        assert a.order.tolist() == b.order.tolist()
        assert a.bounds.tolist() == b.bounds.tolist()
        np.testing.assert_array_equal(a.assign, b.assign)
        assert torch.equal(a.net.q_link.cpu(), b.net.q_link)
        assert a.paths == b.paths
    for x, y in zip(gled.queue_arrays(), cled.queue_arrays()):
        np.testing.assert_array_equal(x, y)
    assert gdone == cdone


def test_online_and_fused_stream_windows_on_card_match_cpu(cuda):
    """One exact online window and one fused stream window on the card:
    traces, plans and ledger completions equal the CPU's bit for bit; the
    online window's solve closes each round in one closure launch, and a
    migrate re-placement makes one closure launch a job."""
    import json
    from repro_torch.scenarios import make_scenario
    from repro_torch.serving.online import OnlineScheduler
    from repro_torch.serving.stream import run_stream

    def run(device):
        sc = make_scenario("edge-cloud", seed=0, device=device)
        sched = OnlineScheduler(sc.topology, drain="exact",
                                track_commits=True)
        jobs = sc.sample_jobs(np.random.default_rng(5), 4)
        minplus.reset_launch_count()
        sched.submit_jobs(0.0, jobs, pad_to=sc.max_layers)
        counts = {e: minplus.launch_count(e) for e in minplus.ENTRIES}
        migrate = solvers.solve(sc.topology, J.batch_jobs(
            jobs[:3], pad_to=sc.max_layers, device=device),
            method="migrate", state=sched.state)
        mig_counts = {e: minplus.launch_count(e) - counts[e]
                      for e in minplus.ENTRIES}
        online = (sched.finish(), sched.last_plan, migrate)
        rate = sc.nominal_rate(1.5)
        tr = run_stream(make_scenario("paper-small", seed=0, device=device),
                        horizon=8 / rate, seed=4, rate=rate,
                        window_s=0.5 / rate, max_batch=8, fuse_windows=4,
                        solver_latency=4 / rate, drain="exact", finish=True)
        blob = json.loads(json.dumps(tr.to_dict()))
        for w in blob["window_records"]:
            w.pop("solve_wall_s")
        return counts, mig_counts, online, blob

    counts, mig_counts, gpu, gblob = run(cuda)
    torch.cuda.synchronize()
    _, _, cpu, cblob = run("cpu")
    assert counts == {"product": 0, "closure": 4}
    assert mig_counts == {"product": 0, "closure": 3}
    assert gpu[0] == cpu[0]
    for a, b in zip(gpu[1:], cpu[1:]):
        assert a.bounds.tolist() == b.bounds.tolist()
        np.testing.assert_array_equal(a.assign, b.assign)
        assert torch.equal(a.net.q_node.cpu(), b.net.q_node)
    assert gblob == cblob and gblob["windows"] > 0


# -- flash attention ----------------------------------------------------------

# O as (atol, rtol): float32 as tests/test_kernels.py; bf16 within 4e-3 +
# 1.6e-2 |want| (the output's bf16 rounding, up to two ulps, and the
# tensor-core forward's bf16 P, whose rounding moves a row of few keys by up
# to 2^-8 sum(p |v|) / l: test_torch_flash.py:rounded_p_forward_gate_share)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 1.6e-2)}


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _close(got, want, tol, rtol=None):
    rtol = tol if rtol is None else rtol
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + rtol * want.abs()).all(), \
        float((got - want).abs().max())


@pytest.mark.parametrize("bh,s,d,dv,dtype,causal", [
    (36, 2048, 64, 64, torch.bfloat16, True),
    (8, 256, 64, 64, torch.float32, True),
    (2, 256, 192, 128, torch.float32, True),
    (4, 1000, 64, 64, torch.bfloat16, True),
    (3, 130, 64, 64, torch.float32, True),
    (2, 64, 64, 64, torch.float32, True),
    (1, 1, 16, 16, torch.float32, True),
    (2, 300, 64, 32, torch.float32, False),
    (1, 200, 256, 256, torch.bfloat16, True)])
def test_flash_kernel_matches_plain_on_card(cuda, no_tf32, bh, s, d, dv,
                                            dtype, causal):
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k = (torch.randn(bh, s, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    v = torch.randn(bh, s, dv, device=cuda, generator=g).to(dtype)
    scale = d ** -0.5
    n0 = flash.launch_count()
    o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=causal)
    o2 = flash.flash_attention_bhsd(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert flash.launch_count() == n0 + 1
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale,
                                             causal=causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    _close(o, want_o, *FLASH_TOL[dtype])
    _close(o2, want_o, *FLASH_TOL[dtype])
    _close(lse, want_lse, 1e-5)


def test_flash_launches_once_per_layer_per_prefill(cuda, no_tf32):
    """A flash prefill of the smoke config on the card: one kernel launch
    per layer, logits within 3e-4 of the XLA-style path (float32)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M

    cfg = dataclasses.replace(registry.smoke_config("smollm_135m"),
                              dtype=torch.float32, attn_impl="flash")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256))
    flash.reset_launch_count()
    got = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert flash.launch_count() == cfg.num_layers
    want = steps.make_prefill_step(dataclasses.replace(cfg, attn_impl="xla"))(
        params, {"tokens": toks})
    _close(got, want, 3e-4)
    with pytest.raises(ValueError):
        flash.flash_fwd_lse(got[:1], got[:1], got.cpu()[:1], scale=1.0)


# (bh, S, d, dv, dtype, causal): the training shape, d = dv and d != dv
# (192 -> 128, the MLA widths), the widest head, ragged and short lengths,
# bf16 at head widths 96 and 192 -> 128
BWD_CASES = [(36, 2048, 64, 64, torch.bfloat16, True),
             (4, 256, 64, 64, torch.float32, True),
             (2, 256, 192, 128, torch.float32, True),
             (1, 200, 256, 256, torch.float32, True),
             (2, 130, 32, 48, torch.float32, True),
             (3, 1000, 64, 64, torch.bfloat16, True),
             (1, 1, 16, 16, torch.float32, True),
             (2, 300, 64, 32, torch.float32, False),
             # bf16 at phi-3-vision's 96 and MLA's 192 -> 128 (the
             # tensor-core kernels): the train paths' shapes, and ragged
             (32, 2624, 96, 96, torch.bfloat16, True),
             (128, 2048, 192, 128, torch.bfloat16, True),
             (4, 1000, 96, 96, torch.bfloat16, True),
             (4, 1000, 192, 128, torch.bfloat16, True),
             # olmoe-1b-7b's train step at B=4 (the tensor-core kernels)
             (64, 2048, 128, 128, torch.bfloat16, True)]
# gradients as (atol, rtol): float32 within 1e-4 + 1e-4 |want| (sums over
# up to S terms in another order); bf16 within 1e-3 + 8e-3 |want| (at most
# one bf16 rounding of the float32 result apart: one ulp <= 2^-7 |want|)
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 8e-3)}


@pytest.mark.parametrize("bh,s,d,dv,dtype,causal", BWD_CASES)
def test_flash_bwd_kernels_match_plain_on_card(cuda, no_tf32, bh, s, d, dv,
                                               dtype, causal):
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(s + d + dv)
    q, k = (torch.randn(bh, s, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    v, do = (torch.randn(bh, s, dv, device=cuda, generator=g).to(dtype)
             for _ in range(2))
    scale = d ** -0.5
    o, lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale, causal=causal)
    flash.reset_launch_count()
    got = flash.flash_bwd(q, k, v, o, lse, do, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert (flash.launch_count("flash_bwd_dq"),
            flash.launch_count("flash_bwd_dkv")) == (1, 1)
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, scale=scale, causal=causal)
    for a, b, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert a.dtype == dtype and a.shape == shape
        _close(a, b, *BWD_TOL[dtype])


@pytest.mark.parametrize("s", [2048, 1000, 130, 64, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_sm90_kernels_match_plain_on_card(cuda, no_tf32, d, causal, s):
    """The tensor-core forward (both entries), dq and dk/dv at bf16, d = dv
    in {64, 128}, against their plain versions at the bf16 gates, and the
    launches counted against the "sm90" variant."""
    from repro_torch.kernels import flash
    bh = 4 if s == 2048 else 3
    g = torch.Generator(device=cuda).manual_seed(s + d + causal)
    q, k, v, do = (torch.randn(bh, s, d, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    kw = dict(scale=d ** -0.5, causal=causal)
    flash.reset_launch_count()
    o, lse = flash.flash_fwd_lse(q, k, v, **kw)
    o2 = flash.flash_attention_bhsd(q, k, v, **kw)
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(want_o, do)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    dq = flash.flash_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_dk, want_dv = ref.flash_bwd_dkv_ref(q, k, v, do, want_lse, delta,
                                             **kw)
    want_dq = ref.flash_bwd_dq_ref(q, k, v, do, want_lse, delta, **kw)
    assert o.dtype == dk.dtype == dv.dtype == dq.dtype == torch.bfloat16
    _close(o, want_o, *FLASH_TOL[torch.bfloat16])
    _close(o2, want_o, *FLASH_TOL[torch.bfloat16])
    _close(lse, want_lse, 1e-5)
    _close(dk, want_dk, *BWD_TOL[torch.bfloat16])
    _close(dv, want_dv, *BWD_TOL[torch.bfloat16])
    _close(dq, want_dq, *BWD_TOL[torch.bfloat16])
    for entry in flash.ENTRIES:
        assert (flash.launch_count(entry, "sm90"),
                flash.launch_count(entry, "simt")) == (1, 0)


@pytest.mark.parametrize("s", [2048, 1000, 130, 64, 1])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dv", [(96, 96), (192, 128)])
def test_sm90_forward_and_dkv_at_the_new_widths_on_card(cuda, no_tf32, d, dv,
                                                        causal, s):
    """bf16 at phi-3-vision's (96, 96) and MLA's (192, 128): the
    tensor-core forward (both entries), dq and dk/dv against their plain
    versions at the unchanged bf16 gates, with the launches counted per
    variant."""
    from repro_torch.kernels import flash
    bh = 4 if s == 2048 else 3
    g = torch.Generator(device=cuda).manual_seed(s + d + dv + causal)
    q, k = (torch.randn(bh, s, d, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    v, do = (torch.randn(bh, s, dv, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=causal)
    flash.reset_launch_count()
    o, lse = flash.flash_fwd_lse(q, k, v, **kw)
    o2 = flash.flash_attention_bhsd(q, k, v, **kw)
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(want_o, do)
    dk, dv_ = flash.flash_bwd_dkv(q, k, v, do, want_lse, delta, **kw)
    dq = flash.flash_bwd_dq(q, k, v, do, want_lse, delta, **kw)
    torch.cuda.synchronize()
    want_dk, want_dv = ref.flash_bwd_dkv_ref(q, k, v, do, want_lse, delta,
                                             **kw)
    want_dq = ref.flash_bwd_dq_ref(q, k, v, do, want_lse, delta, **kw)
    assert o.shape == (bh, s, dv) and dk.shape == (bh, s, d) \
        and dv_.shape == (bh, s, dv)
    _close(o, want_o, *FLASH_TOL[torch.bfloat16])
    _close(o2, want_o, *FLASH_TOL[torch.bfloat16])
    _close(lse, want_lse, 1e-5)
    _close(dk, want_dk, *BWD_TOL[torch.bfloat16])
    _close(dv_, want_dv, *BWD_TOL[torch.bfloat16])
    _close(dq, want_dq, *BWD_TOL[torch.bfloat16])
    for entry in flash.ENTRIES:
        assert (flash.launch_count(entry, "sm90"),
                flash.launch_count(entry, "simt")) == (1, 0), entry


@pytest.mark.parametrize("d,dv", [(96, 96), (192, 128)])
def test_sm90_and_simt_dq_at_the_new_widths_on_card(cuda, no_tf32, d, dv):
    """At [4, 1000, 96] and [4, 1000, 192 -> 128] bf16 causal, the
    tensor-core dq (the rule's) and the CUDA-core dq forced at the same
    inputs both hold the unchanged bf16 gate against the plain version,
    one launch of each variant."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(1000 + d + dv)
    q, k = (torch.randn(4, 1000, d, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    v, do = (torch.randn(4, 1000, dv, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    kw = dict(scale=d ** -0.5, causal=True)
    o, lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(o, do)
    want = ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw)
    flash.reset_launch_count()
    got = {"sm90": flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           "simt": torch.empty_like(q)}
    flash._launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta,
                      (got["simt"],), kw["scale"], True, "simt")
    torch.cuda.synchronize()
    for variant, dq in got.items():
        assert flash.launch_count("flash_bwd_dq", variant) == 1, variant
        assert dq.shape == q.shape and dq.dtype == torch.bfloat16
        _close(dq, want, *BWD_TOL[torch.bfloat16])


def test_sm90_dq_is_deterministic_at_192_to_128_on_card(cuda):
    """One block owns its query rows and nothing is added with atomics:
    two launches of the tensor-core dq at [8, 1000, 192 -> 128] bf16 give
    the same bits."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(8)
    q, k = (torch.randn(8, 1000, 192, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    v, do = (torch.randn(8, 1000, 128, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    kw = dict(scale=192 ** -0.5, causal=True)
    o, lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(o, do)
    flash.reset_launch_count()
    a = flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    b = flash.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert flash.launch_count("flash_bwd_dq", "sm90") == 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("d,n", [(64, 64), (128, 128), (96, 96),
                                 (192, 128), (192, 192)])
def test_sm90_tile_products_match_matmul_on_card(cuda, no_tf32, d, n):
    """The tensor-core kernels' tile products alone: S = A B^T as an SS
    wgmma of K-depth d (both K-major, TMA-loaded with 128-byte swizzle)
    against torch.matmul, and bf16(S) C as an RS wgmma of N = n with C
    read MN-major; at 96 and 192 as well as 64 and 128 (a 96-column tile
    is two 64-column blocks, the second half zeros).
    Exact products summed in float32: within float32 rounding."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(d + n)
    a, b = (torch.randn(64, d, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    c = torch.randn(64, n, device=cuda, generator=g).bfloat16()
    s_out, o_out = flash.sm90_tile_probe(a, b, c)
    torch.cuda.synchronize()
    _close(s_out, torch.matmul(a.float(), b.float().T), 1e-4, 1e-5)
    _close(o_out, torch.matmul(s_out.bfloat16().float(), c.float()), 1e-4,
           1e-5)


def test_flash_bwd_is_deterministic_on_card(cuda):
    """No atomics: the gradients are the same bits on every run, through
    the tensor-core dq and dk/dv kernels at bf16 (64, 64), (128, 128),
    (96, 96) and (192, 128), and the CUDA-core ones at float32."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(0)
    for d, dv, dtype, dkv, dq in ((64, 64, torch.bfloat16, "sm90", "sm90"),
                                  (128, 128, torch.bfloat16, "sm90", "sm90"),
                                  (96, 96, torch.bfloat16, "sm90", "sm90"),
                                  (192, 128, torch.bfloat16, "sm90", "sm90"),
                                  (64, 64, torch.float32, "simt", "simt")):
        q, k = (torch.randn(4, 512, d, device=cuda, generator=g).to(dtype)
                for _ in range(2))
        v, do = (torch.randn(4, 512, dv, device=cuda, generator=g).to(dtype)
                 for _ in range(2))
        o, lse = flash.flash_fwd_lse(q, k, v, scale=0.125)
        flash.reset_launch_count()
        a = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
        b = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
        assert flash.launch_count("flash_bwd_dkv", dkv) == 2
        assert flash.launch_count("flash_bwd_dq", dq) == 2
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_train_step_launches_the_flash_kernels(cuda, no_tf32):
    """One float32 train step of the smoke config with remat on the card:
    per layer two forward launches (forward and recompute) and one launch
    of each backward kernel; loss and params within the CPU step's."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(registry.smoke_config("smollm_135m"),
                              dtype=torch.float32, attn_impl="flash",
                              remat=True)
    opt = AdamW(schedule=lambda s: 1e-3)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        flash.reset_launch_count()
        loss, params, _ = steps.make_train_step(cfg, opt, device=dev)(
            params, opt.init(params),
            SyntheticStream(data, device=dev).batch_at(0))
        out[dev.type] = (loss, params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert flash.launch_count() == 2 * cfg.num_layers
            assert flash.launch_count("flash_bwd_dq") == cfg.num_layers
            assert flash.launch_count("flash_bwd_dkv") == cfg.num_layers
            assert flash.launch_count("flash_fwd_lse", "simt") == \
                2 * cfg.num_layers     # float32 takes the CUDA-core kernels
    _close(out["cuda"][0].cpu(), out["cpu"][0], 1e-5)
    for (key, a), (_, b) in zip(pytree.items(out["cuda"][1]),
                                pytree.items(out["cpu"][1])):
        _close(a.cpu(), b, 2e-5)


def test_bf16_train_step_launches_the_tensor_core_kernels(cuda):
    """One bf16 train step with remat at head_dim 64 on the card: per layer
    two forward launches, one dq and one dk/dv launch of the tensor-core
    ("sm90") kernels, none of the CUDA-core ones; the loss is finite."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(registry.smoke_config("smollm_135m"),
                              d_model=128, num_heads=2, num_kv_heads=1,
                              head_dim=64, dtype=torch.bfloat16,
                              attn_impl="flash", remat=True)
    opt = AdamW(schedule=lambda s: 1e-3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                       global_batch=2),
                            device=cuda).batch_at(0)
    flash.reset_launch_count()
    loss, _, _ = steps.make_train_step(cfg, opt, device=cuda)(
        params, opt.init(params), batch)
    torch.cuda.synchronize()
    n = cfg.num_layers
    got = {(e, v): flash.launch_count(e, v) for e in flash.ENTRIES
           for v in flash.VARIANTS}
    assert got == {("flash_fwd_lse", "sm90"): 2 * n,
                   ("flash_fwd_lse", "simt"): 0,
                   ("flash_attention_bhsd", "sm90"): 0,
                   ("flash_attention_bhsd", "simt"): 0,
                   ("flash_bwd_dq", "sm90"): n,
                   ("flash_bwd_dq", "simt"): 0,
                   ("flash_bwd_dkv", "sm90"): n,
                   ("flash_bwd_dkv", "simt"): 0}
    assert torch.isfinite(loss)


# -- Algorithm 2, the exact oracles and the MoE / MLA models on the card -----

def _paper_small(device, n=8):
    """The quickstart instance: the 5-node topology at capacity scale 1e-3
    and the first ``n`` of 2 VGG19 + 6 ResNet34 drawn from
    default_rng(0)."""
    from repro_torch.configs import registry
    net, _ = N.small_topology(capacity_scale=1e-3, device=device)
    rng = np.random.default_rng(0)
    jobs = []
    for i, kind in enumerate(["vgg19"] * 2 + ["resnet34"] * 6):
        s, d = rng.choice(5, 2, replace=False)
        jobs.append(registry.get(kind).make_job(f"{kind}-{i}", int(s),
                                                int(d)))
    return net, J.batch_jobs(jobs[:n], device=device)


@pytest.mark.parametrize("init", ["random", "greedy"])
def test_sa_on_card_matches_cpu(cuda, init):
    """SA on one draw tape, card against CPU bit for bit; one closure
    launch a job per evaluation and per replayed job (and per greedy round
    of the warm start), no product."""
    from repro_torch.core import annealing
    opts = dict(d=0.8, num_chains=2, init=init, block_move_prob=0.3)
    net, batch = _paper_small(cuda)
    iters = annealing._num_iters(1.0, 1e-3, opts["d"])
    tape = annealing.draw_tape(batch.num_layers.cpu().numpy(), 5,
                               batch.max_layers, seed=3, num_chains=2,
                               iters=iters)
    minplus.reset_launch_count()
    gpu = solvers.solve(net, batch, method="sa", tape=tape, **opts)
    torch.cuda.synchronize()
    n = batch.num_jobs
    want = 2 * (iters + 1) * n + n + (n if init == "greedy" else 0)
    assert (minplus.launch_count("closure"),
            minplus.launch_count("product")) == (want, 0)
    cpu = solvers.solve(*_paper_small("cpu"), method="sa", tape=tape,
                        **opts)
    assert gpu.order.tolist() == cpu.order.tolist()
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    assert gpu.bounds.tolist() == cpu.bounds.tolist()
    assert gpu.meta["history"].tolist() == cpu.meta["history"].tolist()
    assert gpu.paths == cpu.paths
    assert torch.equal(gpu.net.q_link.cpu(), cpu.net.q_link)


def test_exact_and_bounds_on_card_match_cpu(cuda):
    """The exact solver (one closure launch a routing) and Lemma 8's bounds
    (one launch for the batch) on the card, equal to the CPU's."""
    from repro_torch.core import bounds
    minplus.reset_launch_count()
    gpu = solvers.solve(*_paper_small(cuda, 4), method="exact")
    torch.cuda.synchronize()
    assert (minplus.launch_count("closure"),
            minplus.launch_count("product")) == (gpu.meta["n_routings"], 0)
    cpu = solvers.solve(*_paper_small("cpu", 4), method="exact")
    assert gpu.order.tolist() == cpu.order.tolist()
    np.testing.assert_array_equal(gpu.assign, cpu.assign)
    assert gpu.bounds.tolist() == cpu.bounds.tolist()
    minplus.reset_launch_count()
    got = bounds.service_lower_bounds(*_paper_small(cuda))
    torch.cuda.synchronize()
    assert minplus.launch_count("closure") == 1
    want = bounds.service_lower_bounds(*_paper_small("cpu"))
    assert got[0].tolist() == want[0].tolist() and got[1] == want[1]


@pytest.mark.parametrize("attn_impl,s", [("xla", 16), ("flash", 256)])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
def test_moe_mla_smoke_prefill_on_card_matches_cpu(cuda, no_tf32, arch,
                                                   attn_impl, s):
    """The olmoe and deepseek-v2 smoke models (float32) on the card against
    the CPU port on the same weights, at float32's 2e-4; the flash prefill
    launches the CUDA-core forward once a layer (head widths 16, and 24 ->
    16 for MLA)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.pytree import tree_map

    cfg = dataclasses.replace(registry.smoke_config(arch),
                              dtype=torch.float32, attn_impl=attn_impl)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, s))
    flash.reset_launch_count()
    got = steps.make_prefill_step(cfg)(
        tree_map(lambda x: x.to(cuda), params), {"tokens": toks})
    torch.cuda.synchronize()
    assert flash.launch_count("flash_fwd_lse", "simt") == (
        cfg.num_layers if attn_impl == "flash" else 0)
    assert flash.launch_count("flash_fwd_lse", "sm90") == 0
    want = steps.make_prefill_step(cfg, device="cpu")(params,
                                                      {"tokens": toks})
    _close(got.cpu(), want, 2e-4)


FAMILY_ARCHS = ["xlstm_125m", "zamba2_2_7b", "whisper_base",
                "phi3_vision_4_2b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_model_on_card_matches_cpu(cuda, no_tf32, arch):
    """The xLSTM, Zamba2, Whisper and phi-3-vision smoke models (float32,
    attn_impl="flash") on the card against the CPU port on the same
    weights at float32's 2e-4: the prefill (phi-3-vision with its 8
    patches and 120 tokens, so P + S = 128 takes the CUDA-core forward
    once a layer at head width 16; the others launch no flash kernel),
    four decode steps with the state or cache after each, and the decode
    engine's tokens."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import encdec
    from repro_torch.models import model as M
    from repro_torch.pytree import items, tree_map
    from repro_torch.serving.engine import DecodeEngine

    cfg = dataclasses.replace(registry.smoke_config(arch),
                              dtype=torch.float32, attn_impl="flash")
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    dparams = tree_map(lambda x: x.to(cuda), params)
    rng = np.random.default_rng(1)
    s = 120 if cfg.family == "vlm" else 16
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, s))}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, cfg.num_frames, cfg.d_model)).astype(np.float32)
    flash.reset_launch_count()
    got = steps.make_prefill_step(cfg)(dparams, batch)
    torch.cuda.synchronize()
    assert flash.launch_count("flash_fwd_lse", "simt") == (
        cfg.num_layers if cfg.family == "vlm" else 0)
    assert flash.launch_count("flash_fwd_lse", "sm90") == 0
    want = steps.make_prefill_step(cfg, device="cpu")(params, batch)
    _close(got.cpu(), want, 2e-4)

    extra = {}
    if cfg.family == "encdec":
        with torch.no_grad():
            extra["enc_out"] = encdec.encode(
                cfg, params, torch.from_numpy(batch["frames"]))
    dextra = {k: v.to(cuda) for k, v in extra.items()}
    caches = (M.init_cache(cfg, 2, 8, device=cuda),
              M.init_cache(cfg, 2, 8, device="cpu"))
    step_card = steps.make_serve_step(cfg)
    step_cpu = steps.make_serve_step(cfg, device="cpu")
    for i in range(4):
        tok = batch["tokens"][:, i:i + 1]
        a, _ = step_card(dparams, caches[0], {"tokens": tok, "pos": i,
                                              **dextra})
        b, _ = step_cpu(params, caches[1], {"tokens": tok, "pos": i,
                                            **extra})
        _close(a.cpu(), b, 2e-4)
        cpu_state = dict(items(caches[1]))
        for key, leaf in items(caches[0]):
            _close(leaf.cpu(), cpu_state[key], 2e-4)
    prompts = batch["tokens"][:, :5]
    a = DecodeEngine(cfg, dparams, max_len=16).generate(
        prompts, 6, extra_batch=dextra)
    b = DecodeEngine(cfg, params, max_len=16, device="cpu").generate(
        prompts, 6, extra_batch=extra)
    assert np.array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_at_head_width_96_on_card(cuda, no_tf32, dtype):
    """phi-3-vision's head width (96) takes the tensor-core forward in bf16
    and the CUDA-core one in float32; against its plain version at a
    ragged causal length."""
    from repro_torch.kernels import flash
    variant = "sm90" if dtype == torch.bfloat16 else "simt"
    assert flash.kernel_variant("flash_fwd_lse", dtype, 96, 96) == variant
    g = torch.Generator(device=cuda).manual_seed(96)
    q, k, v = (torch.randn(4, 656, 96, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    flash.reset_launch_count()
    o, lse = flash.flash_fwd_lse(q, k, v, scale=96 ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert flash.launch_count("flash_fwd_lse", variant) == 1
    assert flash.launch_count("flash_fwd_lse") == 1
    want_o, want_lse = ref.flash_fwd_lse_ref(q, k, v, scale=96 ** -0.5,
                                             causal=True)
    _close(o, want_o, *FLASH_TOL[dtype])
    _close(lse, want_lse, 1e-5)


def test_whisper_serve_plan_on_card_matches_cpu(cuda):
    """``launch/serve.run("whisper_base")`` on the card: the routed plan
    through the min-plus kernel equals the CPU port's, and the engine
    decodes against the encoder's output."""
    from repro_torch.launch import serve
    minplus.reset_launch_count()
    _, plans, res = serve.run("whisper_base", requests=2, gen=4,
                              device=cuda, verbose=False)
    torch.cuda.synchronize()
    assert minplus.launch_count() > 0
    _, cpu_plans, cpu_res = serve.run("whisper_base", requests=2, gen=4,
                                      device="cpu", verbose=False)
    assert [(p.priority, p.bound_s, p.nodes_used) for p in plans] == \
        [(p.priority, p.bound_s, p.nodes_used) for p in cpu_plans]
    assert res.tokens.shape == cpu_res.tokens.shape == (2, 4)


# -- every family's train step, grad_compress and remat "dots" on the card ---

TRAIN_ARCHS = ["olmoe_1b_7b", "deepseek_v2_236b", "phi3_vision_4_2b",
               "zamba2_2_7b", "xlstm_125m", "whisper_base"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_smoke_train_step_on_card_matches_cpu(cuda, no_tf32, arch):
    """One float32 ``make_train_step`` step of each non-dense smoke config
    (attn_impl="flash", remat) on the card against the CPU port on the
    same weights and batch: the loss at 1e-5, every new param at 2e-5
    (test_train_step_launches_the_flash_kernels' gates); per layer two
    CUDA-core forwards, one dq and one dk/dv where the family takes flash
    (S = 128 tokens, plus phi-3-vision's 8 patches), none elsewhere."""
    import dataclasses
    from repro_torch import pytree
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(registry.smoke_config(arch),
                              dtype=torch.float32, attn_impl="flash",
                              remat=True)
    opt = AdamW(schedule=lambda s: 1e-3)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=2)
    extra = np.random.default_rng(2).standard_normal(
        (2, cfg.num_patches + cfg.num_frames, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)
        batch = SyntheticStream(data, device=dev).batch_at(0)
        if cfg.family in ("vlm", "encdec"):
            batch["patches" if cfg.family == "vlm" else "frames"] = \
                torch.from_numpy(extra).to(dev)
        flash.reset_launch_count()
        loss, params, _ = steps.make_train_step(cfg, opt, device=dev)(
            params, opt.init(params), batch)
        out[dev.type] = (loss, params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = cfg.num_layers if cfg.family in ("moe", "vlm") else 0
            assert {(e, v): flash.launch_count(e, v) for e in flash.ENTRIES
                    for v in flash.VARIANTS if flash.launch_count(e, v)} == (
                {("flash_fwd_lse", "simt"): 2 * n,
                 ("flash_bwd_dq", "simt"): n,
                 ("flash_bwd_dkv", "simt"): n} if n else {})
    _close(out["cuda"][0].cpu(), out["cpu"][0], 1e-5)
    for (key, a), (_, b) in zip(pytree.items(out["cuda"][1]),
                                pytree.items(out["cpu"][1])):
        _close(a.cpu(), b, 2e-5)


def test_grad_compress_on_card_matches_cpu(cuda):
    """``Int8Compressor`` (two steps of error feedback: codes, scales,
    residuals, decompressed values) and ``topk_mask`` on a tree of bf16
    and float32 leaves, with a zero leaf and ties: card == CPU bit for bit
    (every operation is one IEEE-rounded float32 operation; the divisions
    are true divisions by a device tensor)."""
    from repro_torch import pytree
    from repro_torch.optim.grad_compress import Int8Compressor, topk_mask

    def tree(step):
        r = np.random.default_rng(step)
        return {"w": torch.from_numpy(r.standard_normal((64, 96)).astype(
                    np.float32) * 1e-3).to(torch.bfloat16),
                "b": {"x": torch.from_numpy(r.standard_normal(1000).astype(
                          np.float32)),
                      "zero": torch.zeros(7, 5)},
                "ties": torch.from_numpy(r.choice(
                    np.float32([-1.0, 0.5, 1.0]), (33,)))}

    comp = Int8Compressor()
    got = {}
    for dev in (cuda, torch.device("cpu")):
        state, seen = None, []
        for step in range(2):
            g = pytree.tree_map(lambda x: x.to(dev), tree(step))
            state = comp.init(g) if state is None else state
            codes, state = comp.compress(g, state)
            seen += [x for qs in pytree.leaves(codes) for x in qs]
            seen += pytree.leaves(state) + pytree.leaves(
                comp.decompress(codes))
            seen += [topk_mask(x, f) for x in pytree.leaves(g)
                     for f in (0.01, 0.3)]
        got[dev.type] = [x.cpu() for x in seen]
    assert len(got["cuda"]) == len(got["cpu"])
    for a, b in zip(got["cuda"], got["cpu"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remat_policy_dots_on_card(cuda):
    """A bf16 train step under ``remat_policy="dots"`` at head_dim 64: the
    loss and the tensor-core launches equal the "full" step's."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import flash
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW

    cfg = dataclasses.replace(registry.smoke_config("smollm_135m"),
                              d_model=128, num_heads=2, num_kv_heads=1,
                              head_dim=64, dtype=torch.bfloat16,
                              attn_impl="flash", remat=True)
    opt = AdamW(schedule=lambda s: 1e-3)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    batch = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                       global_batch=2),
                            device=cuda).batch_at(0)
    res = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        flash.reset_launch_count()
        loss, _, _ = steps.make_train_step(c, opt, device=cuda)(
            params, opt.init(params), batch)
        torch.cuda.synchronize()
        res[policy] = (float(loss), {(e, v): flash.launch_count(e, v)
                                     for e in flash.ENTRIES
                                     for v in flash.VARIANTS})
    assert res["dots"] == res["full"]
    n = cfg.num_layers
    assert res["dots"][1][("flash_fwd_lse", "sm90")] == 2 * n
    assert res["dots"][1][("flash_bwd_dq", "sm90")] == n


# -- the fused AdamW (kernels/adamw.py) against its per-leaf plain version ---

ADAMW_SIZES = (1, 7, 2049, 1_000_003)


def _adamw_tree(device, dtype, sizes=ADAMW_SIZES, seed=0):
    """params, grads and an AdamW state of one leaf a size: params ~N(0, 1),
    grads ~N(0, 1e-4) (a norm of ~10 over the four sizes), m ~N(0, 1e-6),
    v the square of one more such draw."""
    rng = np.random.default_rng(seed)

    def draw(scale):
        return {f"l{i}": torch.from_numpy(
                    (rng.standard_normal(n) * scale).astype(np.float32)
                ).to(device) for i, n in enumerate(sizes)}

    params = {k: x.to(dtype) for k, x in draw(1.0).items()}
    grads = {k: x.to(dtype) for k, x in draw(1e-2).items()}
    state = {"m": draw(1e-3), "v": {k: x.square() for k, x in
                                    draw(1e-3).items()},
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return params, grads, state


def _adamw_reference(opt, params, grads, state, gnorm):
    """The per-leaf path's new (ps, ms, vs) at the clip scale of ``gnorm``."""
    from repro_torch.pytree import leaves
    step = state["step"] + 1
    t = step.float()
    return opt._per_leaf(
        *(leaves(x) for x in (params, grads, state["m"], state["v"])),
        opt._clip_scale(gnorm), opt.schedule(step), 1 - opt.b1 ** t,
        1 - opt.b2 ** t)


def _adamw_outputs(result):
    from repro_torch.pytree import leaves
    new_p, new_state, info = result
    return (leaves(new_p), leaves(new_state["m"]), leaves(new_state["v"]),
            [info["grad_norm"]])


@pytest.mark.parametrize("clip", ["on", "off"])
@pytest.mark.parametrize("step", [1, 2000])
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_adamw_matches_per_leaf_on_card(cuda, dtype, lr_kind, step,
                                              clip):
    """One apply of the fused AdamW over leaves of 1, 7, 2,049 and 1,000,003
    elements: one fused apply, one sumsq and one update launch a leaf and
    one finalize, no host sync; the global norm within 1e-5 of the per-leaf
    path's; the kernel's clip scale equal to the per-leaf expression's at
    that norm, and p, m and v bit-equal to the per-leaf path's given it;
    the inputs unchanged; a second call equal to the first bit for bit."""
    import functools
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim import schedules
    from repro_torch.optim.adamw import AdamW
    from repro_torch.pytree import leaves

    sched = (lambda s: 3e-4) if lr_kind == "float" else functools.partial(
        schedules.warmup_cosine, peak_lr=3e-4, warmup_steps=2000,
        total_steps=100_000)
    opt = AdamW(schedule=sched, clip_norm=1.0 if clip == "on" else 1e3)
    params, grads, state = _adamw_tree(cuda, dtype)
    state["step"].fill_(step - 1)
    inputs = [x for tree in (params, grads, state["m"], state["v"])
              for x in leaves(tree)]
    before = [x.clone() for x in inputs]
    torch.cuda.synchronize()
    kadamw.reset_launch_count()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = opt.apply(params, grads, state)
        counts = {e: kadamw.launch_count(e) for e in kadamw.ENTRIES}
        paths = {p: kadamw.apply_count(p) for p in kadamw.PATHS}
        second = opt.apply(params, grads, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = len(ADAMW_SIZES)
    assert paths == {"fused": 1, "per_leaf": 0}
    assert counts == {"sumsq": n, "finalize": 1, "update": n}
    assert all(torch.equal(a, b) for a, b in zip(inputs, before))
    for a, b in zip(_adamw_outputs(first), _adamw_outputs(second)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    gnorm = first[2]["grad_norm"]
    want_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
    assert abs(float(gnorm) - float(want_norm)) <= 1e-5 * float(want_norm)
    norm, scale = kadamw.global_norm(leaves(grads), opt.clip_norm)
    assert torch.equal(norm, gnorm)
    assert torch.equal(scale, opt._clip_scale(gnorm))
    assert (float(scale) < 0.5) if clip == "on" else (float(scale) == 1.0)
    want = _adamw_reference(opt, params, grads, state, gnorm)
    for got_leaves, want_leaves in zip(_adamw_outputs(first), want):
        for got, ref_ in zip(got_leaves, want_leaves):
            assert got.dtype == ref_.dtype and got.shape == ref_.shape
            assert torch.equal(got, ref_)
    assert first[1]["step"].item() == step
    if lr_kind == "float":
        assert first[2]["lr"] == 3e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_adamw_unaligned_and_empty_leaves_on_card(cuda, dtype):
    """Leaves that start one element past a 16-byte boundary take the
    kernel's scalar loop, an empty leaf no launch; p, m and v still equal
    the per-leaf path's bit for bit."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim.adamw import AdamW
    from repro_torch.pytree import leaves

    params, grads, state = _adamw_tree(cuda, dtype, sizes=(2050, 1001, 0))
    for tree in (params, grads, state["m"], state["v"]):
        tree["l0"] = tree["l0"][1:]
        assert tree["l0"].data_ptr() % 16 != 0
    opt = AdamW(schedule=lambda s: 1e-3, clip_norm=0.1)
    kadamw.reset_launch_count()
    got = opt.apply(params, grads, state)
    torch.cuda.synchronize()
    assert kadamw.apply_count("fused") == 1
    assert {e: kadamw.launch_count(e) for e in kadamw.ENTRIES} == {
        "sumsq": 2, "finalize": 1, "update": 2}
    want = _adamw_reference(opt, params, grads, state, got[2]["grad_norm"])
    for got_leaves, want_leaves in zip(_adamw_outputs(got), want):
        for a, b in zip(got_leaves, want_leaves):
            assert torch.equal(a, b)
    want_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
    assert abs(float(got[2]["grad_norm"]) - float(want_norm)) <= \
        1e-5 * float(want_norm)


def test_bf16_train_steps_take_the_fused_adamw_on_card(cuda):
    """Three bf16 train steps of the smoke config on the card: each apply
    takes the fused path (one sumsq and one update launch a leaf, one
    finalize a step); the loss stays finite."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves

    cfg = dataclasses.replace(registry.smoke_config("olmoe_1b_7b"),
                              dtype=torch.bfloat16, remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=cuda)
    opt = steps.default_optimizer(cfg)
    state = opt.init(params)
    step = steps.make_train_step(cfg, opt, device=cuda)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                        global_batch=2), device=cuda)
    kadamw.reset_launch_count()
    for i in range(3):
        loss, params, state = step(params, state, stream.batch_at(i))
    torch.cuda.synchronize()
    n = len(leaves(params))
    assert kadamw.apply_count("fused") == 3
    assert kadamw.apply_count("per_leaf") == 0
    assert {e: kadamw.launch_count(e) for e in kadamw.ENTRIES} == {
        "sumsq": 3 * n, "finalize": 3, "update": 3 * n}
    assert torch.isfinite(loss)


@pytest.mark.parametrize("case", ["g_fp32_of_bf16", "p_fp16", "m_bf16"])
def test_fused_adamw_refuses_rather_than_falls_back_on_card(cuda, case):
    """A CUDA tree with a leaf the kernel does not take raises, naming the
    leaf's fault; no per-leaf apply and no update launch is counted."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim.adamw import AdamW

    params, grads, state = _adamw_tree(cuda, torch.bfloat16, sizes=(7, 2049))
    if case == "g_fp32_of_bf16":
        grads["l1"] = grads["l1"].float()
    elif case == "p_fp16":
        params["l0"], grads["l0"] = params["l0"].half(), grads["l0"].half()
    else:
        state["m"]["l1"] = state["m"]["l1"].bfloat16()
    kadamw.reset_launch_count()
    with pytest.raises(ValueError, match="dtype|float32"):
        AdamW(schedule=lambda s: 1e-3).apply(params, grads, state)
    assert kadamw.apply_count() == 0
    assert kadamw.launch_count("update") == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_adamw_takes_non_contiguous_leaves_on_card(cuda, dtype):
    """Transposed leaves take the fused path (copied contiguous first); p,
    m and v equal the per-leaf path's bit for bit, the inputs unchanged."""
    from repro_torch.kernels import adamw as kadamw
    from repro_torch.optim.adamw import AdamW
    from repro_torch.pytree import leaves

    params, grads, state = _adamw_tree(cuda, dtype, sizes=(64 * 33, 7))
    for tree in (params, grads, state["m"], state["v"]):
        tree["l0"] = tree["l0"].view(64, 33).t()
        assert not tree["l0"].is_contiguous()
    before = [x.clone() for tree in (params, grads, state["m"], state["v"])
              for x in leaves(tree)]
    opt = AdamW(schedule=lambda s: 1e-3, clip_norm=0.1)
    kadamw.reset_launch_count()
    got = opt.apply(params, grads, state)
    torch.cuda.synchronize()
    assert kadamw.apply_count("fused") == 1
    assert kadamw.apply_count("per_leaf") == 0
    want = _adamw_reference(opt, params, grads, state, got[2]["grad_norm"])
    for got_leaves, want_leaves in zip(_adamw_outputs(got), want):
        for a, b in zip(got_leaves, want_leaves):
            assert a.shape == b.shape and torch.equal(a, b)
    after = [x for tree in (params, grads, state["m"], state["v"])
             for x in leaves(tree)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
