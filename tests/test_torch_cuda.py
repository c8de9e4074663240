"""The port on a CUDA card: the min-plus product and closure kernels
against their plain versions, the greedy solve on the card against the
same solve on the CPU, bit for bit (the §V instance and a window of each
catalog scenario), and the flash-attention kernels
(forward, dq, dk/dv, each on the CUDA cores and the tensor cores; the
tensor-core tile products alone) against their plain versions.  Marked ``cuda``; each test skips without a card.
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
# (192 -> 128, the MLA widths), the widest head, ragged and short lengths
BWD_CASES = [(36, 2048, 64, 64, torch.bfloat16, True),
             (4, 256, 64, 64, torch.float32, True),
             (2, 256, 192, 128, torch.float32, True),
             (1, 200, 256, 256, torch.float32, True),
             (2, 130, 32, 48, torch.float32, True),
             (3, 1000, 64, 64, torch.bfloat16, True),
             (1, 1, 16, 16, torch.float32, True),
             (2, 300, 64, 32, torch.float32, False)]
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


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_tile_products_match_matmul_on_card(cuda, no_tf32, d):
    """The tensor-core kernels' tile products alone: S = A B^T as an SS
    wgmma (both K-major, TMA-loaded with 128-byte swizzle) against
    torch.matmul, and bf16(S) C as an RS wgmma with C read MN-major.
    Exact products summed in float32: within float32 rounding."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(d)
    a, b, c = (torch.randn(64, d, device=cuda, generator=g).bfloat16()
               for _ in range(3))
    s_out, o_out = flash.sm90_tile_probe(a, b, c)
    torch.cuda.synchronize()
    _close(s_out, torch.matmul(a.float(), b.float().T), 1e-4, 1e-5)
    _close(o_out, torch.matmul(s_out.bfloat16().float(), c.float()), 1e-4,
           1e-5)


def test_flash_bwd_is_deterministic_on_card(cuda):
    """No atomics: the gradients are the same bits on every run, through
    the tensor-core dq and dk/dv kernels at bf16, d = 64 and 128, and the
    CUDA-core ones at float32."""
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(0)
    for d, dtype, variant in ((64, torch.bfloat16, "sm90"),
                              (128, torch.bfloat16, "sm90"),
                              (64, torch.float32, "simt")):
        q, k, v, do = (torch.randn(4, 512, d, device=cuda, generator=g)
                       .to(dtype) for _ in range(4))
        o, lse = flash.flash_fwd_lse(q, k, v, scale=0.125)
        flash.reset_launch_count()
        a = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
        b = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
        assert flash.launch_count("flash_bwd_dkv", variant) == 2
        assert flash.launch_count("flash_bwd_dq", variant) == 2
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
