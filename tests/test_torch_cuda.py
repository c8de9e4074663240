"""The port on a CUDA card: the min-plus kernel against its plain version,
the greedy solve on the card against the same solve on the CPU, bit for
bit, and the flash-attention kernels (forward, dq, dk/dv) against their
plain versions.  Marked ``cuda``; each test skips without a card.  On a GPU
machine: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
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


# -- flash attention ----------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # tests/test_kernels.py


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
    _close(o, want_o, FLASH_TOL[dtype])
    _close(o2, want_o, FLASH_TOL[dtype])
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


def test_flash_bwd_is_deterministic_on_card(cuda):
    from repro_torch.kernels import flash
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(4, 512, 64, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    o, lse = flash.flash_fwd_lse(q, k, v, scale=0.125)
    a = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
    b = flash.flash_bwd(q, k, v, o, lse, do, scale=0.125)
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
    _close(out["cuda"][0].cpu(), out["cpu"][0], 1e-5)
    for (key, a), (_, b) in zip(pytree.items(out["cuda"][1]),
                                pytree.items(out["cpu"][1])):
        _close(a.cpu(), b, 2e-5)
