"""The port on a CUDA card: the min-plus kernel against its plain version,
and the greedy solve on the card against the same solve on the CPU, bit
for bit.  Marked ``cuda``; each test skips without a card.  On a GPU
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


def _close(got, want, tol):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), \
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
