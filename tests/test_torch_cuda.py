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
