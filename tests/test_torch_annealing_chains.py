"""Algorithm 2 with four chains in the port, on the reference's draws,
against the JAX reference on the CPU (the single-chain runs and the
helpers are in ``test_torch_annealing.py``; the two files split the
reference's compile time)."""
import pytest

pytest.importorskip("torch")

from test_torch_annealing import check_run_on_reference_tape  # noqa: E402


@pytest.mark.parametrize("block_move_prob", [0.0, 0.3])
@pytest.mark.parametrize("init", ["random", "greedy"])
def test_anneal_on_reference_tape_equals_reference(init, block_move_prob):
    check_run_on_reference_tape(4, init, block_move_prob)
