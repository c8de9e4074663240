"""The port's min-plus operations against the JAX package's, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.  Each
candidate ``a + b`` is one rounded float32 add and ``min`` is exact, so
every comparison here is exact (``assert_array_equal``), including inputs
with ``1e30`` (the finite INF sentinel) entries and ragged shapes.  The JAX
side runs its broadcast oracle and its Pallas kernels in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import minplus, ops, ref  # noqa: E402

INF = np.float32(1e30)


def _operand(rng, shape, inf_share):
    x = rng.uniform(0.0, 10.0, shape).astype(np.float32)
    x[rng.random(shape) < inf_share] = INF
    return x


SHAPES = [((1, 1), (1, 1)), ((5, 7), (7, 3)), ((24, 24), (24, 24)),
          ((33, 40), (40, 17)), ((3, 9, 4), (3, 4, 11)),
          ((2, 3, 6, 5), (2, 3, 5, 6)), ((6, 24, 24), (6, 24, 24))]


@pytest.mark.parametrize("inf_share", [0.0, 0.3])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_plain_matches_reference_oracle(sa, sb, inf_share):
    rng = np.random.default_rng(hash((sa, sb)) % 2**32)
    a, b = _operand(rng, sa, inf_share), _operand(rng, sb, inf_share)
    want = np.asarray(jref.minplus_matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(ref.minplus_matmul_ref(ta, tb).numpy(), want)
    np.testing.assert_array_equal(ops.minplus_matmul(ta, tb).numpy(), want)


@pytest.mark.parametrize("sa,sb", [((5, 7), (7, 3)), ((3, 9, 4), (3, 4, 11)),
                                   ((2, 130, 3), (2, 3, 129))])
def test_plain_matches_pallas_kernels_interpret(sa, sb):
    """The Pallas kernels (2-D and batched; padded to their 128 blocks
    with 1e30 by the reference's wrapper) agree with the port's version."""
    rng = np.random.default_rng(len(sa) * 1000 + sa[-1])
    a, b = _operand(rng, sa, 0.2), _operand(rng, sb, 0.2)
    want = np.asarray(jops.minplus_matmul(jnp.asarray(a), jnp.asarray(b),
                                          use_pallas=True))
    got = ops.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_broadcast_leading_dims_match_reference():
    rng = np.random.default_rng(3)
    a, b = _operand(rng, (4, 1, 5, 6), 0.1), _operand(rng, (3, 6, 2), 0.1)
    want = np.asarray(jref.minplus_matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    got = ops.minplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_matvec_matches_reference():
    rng = np.random.default_rng(4)
    a, x = _operand(rng, (3, 7, 9), 0.2), _operand(rng, (3, 9), 0.2)
    want = np.asarray(jref.minplus_matvec_ref(jnp.asarray(a), jnp.asarray(x)))
    got = ref.minplus_matvec_ref(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 5), (24, 24), (17, 17), (6, 24, 24),
                                   (2, 3, 9, 9)])
def test_closure_matches_reference(shape):
    """Fixed-count squaring (the port) equals the reference's early-exit
    loop and its unconditional oracle, 2-D and batched."""
    rng = np.random.default_rng(shape[-1] + len(shape))
    w = _operand(rng, shape, 0.6)
    jw = jnp.asarray(w)
    got = ops.minplus_closure(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.minplus_closure(jw)))
    np.testing.assert_array_equal(
        ref.minplus_closure_ref(torch.from_numpy(w)).numpy(),
        np.asarray(jref.minplus_closure_ref(jw)))
    np.testing.assert_array_equal(np.diagonal(got, axis1=-2, axis2=-1), 0.0)


def test_cpu_tensors_take_plain_version_without_counting():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_operand(rng, (4, 24, 24), 0.2))
    n0 = minplus.launch_count()
    out = minplus.minplus_matmul_batched(a, a)
    assert minplus.launch_count() == n0
    assert torch.equal(out, ref.minplus_matmul_ref(a, a))
    out2d = minplus.minplus_matmul_batched(a[0], a[1])
    assert torch.equal(out2d, ref.minplus_matmul_ref(a[0], a[1]))


@pytest.mark.parametrize("bad", ["dtype", "rank", "k", "batch", "layout",
                                 "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((2, 3, 4))
    b = torch.zeros((2, 4, 5))
    if bad == "dtype":
        a = a.double()
    elif bad == "rank":
        a, b = a[None], b[None]
    elif bad == "k":
        b = torch.zeros((2, 5, 5))
    elif bad == "batch":
        b = torch.zeros((3, 4, 5))
    elif bad == "layout":
        a = torch.zeros((2, 4, 3)).transpose(1, 2)
    elif bad == "empty":
        a, b = torch.zeros((2, 0, 4)), torch.zeros((2, 4, 5))
    with pytest.raises((TypeError, ValueError)):
        minplus.minplus_matmul_batched(a, b)


def test_closure_steps_cover_simple_paths():
    for n in range(1, 70):
        assert 2 ** ops.closure_steps(n) >= n - 1
