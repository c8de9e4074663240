"""``repro_torch.optim.grad_compress`` against the JAX reference on the
CPU: the int8 codes, scales, residuals and decompressed gradients of
``Int8Compressor`` over three steps of error feedback, and ``topk_mask``,
bit for bit on random trees (float32 and bf16 leaves, a zero leaf, ties);
and the reference's convergence test on a quadratic, mirrored.  Inputs are
drawn with numpy and handed to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402


def _tree(seed):
    """numpy leaves (float32) and the dtype each is handed over in: a wide
    float32 leaf, a bf16 leaf, a zero leaf and a leaf of repeated values."""
    rng = np.random.default_rng(seed)
    ties = rng.choice(np.float32([-2.0, -0.5, 0.5, 1.0, 2.0]), (6, 5))
    return {"w": (rng.standard_normal((8, 16)).astype(np.float32) * 3e-3,
                  "float32"),
            "blocks": {"b": (rng.standard_normal((33,)).astype(np.float32),
                             "bfloat16"),
                       "zero": (np.zeros((3, 4), np.float32), "float32")},
            "ties": (ties, "bfloat16")}


def _both(tree):
    """(reference tree, port tree) of the same values in each leaf's dtype."""
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    jt = jax.tree.map(lambda x: jnp.asarray(x[0], getattr(jnp, x[1])), tree,
                      is_leaf=is_leaf)
    tt = jax.tree.map(lambda x: torch.from_numpy(x[0]).to(
        getattr(torch, x[1])), tree, is_leaf=is_leaf)
    return jt, tt


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf (torch or jax), for equality with ``==``."""
    if isinstance(x, torch.Tensor):
        x = x.reshape(-1)
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


def _assert_bits_equal(got, want, what):
    flat_want = {"/".join(str(k.key) for k in path): x for path, x in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(pytree.items(got))
    assert sorted(got) == sorted(flat_want), what
    for key, w in flat_want.items():
        np.testing.assert_array_equal(_bits(got[key]), _bits(w),
                                      err_msg=f"{what}: {key}")


def test_inputs_cross_bit_for_bit():
    jt, tt = _both(_tree(0))
    _assert_bits_equal(tt, jt, "inputs")


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_codes_scales_and_residuals_match_reference_bit_for_bit(seed):
    """Three steps of ``compress`` with error feedback, on fresh gradients
    each step: codes, scales and residuals, then ``decompress`` and
    ``roundtrip``, equal the reference's bit for bit -- the zero leaf's
    scale is 1e-12 / 127 and its codes 0."""
    jc, tc = jgc.Int8Compressor(), tgc.Int8Compressor()
    jg, tg = _both(_tree(seed))
    je, te = jc.init(jg), tc.init(tg)
    _assert_bits_equal(te, je, "init")
    for step in range(3):
        jg, tg = _both(_tree(seed * 10 + step))
        jcomp, je_next = jc.compress(jg, je)
        tcomp, te_next = tc.compress(tg, te)
        for part, name in ((0, "codes"), (1, "scales")):
            _assert_bits_equal(
                pytree.tree_map(lambda qs: qs[part], tcomp),
                jax.tree.map(lambda qs: qs[part], jcomp,
                             is_leaf=lambda x: isinstance(x, tuple)),
                f"step {step} {name}")
        _assert_bits_equal(te_next, je_next, f"step {step} residuals")
        _assert_bits_equal(tc.decompress(tcomp), jc.decompress(jcomp),
                           f"step {step} decompress")
        jround, _ = jc.roundtrip(jg, je)
        tround, _ = tc.roundtrip(tg, te)
        _assert_bits_equal(tround, jround, f"step {step} roundtrip")
        je, te = je_next, te_next
    zero = dict(pytree.items(tcomp))["blocks/zero"]
    assert zero[0].dtype == torch.int8 and not zero[0].any()
    assert zero[1].item() == np.float32(np.float32(1e-12) / np.float32(127))
    assert tc.compressed_bytes(tg) == jc.compressed_bytes(jg) == 8 * 16 + 33 \
        + 12 + 30
    assert tc.raw_bytes(tg) == jc.raw_bytes(jg) == 4 * tc.compressed_bytes(tg)


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.25, 0.5, 1.0])
def test_topk_mask_matches_reference_bit_for_bit(frac):
    """Every leaf of the random tree (ties included: every entry equal to
    the k-th largest magnitude is kept in both) at several fractions."""
    jt, tt = _both(_tree(3))
    want = jax.tree.map(lambda g: jgc.topk_mask(g, frac), jt)
    got = pytree.tree_map(lambda g: tgc.topk_mask(g, frac), tt)
    _assert_bits_equal(got, want, f"topk_mask frac={frac}")
    ties = dict(pytree.items(got))["ties"]
    assert ties.dtype == torch.bfloat16


def test_topk_mask_keeps_ties():
    g = torch.tensor([3.0, -5.0, 0.1, 0.2])
    assert tgc.topk_mask(g, 0.5).tolist() == [3.0, -5.0, 0.0, 0.0]
    tied = torch.tensor([1.0, -1.0, 1.0, 0.5])
    assert tgc.topk_mask(tied, 0.25).tolist() == [1.0, -1.0, 1.0, 0.0]
    assert np.asarray(jgc.topk_mask(jnp.asarray(tied.numpy()), 0.25)
                      ).tolist() == [1.0, -1.0, 1.0, 0.0]


def test_int8_error_feedback_converges():
    """The reference's convergence test on the port: compressed-gradient
    descent tracks exact descent on a quadratic (float32)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(16, 16)) / 4 + np.eye(16)).float()
    b = torch.from_numpy(rng.normal(size=(16,))).float()
    aat = a @ a.T

    def loss(x):
        return 0.5 * x @ aat @ x - b @ x

    def grad(x):
        return aat @ x - b

    comp = tgc.Int8Compressor()
    x_exact = torch.zeros(16)
    x_comp = torch.zeros(16)
    err = comp.init({"x": x_comp})
    lr = 0.05
    for _ in range(300):
        x_exact = x_exact - lr * grad(x_exact)
        g, err = comp.roundtrip({"x": grad(x_comp)}, err)
        x_comp = x_comp - lr * g["x"]
    l_exact, l_comp = float(loss(x_exact)), float(loss(x_comp))
    assert l_comp < l_exact + 1e-2 * (abs(l_exact) + 1)
    assert comp.compressed_bytes({"x": x_comp}) * 4 == \
        comp.raw_bytes({"x": x_comp})
