"""The port's flash-attention forward against the JAX reference on the CPU.

On CPU tensors the port's wrappers run the kernel's plain version
(``repro_torch.kernels.ref.flash_fwd_lse_ref``); the reference's Pallas
kernels run in interpret mode.  Tolerances are the reference's own
(``tests/test_kernels.py``): O at 2e-5 in float32 and 3e-2 in bfloat16,
the logsumexp at 1e-5.  The kernel itself is held to the plain version on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash as jflash  # noqa: E402
from repro_torch.kernels import flash, ops  # noqa: E402

SHAPES = [(2, 256, 64, 64, 128), (1, 256, 192, 128, 64),
          (2, 128, 64, 64, 128)]       # bh, S, d, dv, the reference's bq
O_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(bh, s, d, dv, dtype, seed):
    """q, k, v as (reference arrays, port tensors) holding equal values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((bh, s, d), (bh, s, d), (bh, s, dv)):
        x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        x = x.astype(JDT[dtype])
        out.append((x, torch.from_numpy(np.array(x.astype(jnp.float32)))
                    .to(TDT[dtype])))
    return [a for a, _ in out], [b for _, b in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,dv,bq", SHAPES)
def test_flash_fwd_lse_matches_reference(bh, s, d, dv, bq, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(bh, s, d, dv, dtype, seed=s + d)
    scale = 1 / math.sqrt(d)
    want_o, want_lse = jflash.flash_fwd_lse(jq, jk, jv, scale=scale,
                                            interpret=True)
    o, lse = flash.flash_fwd_lse(q, k, v, scale=scale)
    assert o.dtype == TDT[dtype] and o.shape == (bh, s, dv)
    assert lse.dtype == torch.float32 and lse.shape == (bh, s)
    tol = O_TOL[dtype]
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(want_o.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,dv,bq", SHAPES)
def test_flash_attention_bhsd_matches_reference(bh, s, d, dv, bq, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(bh, s, d, dv, dtype, seed=s + dv)
    scale = 1 / math.sqrt(d)
    want = jflash.flash_attention_bhsd(jq, jk, jv, scale=scale, bq=bq,
                                       bk=bq, interpret=True)
    got = flash.flash_attention_bhsd(q, k, v, scale=scale)
    tol = O_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _dense_f64(q, k, v, scale, causal):
    q, k, v = (x.double() for x in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        n = q.shape[1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1),
                          -math.inf)
    return torch.softmax(s, -1) @ v, torch.logsumexp(s, -1)


@pytest.mark.parametrize("bh,s,d,dv,causal", [
    (1, 640, 16, 16, True), (2, 130, 64, 64, True), (1, 1, 8, 8, True),
    (2, 100, 32, 48, False)])
def test_ragged_lengths_against_float64(bh, s, d, dv, causal):
    """Any S is exact in the port.  The reference is not compared here:
    at S=640 its kernel (bq = 512) leaves rows 512..639 unwritten, so the
    yardstick is a float64 dense softmax."""
    rng = np.random.default_rng(s)
    q, k = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                 dtype=np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((bh, s, dv), dtype=np.float32))
    scale = 1 / math.sqrt(d)
    o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=causal)
    want_o, want_lse = _dense_f64(q, k, v, scale, causal)
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_backward_raises_instead_of_differentiating_the_plain_version():
    q, k, v = (torch.randn(2, 128, 16, generator=torch.Generator()
                           .manual_seed(i), requires_grad=True)
               for i in range(3))
    o = ops.flash_attention(q, k, v, scale=0.25)
    assert o.requires_grad
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        o.sum().backward()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 64, 16)
    launches = flash.launch_count()
    with pytest.raises(TypeError):
        flash.flash_fwd_lse(x.half(), x.half(), x.half(), scale=1.0)
    with pytest.raises(TypeError):
        flash.flash_fwd_lse(x, x, x.bfloat16(), scale=1.0)
    with pytest.raises(ValueError):
        flash.flash_fwd_lse(x, x[:, :32], x, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_fwd_lse(x, x, torch.zeros(2, 16, 64).transpose(1, 2),
                            scale=1.0)
    with pytest.raises(ValueError):
        flash.flash_attention_bhsd(x[0], x[0], x[0], scale=1.0)
    big = torch.zeros(1, 4, 257)
    with pytest.raises(ValueError, match="256"):
        flash.flash_fwd_lse(big, big, big, scale=1.0)
    # CPU tensors run the plain version and launch nothing
    flash.flash_fwd_lse(x, x, x, scale=1.0)
    assert flash.launch_count() == launches
