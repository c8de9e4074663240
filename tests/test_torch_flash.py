"""The port's flash attention, forward and backward, against the JAX
reference on the CPU.

On CPU tensors the port's wrappers run the kernels' plain versions
(``repro_torch.kernels.ref.flash_fwd_lse_ref``, ``flash_bwd_ref``); the
reference's Pallas kernels run in interpret mode.  Tolerances are the
reference's own (``tests/test_kernels.py``): O at 2e-5 in float32 and
3e-2 in bfloat16, the logsumexp at 1e-5; through the backward, the value
at rtol 1e-4 and dq, dk, dv at atol 1e-4, rtol 1e-3.  The kernels
themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash as jflash  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import flash, ops  # noqa: E402

SHAPES = [(2, 256, 64, 64, 128), (1, 256, 192, 128, 64),
          (2, 128, 64, 64, 128),
          (1, 256, 96, 96, 128)]       # bh, S, d, dv, the reference's bq
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


@pytest.mark.parametrize("bh,s,d,dv,bq", [(2, 256, 64, 64, 128),
                                          (2, 256, 32, 16, 128)])
def test_flash_grads_match_reference(bh, s, d, dv, bq):
    """The reference test's shape (``test_flash_grads_match_autodiff``) and
    a d != dv case: the same q, k, v and cotangent through ``jax.vjp`` of
    the reference's ``ops.flash_attention`` (its Pallas dq and dk/dv
    kernels in interpret mode) and through ``torch.autograd.grad`` of the
    port's."""
    rng = np.random.default_rng(3 + d)
    arrs = [rng.standard_normal(shape, dtype=np.float32) for shape in
            ((bh, s, d), (bh, s, d), (bh, s, dv), (bh, s, dv))]
    scale = 1 / math.sqrt(d)

    def jf(q, k, v):
        return jnp.sum(jops.flash_attention(q, k, v, scale=scale, bq=bq,
                                            bk=bq) * arrs[3])

    want_val, want_grads = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrs[:3]))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    val = (ops.flash_attention(q, k, v, scale=scale)
           * torch.from_numpy(arrs[3])).sum()
    grads = torch.autograd.grad(val, (q, k, v))
    np.testing.assert_allclose(val.item(), float(want_val), rtol=1e-4)
    for got, want in zip(grads, want_grads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-3)


def _grads_f64(q, k, v, do, scale, causal):
    """dq, dk, dv of a float64 dense softmax attention (torch autograd)."""
    qd, kd, vd = (x.detach().double().requires_grad_() for x in (q, k, v))
    o, _ = _dense_f64(qd, kd, vd, scale, causal)
    return torch.autograd.grad((o * do.double()).sum(), (qd, kd, vd))


@pytest.mark.parametrize("bh,s,d,dv,causal", [
    (1, 640, 16, 16, True), (2, 130, 64, 64, True), (2, 100, 32, 48, True),
    (1, 1, 8, 8, True), (2, 100, 32, 48, False)])
def test_backward_ragged_lengths_against_float64(bh, s, d, dv, causal):
    """Any S is exact in the port's backward.  At S=640 the reference's
    backward (bq = bk = 512) leaves rows 512..639 of dq, dk, dv unwritten,
    so the yardstick is float64 autograd of a dense softmax.  Held: the
    port's autograd through ``ops.flash_attention`` (causal only) and
    ``flash_bwd_ref`` itself, at atol 2e-5, rtol 1e-4 (float32 against
    float64)."""
    rng = np.random.default_rng(s + dv)
    q, k = (torch.from_numpy(rng.standard_normal((bh, s, d),
                                                 dtype=np.float32))
            for _ in range(2))
    v, do = (torch.from_numpy(rng.standard_normal((bh, s, dv),
                                                  dtype=np.float32))
             for _ in range(2))
    scale = 1 / math.sqrt(d)
    want = _grads_f64(q, k, v, do, scale, causal)
    o, lse = flash.flash_fwd_lse(q, k, v, scale=scale, causal=causal)
    results = [ref.flash_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                 causal=causal)]
    if causal:
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = ops.flash_attention(*leaves, scale=scale)
        results.append(torch.autograd.grad((out * do).sum(), leaves))
    for got in results:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                       rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_ref_equals_its_per_kernel_plain_versions(dtype, causal):
    """``flash_bwd_ref`` shares one P and dS between dq, dk and dv; the
    two per-kernel plain versions (each kernel's yardstick on the card)
    give the same gradients bit for bit."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 130, 32), dtype=np.float32)).to(TDT[dtype]) for _ in range(4))
    kw = dict(scale=1 / math.sqrt(32), causal=causal)
    o, lse = ref.flash_fwd_lse_ref(q, k, v, **kw)
    delta = ref.flash_bwd_delta(o, do)
    want = (ref.flash_bwd_dq_ref(q, k, v, do, lse, delta, **kw),
            *ref.flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw))
    for got, w in zip(ref.flash_bwd_ref(q, k, v, o, lse, do, **kw), want):
        assert got.dtype == TDT[dtype] and torch.equal(got, w)


def test_backward_bfloat16_gives_bfloat16_grads():
    """bf16 operands give bf16 gradients, within 3e-2 of the float32
    backward of the same (bf16-representable) values."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.standard_normal((2, 256, 32),
                                               dtype=np.float32))
          .bfloat16() for _ in range(4)]
    bf = [x.clone().requires_grad_() for x in xs[:3]]
    f32 = [x.float().requires_grad_() for x in xs[:3]]
    got = torch.autograd.grad(
        (ops.flash_attention(*bf, scale=0.25).float() * xs[3].float()).sum(),
        bf)
    want = torch.autograd.grad(
        (ops.flash_attention(*f32, scale=0.25) * xs[3].float()).sum(), f32)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), atol=3e-2,
                                   rtol=3e-2)


def test_backward_raises_instead_of_differentiating_the_plain_version(
        monkeypatch):
    """The backward is ``flash.flash_bwd`` (the kernels on the card, their
    plain version here), not autograd of the plain forward: a failure
    there raises instead of falling back."""
    q, k, v = (torch.randn(2, 128, 16, generator=torch.Generator()
                           .manual_seed(i), requires_grad=True)
               for i in range(3))
    o = ops.flash_attention(q, k, v, scale=0.25)
    assert o.requires_grad
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    calls = []

    def failing_bwd(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError("flash_bwd kernel launch failed")

    monkeypatch.setattr(flash, "flash_bwd", failing_bwd)
    with pytest.raises(RuntimeError, match="flash_bwd"):
        o.sum().backward()
    assert calls == [{"scale": 0.25, "causal": True}]
    assert q.grad is None


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


def test_backward_wrapper_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(2, 64, 16)
    lse = torch.zeros(2, 64)
    launches = (flash.launch_count("flash_bwd_dq"),
                flash.launch_count("flash_bwd_dkv"))
    with pytest.raises(ValueError, match="lse"):
        flash.flash_bwd(x, x, x, x, lse.double(), x, scale=1.0)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_bwd(x, x, x, x, lse[:, :32], x, scale=1.0)
    with pytest.raises(ValueError, match="do"):
        flash.flash_bwd(x, x, x, x, lse, x[:, :, :8], scale=1.0)
    with pytest.raises(ValueError, match="expected o "):
        flash.flash_bwd(x, x, x, x.bfloat16(), lse, x, scale=1.0)
    with pytest.raises(ValueError, match="delta"):
        flash.flash_bwd_dq(x, x, x, x, lse, lse[:, :32], scale=1.0)
    with pytest.raises(ValueError, match="delta"):
        flash.flash_bwd_dkv(x, x, x, x, lse, x, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_bwd(x, x, x, x, lse, x.transpose(0, 1).contiguous()
                        .transpose(0, 1), scale=1.0)
    with pytest.raises(TypeError):
        flash.flash_bwd(x.half(), x.half(), x.half(), x.half(), lse,
                        x.half(), scale=1.0)
    dq, dk, dv = flash.flash_bwd(x, x, x, x, lse, x, scale=1.0)
    assert dq.shape == dk.shape == dv.shape == x.shape
    delta = ref.flash_bwd_delta(x, x)
    assert torch.equal(flash.flash_bwd_dq(x, x, x, x, lse, delta,
                                          scale=1.0), dq)
    assert all(torch.equal(a, b) for a, b in zip(
        flash.flash_bwd_dkv(x, x, x, x, lse, delta, scale=1.0), (dk, dv)))
    assert (flash.launch_count("flash_bwd_dq"),
            flash.launch_count("flash_bwd_dkv")) == launches


@pytest.mark.parametrize("entry,dtype,d,dv,variant", [
    ("flash_fwd_lse", "bfloat16", 64, 64, "sm90"),
    ("flash_fwd_lse", "bfloat16", 128, 128, "sm90"),
    ("flash_attention_bhsd", "bfloat16", 64, 64, "sm90"),
    ("flash_bwd_dkv", "bfloat16", 64, 64, "sm90"),
    ("flash_bwd_dkv", "bfloat16", 128, 128, "sm90"),
    ("flash_bwd_dq", "bfloat16", 64, 64, "sm90"),
    ("flash_bwd_dq", "bfloat16", 128, 128, "sm90"),
    ("flash_bwd_dq", "float32", 64, 64, "simt"),
    ("flash_bwd_dq", "bfloat16", 32, 32, "simt"),
    ("flash_fwd_lse", "float32", 64, 64, "simt"),
    ("flash_bwd_dkv", "float32", 128, 128, "simt"),
    ("flash_fwd_lse", "bfloat16", 192, 128, "sm90"),
    ("flash_attention_bhsd", "bfloat16", 192, 128, "sm90"),
    ("flash_bwd_dkv", "bfloat16", 192, 128, "sm90"),
    ("flash_fwd_lse", "bfloat16", 96, 96, "sm90"),
    ("flash_attention_bhsd", "bfloat16", 96, 96, "sm90"),
    ("flash_bwd_dkv", "bfloat16", 96, 96, "sm90"),
    ("flash_bwd_dq", "bfloat16", 96, 96, "sm90"),
    ("flash_bwd_dq", "bfloat16", 192, 128, "sm90"),
    ("flash_fwd_lse", "float32", 96, 96, "simt"),
    ("flash_bwd_dkv", "float32", 192, 128, "simt"),
    ("flash_fwd_lse", "bfloat16", 192, 192, "simt"),
    ("flash_bwd_dkv", "bfloat16", 192, 192, "simt"),
    ("flash_fwd_lse", "bfloat16", 96, 64, "simt"),
    ("flash_bwd_dkv", "bfloat16", 96, 64, "simt"),
    ("flash_fwd_lse", "bfloat16", 128, 96, "simt"),
    ("flash_bwd_dkv", "bfloat16", 128, 96, "simt"),
    ("flash_fwd_lse", "bfloat16", 32, 32, "simt"),
    ("flash_bwd_dkv", "bfloat16", 32, 32, "simt"),
    ("flash_attention_bhsd", "bfloat16", 256, 256, "simt"),
    ("flash_fwd_lse", "bfloat16", 64, 32, "simt")])
def test_kernel_variant_is_a_rule_on_dtype_and_shape(entry, dtype, d, dv,
                                                     variant):
    """bf16 with (d, dv) in {(64, 64), (128, 128), (96, 96), (192, 128)}
    takes the tensor-core kernel for every entry (the forward entries, dq
    and dk/dv); everything else, float32 included, the CUDA-core
    kernel."""
    assert flash.kernel_variant(entry, TDT[dtype], d, dv) == variant


def test_launch_counts_are_kept_per_variant():
    with pytest.raises(ValueError, match="unknown flash entry"):
        flash.kernel_variant("flash_bwd", torch.bfloat16, 64, 64)
    flash.reset_launch_count()
    for entry in flash.ENTRIES:
        assert flash.launch_count(entry) == 0
        assert all(flash.launch_count(entry, v) == 0 for v in flash.VARIANTS)
    with pytest.raises(KeyError):
        flash.launch_count("flash_fwd_lse", "tensor")
    # the CPU path runs the plain version and counts no launch of either
    x = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    flash.flash_fwd_lse(x, x, x, scale=1.0)
    assert flash.launch_count() == 0


def test_tma_check_rejects_misaligned_operands():
    """The tensor-core kernels' TMA loads need 16-byte-aligned base
    pointers and rows of a multiple of 16 bytes; the check raises
    instead of choosing another kernel."""
    flat = torch.zeros(2 * 64 * 64 + 8, dtype=torch.bfloat16)
    aligned = flat[:2 * 64 * 64].view(2, 64, 64)
    flash._check_tma(q=aligned)
    shifted = flat[1:1 + 2 * 64 * 64].view(2, 64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="q: TMA"):
        flash._check_tma(q=shifted)
    with pytest.raises(ValueError, match="k: TMA"):
        flash._check_tma(k=torch.zeros(2, 64, 4, dtype=torch.bfloat16))
    # lse and delta [BH, S] are one flat vector: any S, an aligned base
    rows = torch.zeros(2 * 130 + 4)
    flash._check_tma(lse=rows[:2 * 130].view(2, 130))
    with pytest.raises(ValueError, match="delta: TMA"):
        flash._check_tma(delta=rows[1:1 + 2 * 130].view(2, 130))


def test_flash_bwd_ref_builds_probabilities_once(monkeypatch):
    """The CPU backward forms the [BH, S, S] scores, P and dS once for dq,
    dk and dv together."""
    calls = []
    real = ref._bwd_probs

    def counting(*args):
        calls.append(args[-2:])
        return real(*args)

    monkeypatch.setattr(ref, "_bwd_probs", counting)
    q, k, v, do = (torch.randn(2, 40, 16, generator=torch.Generator()
                               .manual_seed(i)) for i in range(4))
    o, lse = ref.flash_fwd_lse_ref(q, k, v, scale=0.25)
    flash.flash_bwd(q, k, v, o, lse, do, scale=0.25)
    assert calls == [(0.25, True)]


def split_operand_gate_ratios(bh=4, s=2048, d=64, dv=None, seed=0):
    """The numerics behind the tensor-core backward kernels' split operands,
    on the CPU: max |got - want| / (atol + rtol |want|) at the bf16
    backward gate (1e-3, 8e-3) for dk, dv and dq, when P and dS enter
    their products (P^T dO, dS^T Q, dS K) rounded to bf16 once ("once")
    or split into hi = bf16(x) and lo = bf16(x - hi) ("split"); want is
    the float32 plain math, every result rounded to bf16.  bf16
    standard-normal q, k [bh, s, d] and v, do [bh, s, dv] (dv = d by
    default), causal."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (bh, s, width), dtype=np.float32)).bfloat16()
        for width in (d, d, dv, dv))
    scale = 1 / math.sqrt(d)
    o, lse = ref.flash_fwd_lse_ref(q, k, v, scale=scale)
    delta = ref.flash_bwd_delta(o, do)
    qf, kf, dof, p, ds = ref._bwd_probs(q, k, v, do, lse, delta, scale, True)

    def bf(x):
        return x.bfloat16().float()

    forms = {"once": bf, "split": lambda x: bf(x) + bf(x - bf(x)),
             "float32": lambda x: x}
    out = {}
    for name, form in forms.items():
        dk = bf(form(ds).transpose(-1, -2) @ qf)
        dv = bf(form(p).transpose(-1, -2) @ dof)
        dq = bf(form(ds) @ kf)
        out[name] = dk, dv, dq
    ratios = {}
    for name in ("once", "split"):
        ratios[name] = tuple(
            float(((g - w).abs() / (1e-3 + 8e-3 * w.abs())).max())
            for g, w in zip(out[name], out["float32"]))
    return ratios


def test_split_operands_hold_the_bf16_backward_gate():
    """Rounding P^T and dS^T (dk/dv) or dS (dq) to bf16 once breaks the
    bf16 gate at the training shape; the hi + lo split the tensor-core
    kernels issue holds it (the headers of csrc/flash_bwd_dkv_sm90.cu and
    csrc/flash_bwd_dq_sm90.cu): dk, dv, dq at 3.10, 3.79, 2.62 once and
    0.60, 0.74, 0.54 split."""
    ratios = split_operand_gate_ratios()
    assert min(ratios["once"]) > 1.5, ratios
    assert max(ratios["split"]) < 1.0, ratios
    assert ratios["once"][2] > 2.0 and ratios["split"][2] < 0.7, ratios


@pytest.mark.parametrize("d,dv", [(96, 96), (192, 128)])
def test_split_dkv_operands_hold_the_bf16_gate_at_the_new_widths(d, dv):
    """The same at phi-3-vision's (96, 96) and MLA's (192, 128), where the
    tensor-core dq and dk/dv kernels run: dk, dv and dq with P^T, dS^T and
    dS rounded once break the gate (2.46 / 3.26 / 3.05 and 2.25 / 3.47 /
    1.90), split they hold it (0.54 / 0.64 / 0.76 and 0.59 / 0.63 /
    0.56)."""
    ratios = split_operand_gate_ratios(d=d, dv=dv)
    assert min(ratios["once"]) > 1.5, ratios
    assert max(ratios["split"]) < 1.0, ratios


def test_split_dq_operand_holds_the_bf16_gate_at_head_dim_128():
    """The same at d = 128, the other head width of the tensor-core
    kernels: dQ with dS rounded once reads 1.88 of the gate, split 0.68
    (dk and dv 3.29, 3.83 once, 0.65, 0.64 split)."""
    ratios = split_operand_gate_ratios(d=128)
    assert min(ratios["once"]) > 1.5, ratios
    assert max(ratios["split"]) < 1.0, ratios


def rounded_p_forward_gate_share(gates, bh=4, s=2048, d=64, dv=None,
                                 seed=0):
    """The numerics of the tensor-core forward, on the CPU: max |got -
    want| / (atol + rtol |want|) at each (atol, rtol) of ``gates``, where
    got is the kernel's online softmax over its key tiles (128 keys at
    d = dv = 64, 64 at the wider pairs) with P rounded to bf16 once before
    P V and l summing the float32 P, and want the plain version; both O
    rounded to bf16.  bf16 standard-normal q, k [bh, s, d] and v [bh, s,
    dv] (dv = d by default), causal."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (bh, s, width), dtype=np.float32)).bfloat16()
        for width in (d, d, dv))
    scale = 1 / math.sqrt(d)
    want = ref.flash_fwd_lse_ref(q, k, v, scale=scale)[0].float()
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), -math.inf)
    l, o = torch.zeros(bh, s, 1), torch.zeros(bh, s, dv)
    pos = torch.arange(s)
    bk = 128 if d == dv == 64 else 64
    for k0 in range(0, s, bk):
        sc = (qf @ kf[:, k0:k0 + bk].transpose(1, 2)) * scale
        sc = sc.masked_fill(pos[k0:k0 + bk] > pos[:, None], -math.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        live = m_new > -math.inf      # rows that have seen a key
        alpha = torch.where(live, torch.exp(m - m_new), 0.0)
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        m = torch.where(live, m_new, m)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vf[:, k0:k0 + bk]
    diff = ((o / l).bfloat16().float() - want).abs()
    return [float((diff / (atol + rtol * want.abs())).max())
            for atol, rtol in gates]


def test_rounded_p_forward_within_the_bf16_gate():
    """Rounding P to bf16 once, as the tensor-core forward does, keeps O
    within the bf16 O gate of the card checks (4e-3, 1.6e-2) at the
    prefill's head width, and far inside the old 3e-2 one."""
    new, old = rounded_p_forward_gate_share([(4e-3, 1.6e-2), (3e-2, 3e-2)])
    assert new < 0.8 and old < 0.25, (new, old)


@pytest.mark.parametrize("d,dv", [(96, 96), (192, 128)])
def test_rounded_p_forward_within_the_bf16_gate_at_the_new_widths(d, dv):
    """The same at phi-3-vision's (96, 96) and MLA's (192, 128), the widths
    the tensor-core forward took in bf16 after d = dv in {64, 128}, at its
    64-key tiles: O reads under 0.8 of the gate (0.43 and 0.48)."""
    (share,) = rounded_p_forward_gate_share([(4e-3, 1.6e-2)], d=d, dv=dv)
    assert share < 0.8, share
