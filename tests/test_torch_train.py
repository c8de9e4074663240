"""The port's training path against the JAX reference on the CPU: the loss,
its gradients and three AdamW train steps of the smoke smollm-135m config
in float32, through the flash path (the reference's Pallas kernels in
interpret mode, the port's plain versions of its CUDA kernels) and the
XLA-style path, with remat on and off.

Params come from the reference's ``init_params`` and cross as numpy
(``interop.lm_params_from_numpy``); the batches are the same
``SyntheticStream`` tokens in both packages.  Tolerances: the loss at rtol
1e-5; gradients per leaf at atol 1e-5, rtol 1e-4 (float32 sums taken in
another order); after three steps the losses at rtol 1e-5 and the params
per leaf at atol 2e-5, rtol 1e-4 (an Adam step divides by sqrt(v) + eps,
which magnifies the gradients' last-ulp differences where |g| is near
eps)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.kernels import flash  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402

B, S = 2, 128
LR = 1e-3
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)
CASES = [("flash", True), ("flash", False), ("xla", True), ("xla", False)]


def _pair(attn_impl, remat, seed=0):
    """(reference cfg, reference params, port cfg, port params)."""
    fields = dict(attn_impl=attn_impl, remat=remat)
    jcfg = dataclasses.replace(jreg.smoke_config("smollm_135m"),
                               dtype=jnp.float32, **fields)
    tcfg = dataclasses.replace(treg.smoke_config("smollm_135m"),
                               dtype=torch.float32, **fields)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _streams(cfg):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1)
    return JStream(JDataConfig(**kw)), SyntheticStream(DataConfig(**kw),
                                                       device="cpu")


def _assert_trees_close(got, want, tol, what):
    flat_want = {"/".join(str(k.key) for k in path): np.asarray(x)
                 for path, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(pytree.items(got))
    assert sorted(got) == sorted(flat_want), what
    for key, w in flat_want.items():
        np.testing.assert_allclose(got[key].detach().float().numpy(), w,
                                   err_msg=f"{what}: {key}", **tol)


@pytest.mark.parametrize("attn_impl,remat", CASES)
def test_loss_and_grads_match_reference(attn_impl, remat):
    jcfg, jparams, tcfg, tparams = _pair(attn_impl, remat)
    jdata, tdata = _streams(jcfg)
    jbatch, tbatch = jdata.batch_at(0), tdata.batch_at(0)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch)))(jparams)

    flat = [p.requires_grad_() for p in pytree.leaves(tparams)]
    flash.reset_launch_count()
    loss = TM.loss_fn(tcfg, pytree.unflatten(tparams, flat), tbatch)
    grads = torch.autograd.grad(loss, flat)
    assert flash.launch_count("flash_bwd_dq") == 0   # CPU: plain versions
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert abs(loss.item() - np.log(tcfg.vocab_size)) < 0.1
    _assert_trees_close(pytree.unflatten(tparams, list(grads)), want_grads,
                        GRAD_TOL, f"grads {attn_impl} remat={remat}")


@pytest.mark.parametrize("attn_impl,remat", [("flash", True),
                                             ("xla", False)])
def test_three_train_steps_match_reference(attn_impl, remat):
    jcfg, jparams, tcfg, tparams = _pair(attn_impl, remat, seed=2)
    jdata, tdata = _streams(jcfg)
    jopt, topt = JAdamW(schedule=lambda s: LR), AdamW(schedule=lambda s: LR)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
    tstep = steps.make_train_step(tcfg, topt, device="cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    passed_in = tparams
    start = {k: v.clone() for k, v in pytree.items(tparams)}
    for i in range(3):
        want, jparams, jstate = jstep(jparams, jstate, jdata.batch_at(i))
        got, tparams, tstate = tstep(tparams, tstate, tdata.batch_at(i))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        _assert_trees_close(tparams, jparams, PARAM_TOL, f"params step {i}")
    _assert_trees_close(tstate["m"], jstate["m"], GRAD_TOL, "adam m")
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    # the step returns new tensors and leaves the ones passed in alone
    for key, x in pytree.items(passed_in):
        assert torch.equal(start[key], x) and not x.requires_grad


def test_adamw_state_and_params_cross_back_to_the_reference():
    """``adamw_state_from_numpy`` and ``lm_params_to_numpy`` carry the
    training state both ways: one reference step from the port's state
    equals the port's step from the same state."""
    jcfg, jparams, tcfg, tparams = _pair("xla", False, seed=3)
    jdata, tdata = _streams(jcfg)
    jopt, topt = JAdamW(schedule=lambda s: LR), AdamW(schedule=lambda s: LR)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt))
    _, jparams, jstate = jstep(jparams, jopt.init(jparams), jdata.batch_at(0))
    tstate = interop.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                            device="cpu")
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == 1
    _, tparams, tstate = steps.make_train_step(tcfg, topt, device="cpu")(
        tparams, tstate, tdata.batch_at(1))
    back = jax.tree.map(jnp.asarray, interop.lm_params_to_numpy(tparams))
    _, jparams, _ = jstep(jparams, jstate, jdata.batch_at(1))
    _assert_trees_close(tparams, jparams, PARAM_TOL, "port step")
    np.testing.assert_allclose(
        float(JM.loss_fn(jcfg, back, jdata.batch_at(2))),
        float(JM.loss_fn(jcfg, jparams, jdata.batch_at(2))), rtol=1e-5)


def _loss_and_grads(cfg, params, batch):
    flat = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    loss = TM.loss_fn(cfg, pytree.unflatten(params, flat), batch)
    return loss, pytree.unflatten(params, list(torch.autograd.grad(loss,
                                                                   flat)))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_remat_policy_dots_matches_reference_and_full(attn_impl):
    """``remat_policy="dots"`` (no config uses it): the loss and every
    gradient leaf against the reference's ``"dots"`` and against the
    port's own ``"full"``, at GRAD_TOL."""
    jcfg, jparams, tcfg, tparams = _pair(attn_impl, True)
    jcfg = dataclasses.replace(jcfg, remat_policy="dots")
    dots = dataclasses.replace(tcfg, remat_policy="dots")
    jdata, tdata = _streams(jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jdata.batch_at(0))))(jparams)
    loss, grads = _loss_and_grads(dots, tparams, tdata.batch_at(0))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(grads, want_grads, GRAD_TOL, f"dots {attn_impl}")
    full_loss, full_grads = _loss_and_grads(tcfg, tparams, tdata.batch_at(0))
    np.testing.assert_allclose(loss.item(), full_loss.item(), rtol=1e-5)
    for key, g in pytree.items(full_grads):
        np.testing.assert_allclose(dict(pytree.items(grads))[key].numpy(),
                                   g.numpy(), err_msg=key, **GRAD_TOL)


def test_remat_policy_dots_keeps_the_products(monkeypatch):
    """The selective-checkpoint policy is consulted, keeps every ``aten.mm``
    / ``aten.addmm`` output of the forward (MUST_SAVE) and recomputes the
    rest; so the backward under ``"dots"`` runs no product of the forward
    again: its ``aten.mm`` are the two gradient products of each forward
    one, while ``"full"`` also recomputes six of each block's seven
    (q, k, v, o, gate, up; the recompute stops before ``w_down``, whose
    output no gradient needs)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import common
    _, _, tcfg, tparams = _pair("xla", True)
    batch = _streams(tcfg)[1].batch_at(0)
    calls = []
    policy = common.dots_policy

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        calls.append((op, out))
        return out

    monkeypatch.setattr(common, "dots_policy", spy)

    class CountMM(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountMM.n += func in common.DOTS_SAVED
            return func(*args, **(kwargs or {}))

    def mms(cfg):
        """(aten.mm of the forward, of the backward)."""
        flat = [p.detach().requires_grad_() for p in pytree.leaves(tparams)]
        CountMM.n = 0
        with CountMM():
            loss = TM.loss_fn(cfg, pytree.unflatten(tparams, flat), batch)
        fwd, CountMM.n = CountMM.n, 0
        with CountMM():
            torch.autograd.grad(loss, flat)
        return fwd, CountMM.n

    full_fwd, full = mms(tcfg)
    assert not calls                      # "full" consults no policy
    fwd, dots = mms(dataclasses.replace(tcfg, remat_policy="dots"))
    saved = [out for op, out in calls if op in common.DOTS_SAVED]
    # seven projections a block: q, k, v, o, gate, up, down
    assert len(saved) == 7 * tcfg.num_layers
    assert all(out == CheckpointPolicy.MUST_SAVE for out in saved)
    assert any(out == CheckpointPolicy.PREFER_RECOMPUTE for _, out in calls)
    assert fwd == full_fwd == 7 * tcfg.num_layers + 1     # + the unembed
    assert dots == 2 * fwd
    assert full - dots == 6 * tcfg.num_layers


def test_loss_masks_negative_labels():
    _, _, tcfg, tparams = _pair("xla", False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (2, 16)))
    labels = toks.roll(-1, dims=1)
    full = TM.loss_fn(tcfg, tparams, {"tokens": toks, "labels": labels})
    masked = labels.clone()
    masked[:, 8:] = -1
    half = TM.loss_fn(tcfg, tparams, {"tokens": toks, "labels": masked})
    logp = torch.log_softmax(TM.prefill_logits(tcfg, tparams,
                                               {"tokens": toks}), -1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    np.testing.assert_allclose(full.item(), -ll.mean().item(), rtol=1e-6)
    np.testing.assert_allclose(half.item(), -ll[:, :8].mean().item(),
                               rtol=1e-6)
    none = torch.full_like(labels, -1)
    assert TM.loss_fn(tcfg, tparams, {"tokens": toks,
                                      "labels": none}).item() == 0.0
