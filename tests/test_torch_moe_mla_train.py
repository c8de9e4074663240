"""Training the olmoe-1b-7b and deepseek-v2 smoke models in the port
against the JAX reference on the CPU, in float32: the expert choices of
every layer, the loss and the gradient of every leaf (remat on and off,
flash and xla), the sort-based dispatch's own gradient with capacity drops,
and three steps of each package's ``train``.

Params come from the reference's ``init_params`` and cross by ``interop``;
batches are the same ``SyntheticStream`` tokens in both packages.  S = 128
because the flash path is taken from 128 tokens on (below, flash and xla
are one function).  Tolerances are ``test_torch_train.py``'s: the loss at
rtol 1e-5, gradients per leaf at atol 1e-5, rtol 1e-4; ``train`` losses at
rtol 1e-5.

Top-k routing is discontinuous, so the gradients are compared only after
the two packages' top-k expert ids are found equal, layer by layer and
token by token (they are at these seeds: no tie within rounding)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM, moe as JMoE  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM, moe as TMoE  # noqa: E402
from test_torch_moe_mla import MOE_ARCHS, _to_np  # noqa: E402
from test_torch_train import GRAD_TOL, _assert_trees_close  # noqa: E402

B, S = 2, 128
CASES = [("flash", True), ("flash", False), ("xla", True), ("xla", False)]


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0):
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32)
    return jcfg, JM.init_params(jcfg, jax.random.PRNGKey(seed))


def _port(arch, jparams, **fields):
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32,
                               **fields)
    return tcfg, interop.lm_params_from_numpy(_to_np(jparams), tcfg,
                                              device="cpu")


@functools.lru_cache(maxsize=None)
def _batch(arch):
    jcfg, _ = _reference(arch)
    kw = dict(vocab_size=jcfg.vocab_size, seq_len=S, global_batch=B, seed=4)
    return (JStream(JDataConfig(**kw)).batch_at(0),
            SyntheticStream(DataConfig(**kw), device="cpu").batch_at(0))


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, attn_impl, remat):
    jcfg, jparams = _reference(arch)
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl, remat=remat)
    jbatch, _ = _batch(arch)
    return jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch)))(jparams)


def _reference_choices(arch, monkeypatch):
    """The reference's top-k expert ids [N, k] of each layer on the test
    batch: its unrolled forward under ``jit``, ``jax.lax.top_k`` wrapped to
    return each layer's ids as outputs."""
    jcfg, jparams = _reference(arch)
    jcfg = dataclasses.replace(jcfg, scan_layers=False, remat=False)
    seen = []
    top_k = jax.lax.top_k

    def spy(x, k):
        out = top_k(x, k)
        seen.append(out[1])
        return out

    def choices(p, tokens):
        JM.prefill_logits(jcfg, p, {"tokens": tokens})
        return tuple(seen)

    monkeypatch.setattr(jax.lax, "top_k", spy)
    out = jax.jit(choices)(jparams, _batch(arch)[0]["tokens"])
    monkeypatch.undo()
    return [np.asarray(x) for x in out]


def _port_choices(tcfg, tparams, tokens, monkeypatch):
    seen = []
    route = TMoE.route

    def spy(*args):
        out = route(*args)
        seen.append(out[1].numpy())
        return out

    monkeypatch.setattr(TMoE, "route", spy)
    with torch.no_grad():
        TM.prefill_logits(tcfg, tparams, {"tokens": tokens})
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_choices_match_reference(arch, monkeypatch):
    """Every layer's top-k expert ids on the training batch, token by token
    (the precondition of the gradient comparisons below)."""
    want = _reference_choices(arch, monkeypatch)
    jcfg, jparams = _reference(arch)
    tcfg, tparams = _port(arch, jparams)
    got = _port_choices(tcfg, tparams, _batch(arch)[1]["tokens"],
                        monkeypatch)
    assert len(got) == len(want) == jcfg.num_layers
    for layer, (g, w) in enumerate(zip(got, want)):
        assert g.shape == (B * S, jcfg.moe_top_k)
        np.testing.assert_array_equal(g, w, err_msg=f"{arch} layer {layer}")


@pytest.mark.parametrize("attn_impl,remat", CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grads_match_reference(arch, attn_impl, remat):
    """The causal-LM loss and the gradient of every leaf: router, experts,
    shared experts, MLA's low-rank projections and norms, embeddings."""
    want_loss, want_grads = _reference_loss_and_grads(arch, attn_impl, remat)
    _, jparams = _reference(arch)
    tcfg, tparams = _port(arch, jparams, attn_impl=attn_impl, remat=remat)
    flat = [p.requires_grad_() for p in pytree.leaves(tparams)]
    loss = TM.loss_fn(tcfg, pytree.unflatten(tparams, flat), _batch(arch)[1])
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(pytree.unflatten(tparams, list(grads)), want_grads,
                        GRAD_TOL, f"{arch} grads {attn_impl} remat={remat}")


def test_dispatch_gradient_with_capacity_drops_matches_reference():
    """The MoE block alone at a capacity factor that drops token-slots:
    the gradient through the router's top-k weights, the stable argsort,
    the buffer gather, the expert products and the combine, for the input
    and every weight, against ``jax.grad`` of the reference's block."""
    jcfg, jparams = _reference("olmoe_1b_7b")
    jcfg = dataclasses.replace(jcfg, moe_capacity_factor=0.5)
    tcfg = dataclasses.replace(treg.smoke_config("olmoe_1b_7b"),
                               dtype=torch.float32, moe_capacity_factor=0.5)
    jp = jax.tree.map(lambda x: x[0], jparams["blocks"]["moe"])
    tp = {k: torch.from_numpy(np.array(v, np.float32)).requires_grad_()
          for k, v in _to_np(jp).items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    cot = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    n = x.shape[0] * x.shape[1]
    _, top_e, _ = TMoE.route(tp, torch.from_numpy(x).reshape(n, -1), tcfg)
    _, _, keep = TMoE.dispatch(top_e, tcfg, n)
    assert 0 < int((~keep).sum()) < keep.numel()        # some slots drop

    def jloss(p, x):
        return jnp.sum(JMoE.moe_block(p, x, jcfg) * cot)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = TMoE.moe_block(tp, tx, tcfg)
    names = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [tp[k] for k in names] + [tx])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want_x),
                               err_msg="dx", **GRAD_TOL)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[name]),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_matches_reference(arch, monkeypatch):
    """Three steps of each package's ``train`` (smoke preset, float32,
    the registry's attn_impl) on the same weights: the port's draw is
    replaced by the reference's params crossed by interop."""
    jcfg, jparams = _reference(arch, seed=1)
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32)
    monkeypatch.setattr(jtrain.registry, "smoke_config", lambda a: jcfg)
    monkeypatch.setattr(ttrain.registry, "smoke_config", lambda a: tcfg)
    tparams = interop.lm_params_from_numpy(_to_np(jparams), tcfg,
                                           device="cpu")
    monkeypatch.setattr(ttrain.M, "init_params", lambda *a, **k: tparams)
    # the reference's step donates its params: hand it a copy
    monkeypatch.setattr(jtrain.M, "init_params", lambda *a, **k: jax.tree.map(
        jnp.copy, jparams))
    kw = dict(preset="smoke", steps=3, batch=2, seq=16, log_every=1000,
              lr=1e-3)
    want = jtrain.train(arch, **kw)
    got = ttrain.train(arch, device="cpu", **kw)
    assert len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
