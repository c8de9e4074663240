"""``loss_fn`` and its gradients for the xlstm-125m, zamba2-2.7b,
whisper-base and phi-3-vision-4.2b smoke models, and ``launch/train``'s
``train`` (with whisper-base's zero frames and phi-3-vision's zero
patches), in the port against the JAX reference on the CPU in float32.
Params come from the reference's ``init_params`` and cross by
``interop``; batches are the same ``SyntheticStream`` tokens in both
packages.  Tolerances are ``test_torch_train.py``'s: the loss at rtol
1e-5, gradients per leaf at atol 1e-5, rtol 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_families import FAMILY_ARCHS, _batch, _jax, _torch  # noqa: E402
from test_torch_train import GRAD_TOL, _assert_trees_close  # noqa: E402

B, S = 2, 16


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "plain"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """The causal-LM loss (a quarter of the labels masked with -1) and the
    gradient of every leaf, with remat on and off (it recomputes Zamba2's
    Mamba2 layers, Whisper's blocks and phi-3-vision's blocks in the
    backward)."""
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32,
                               remat=remat)
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32,
                               remat=remat)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    batch = _batch(jcfg, b=B, s=S, seed=5)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, ::4] = -1
    batch["labels"] = labels
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jax(batch))))(jparams)
    flat = [p.requires_grad_() for p in pytree.leaves(tparams)]
    tbatch = _torch(batch)
    tbatch["labels"] = tbatch["labels"].long()
    loss = TM.loss_fn(tcfg, pytree.unflatten(tparams, flat), tbatch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_trees_close(pytree.unflatten(tparams, list(grads)), want_grads,
                        GRAD_TOL, f"{arch} grads remat={remat}")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_matches_reference(arch, monkeypatch):
    """Three steps of each package's ``train`` (smoke preset, float32) on
    the same weights: the port's draw is replaced by the reference's params
    crossed by interop, so the losses, which take the zero frames or zero
    patches ``train`` adds for whisper and phi-3-vision, agree step by
    step (xLSTM's leaves that no layer reads get a zero gradient and
    AdamW's weight decay in both)."""
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32)
    monkeypatch.setattr(jtrain.registry, "smoke_config", lambda a: jcfg)
    monkeypatch.setattr(ttrain.registry, "smoke_config", lambda a: tcfg)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    monkeypatch.setattr(ttrain.M, "init_params", lambda *a, **k: (
        interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     tcfg, device="cpu")))
    kw = dict(preset="smoke", steps=3, batch=2, seq=16, log_every=1000,
              lr=1e-3)
    want = jtrain.train(arch, **kw)
    got = ttrain.train(arch, device="cpu", **kw)
    assert len(got.losses) == 3
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)


def test_zero_patches_overflow_the_gradients_at_depth_in_both():
    """``train()``'s zero patches leave every patch row's residual stream
    exactly 0 in every layer, so each RMSNorm backward multiplies those
    rows' gradient by rsqrt(1e-6) = 1000: at 19 layers it overflows, and
    0 x inf makes weight gradients NaN -- in the reference and in the port
    alike, for the same leaves (why the card's phi-3-vision train steps
    take standard-normal patches)."""
    fields = dict(dtype=jnp.float32, num_layers=19)
    jcfg = dataclasses.replace(jreg.smoke_config("phi3_vision_4_2b"),
                               **fields)
    tcfg = dataclasses.replace(treg.smoke_config("phi3_vision_4_2b"),
                               **{**fields, "dtype": torch.float32})
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, S))
    batch = {"tokens": toks.astype(np.int32),
             "labels": np.roll(toks, -1, axis=1).astype(np.int32),
             "patches": np.zeros((1, jcfg.num_patches, jcfg.d_model),
                                 np.float32)}
    _, want = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, _jax(batch))))(jparams)
    flat = [p.requires_grad_() for p in pytree.leaves(tparams)]
    tbatch = _torch(batch)
    tbatch["labels"] = tbatch["labels"].long()
    loss = TM.loss_fn(tcfg, pytree.unflatten(tparams, flat), tbatch)
    grads = torch.autograd.grad(loss, flat)
    bad_ref = {"/".join(str(k.key) for k in path) for path, g in
               jax.tree_util.tree_flatten_with_path(want)[0]
               if not np.isfinite(np.asarray(g)).all()}
    bad_port = {key for (key, _), g in zip(pytree.items(tparams), grads)
                if not bool(torch.isfinite(g).all())}
    assert bad_ref and bad_port == bad_ref
    assert np.isfinite(loss.item())
