"""The olmoe-1b-7b and deepseek-v2 smoke models in the port against the
JAX reference on the CPU: prefill logits, decode steps, the decode
engine, the weights carried across by ``interop`` and the configs.  The
blocks alone, the helpers and the tolerances are in
``test_torch_moe_mla.py``, whose docstring says why the models' logits
are compared in float32 only."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JEng  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TEng  # noqa: E402
from test_torch_models import TOL  # noqa: E402
from test_torch_moe_mla import B, MOE_ARCHS, S, _pair, _to_np, _tokens  # noqa: E402


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scan", "unrolled"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_logits_match_reference(arch, scan_layers):
    """float32 logits against both of the reference's forms (its layer
    scan and its unrolled loop; the port computes the same function for
    either setting)."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    jcfg, tcfg = (dataclasses.replace(c, scan_layers=scan_layers)
                  for c in (jcfg, tcfg))
    toks = _tokens(jcfg)
    want = np.asarray(JM.prefill_logits(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)}))
    got = TM.prefill_logits(tcfg, tparams,
                            {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_step_logits_match_reference_per_step(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    toks = _tokens(jcfg)
    jcache = JM.init_cache(jcfg, B, S + 4)
    tcache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    jstep = jax.jit(functools.partial(JM.serve_step, jcfg))
    for i in range(S):
        want, jcache = jstep(jparams, jcache,
                             {"tokens": jnp.asarray(toks[:, i:i + 1]),
                              "pos": jnp.int32(i)})
        got, tcache = TM.serve_step(
            tcfg, tparams, tcache,
            {"tokens": torch.from_numpy(toks[:, i:i + 1]).long(), "pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
    assert set(tcache) == set(jcache)
    for key in tcache:
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """serve_step token by token reproduces the prefill logits at the last
    position (the reference's cache check, on the port alone)."""
    _, _, tcfg, tparams = _pair(arch, dtype, seed=1)
    toks = torch.from_numpy(_tokens(tcfg)).long()
    want = TM.prefill_logits(tcfg, tparams, {"tokens": toks})[:, -1]
    cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    for i in range(S):
        got, cache = TM.serve_step(tcfg, tparams, cache,
                                   {"tokens": toks[:, i:i + 1], "pos": i})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.11,
                               rtol=0.05)


def test_flash_prefill_matches_reference_and_xla():
    """deepseek-v2 with attn_impl="flash" at S=256 (the reference's Pallas
    kernel in interpret mode; in the port, q/k width 24 and v width 16)
    against the reference's flash path and the port's XLA-style path."""
    jcfg, jparams, tcfg, tparams = _pair("deepseek_v2_236b")
    jcfg, tcfg = (dataclasses.replace(c, attn_impl="flash")
                  for c in (jcfg, tcfg))
    toks = _tokens(jcfg, s=256, seed=1)
    want = np.asarray(JM.prefill_logits(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)}))
    tt = {"tokens": torch.from_numpy(toks).long()}
    got = TM.prefill_logits(tcfg, tparams, tt).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    xla = TM.prefill_logits(dataclasses.replace(tcfg, attn_impl="xla"),
                            tparams, tt).numpy()
    np.testing.assert_allclose(got, xla, atol=3e-4, rtol=3e-4)


def test_moe_local_dispatch_under_auto_mesh_matches_port():
    """The reference's per-shard dispatch (``moe_local_dispatch``) under a
    one-device mesh with ``Auto`` axes equals the port, which runs the
    global dispatch for both settings of the flag."""
    jcfg, jparams, tcfg, tparams = _pair("olmoe_1b_7b")
    jcfg, tcfg = (dataclasses.replace(c, moe_capacity_factor=8.0,
                                      moe_local_dispatch=True)
                  for c in (jcfg, tcfg))
    toks = np.arange(32).reshape(2, 16) % jcfg.vocab_size
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    with jax.set_mesh(mesh):
        want = JM.prefill_logits(jcfg, jparams,
                                 {"tokens": jnp.asarray(toks)})
    tt = {"tokens": torch.from_numpy(toks).long()}
    got = TM.prefill_logits(tcfg, tparams, tt).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])
    glob = TM.prefill_logits(dataclasses.replace(
        tcfg, moe_local_dispatch=False), tparams, tt).numpy()
    assert np.array_equal(got, glob)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_engine_tokens_match_reference(arch):
    """Greedy decode through both packages' ``DecodeEngine``, float32."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    prompts = _tokens(jcfg, s=6, seed=3)
    want = JEng.DecodeEngine(jcfg, jparams, max_len=16).generate(
        jnp.asarray(prompts), 8, prefill_mode="per_token")
    got = TEng.DecodeEngine(tcfg, tparams, max_len=16,
                            device="cpu").generate(prompts, 8)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_weights_cross_by_interop(arch, dtype):
    """The MoE and MLA trees cross from the reference and back unchanged,
    the router float32 at every dtype; the param counts equal."""
    _, jparams, tcfg, tparams = _pair(arch, dtype)
    back = interop.lm_params_to_numpy(tparams)
    want = _to_np(jparams)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.array_equal(a, b)
    moe = tparams["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == tcfg.dtype
    assert TM.param_count(tparams) == JM.param_count(jparams)
    if tcfg.use_mla:
        assert {"w_uk", "w_uv", "kv_a_norm", "w_q_a", "w_q_b"} <= \
            set(tparams["blocks"]["attn"])
        assert "shared" in moe


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_and_init_match_reference(arch):
    """Full and smoke configs field for field; the port's own init is
    seeded, has the reference's tree and param count, and keeps the
    router float32 in a bf16 config."""
    for getter in ("config", "smoke_config"):
        want = getattr(jreg, getter)(arch)
        got = getattr(treg, getter)(arch)
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    cfg = treg.smoke_config(arch)
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(jax.tree.leaves(interop.lm_params_to_numpy(a)),
                    jax.tree.leaves(interop.lm_params_to_numpy(b))):
        assert np.array_equal(x, y)
    _, jparams, _, _ = _pair(arch)
    assert jax.tree.structure(interop.lm_params_to_numpy(a)) == \
        jax.tree.structure(_to_np(jparams))
    assert TM.param_count(a) == JM.param_count(jparams)
    assert a["blocks"]["moe"]["router"].dtype == torch.float32
    assert a["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
