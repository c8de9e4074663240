"""The port's dense LM (``repro_torch.models``) against the JAX reference on
the CPU: the same params (the reference's ``init_params``, carried across
as numpy by ``interop.lm_params_from_numpy``) and the same tokens through
both packages.  Tolerances are the reference's own (``tests/test_models.py``):
2e-4 for float32 logits, 3e-4 for the flash path against XLA's, and
atol 0.11 / rtol 0.05 wherever bfloat16 rounds at different places."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["smollm_135m", "olmo_1b"]
# Every dense config: gemma3-1b's smoke config exercises head_dim 32 with
# the 3:1 local/global sliding-window pattern, minicpm-2b's MHA at d 72.
DENSE_ARCHS = ARCHS + ["minicpm_2b", "gemma3_1b"]
B, S = 2, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=0.11, rtol=0.05)}


def _pair(arch, dtype="float32", seed=0, **fields):
    """(reference cfg, reference params, port cfg, port params)."""
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jreg.smoke_config(arch), dtype=jd, **fields)
    tcfg = dataclasses.replace(treg.smoke_config(arch), dtype=td, **fields)
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jax.tree.map(
        lambda x: x.astype(jnp.float32), params))
    return jcfg, params, tcfg, interop.lm_params_from_numpy(tree, tcfg,
                                                            device="cpu")


def _tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _port_logits(tcfg, tparams, toks):
    step = steps.make_prefill_step(tcfg, device="cpu")
    return step(tparams, {"tokens": torch.from_numpy(toks).long()}).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_logits_match_reference(arch, dtype):
    jcfg, jparams, tcfg, tparams = _pair(arch, dtype)
    toks = _tokens(jcfg)
    want = np.asarray(JM.prefill_logits(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = _port_logits(tcfg, tparams, toks)
    assert got.shape == (B, S, tcfg.padded_vocab) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("fields", [dict(gqa_grouped=True),
                                    dict(attn_chunk_q=4),
                                    dict(scan_layers=False)],
                         ids=["grouped", "chunked", "unrolled"])
def test_attention_variants_match_reference(fields):
    jcfg, jparams, tcfg, tparams = _pair("smollm_135m", **fields)
    toks = _tokens(jcfg)
    want = JM.prefill_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_port_logits(tcfg, tparams, toks),
                               np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("fields", [
    dict(local_global_pattern=3, sliding_window=8, num_layers=6,
         head_dim=32),
    dict(sliding_window=8)], ids=["local_global", "sliding"])
def test_window_attention_matches_reference(fields):
    """Sliding-window layers (the gemma3 pattern: local layers with a
    window, every third one global; and a window on every layer) in
    prefill and in decode, on a dense config that carries them."""
    jcfg = dataclasses.replace(jreg.smoke_config("smollm_135m"),
                               dtype=jnp.float32, **fields)
    tcfg = TM.ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(jcfg)
                             if f.name != "dtype"}, dtype=torch.float32)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = _tokens(jcfg)
    want = JM.prefill_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_port_logits(tcfg, tparams, toks),
                               np.asarray(want), **TOL["float32"])
    jcache = JM.init_cache(jcfg, B, S)
    tcache = TM.init_cache(tcfg, B, S, device="cpu")
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


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_prefill_matches_reference(arch):
    """attn_impl="flash" at S=256 (the flash path needs S >= 128; 256 is a
    length at which the reference's Pallas kernel, run in interpret mode,
    writes every row): the port's flash path against the reference's
    flash path, and against the port's own XLA-style path."""
    jcfg, jparams, tcfg, tparams = _pair(arch, attn_impl="flash")
    toks = _tokens(jcfg, s=256, seed=1)
    want = np.asarray(JM.prefill_logits(jcfg, jparams,
                                        {"tokens": jnp.asarray(toks)}))
    got = _port_logits(tcfg, tparams, toks)
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)
    xla = _port_logits(dataclasses.replace(tcfg, attn_impl="xla"), tparams,
                       toks)
    np.testing.assert_allclose(got, xla, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_logits_match_reference_per_step(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    toks = _tokens(jcfg)
    jcache = JM.init_cache(jcfg, B, S + 4)
    tcache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    step = steps.make_serve_step(tcfg, device="cpu")
    jstep = jax.jit(functools.partial(JM.serve_step, jcfg))
    for i in range(S):
        want, jcache = jstep(jparams, jcache,
                             {"tokens": jnp.asarray(toks[:, i:i + 1]),
                              "pos": jnp.int32(i)})
        got, tcache = step(tparams, tcache,
                           {"tokens": torch.from_numpy(toks[:, i:i + 1]).long(),
                            "pos": i})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """serve_step token by token reproduces the prefill logits at the last
    position (the reference's KV-cache check, on the port alone)."""
    _, _, tcfg, tparams = _pair(arch, dtype, seed=1)
    toks = torch.from_numpy(_tokens(tcfg)).long()
    want = TM.prefill_logits(tcfg, tparams, {"tokens": toks})[:, -1]
    cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    for i in range(S):
        got, cache = TM.serve_step(tcfg, tparams, cache,
                                   {"tokens": toks[:, i:i + 1], "pos": i})
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.11,
                               rtol=0.05)


def test_cache_write_past_the_end_raises():
    _, _, tcfg, tparams = _pair("smollm_135m")
    cache = TM.init_cache(tcfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="exceeds the cache length"):
        TM.serve_step(tcfg, tparams, cache,
                      {"tokens": torch.zeros((1, 1), dtype=torch.long),
                       "pos": 4})


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_match_reference(arch):
    """Full and smoke configs: every field equal to the reference's (dtype
    compared by name), and the smoke params' count equal."""
    for getter in ("config", "smoke_config"):
        want = getattr(jreg, getter)(arch)
        got = getattr(treg, getter)(arch)
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert str(b).split(".")[-1] == jnp.dtype(a).name
            else:
                assert a == b, (getter, f.name, a, b)
        assert got.padded_vocab == want.padded_vocab
    _, jparams, _, tparams = _pair(arch)
    assert TM.param_count(tparams) == JM.param_count(jparams)


def test_registry_lists_only_ported_archs():
    """The registry lists the reference's architectures, in its order;
    the models of the non-dense families are not ported yet."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("llama_70b")
    for arch in ("olmoe_1b_7b", "whisper_base", "xlstm_125m"):
        with pytest.raises(NotImplementedError, match="item 12"):
            TM.init_params(treg.smoke_config(arch),
                           torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("family,fields", [
    ("moe", dict(moe_num_experts=4, moe_top_k=2, moe_d_ff=32)),
    ("dense", dict(use_mla=True)), ("ssm", {}), ("hybrid", {}),
    ("encdec", {}), ("vlm", {})])
def test_unported_families_raise(family, fields):
    cfg = TM.ModelConfig(name="x", family=family, num_layers=1, d_model=16,
                         num_heads=2, num_kv_heads=2, d_ff=32,
                         vocab_size=64, **fields)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_init_params_is_seeded_and_device_independent():
    cfg = treg.smoke_config("smollm_135m")
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert a["blocks"]["attn"]["wq"].shape == (2, 48, 48)
    assert a["embed"]["tok"].dtype == torch.bfloat16
    assert TM.param_count(a) == TM.param_count(b)
