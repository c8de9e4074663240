"""The xlstm-125m, zamba2-2.7b, whisper-base and phi-3-vision-4.2b smoke
models in the port against the JAX reference on the CPU: prefill logits
(both of the reference's layer forms), every decode step with the
recurrent states or caches after it, the port's own decode == prefill,
the vlm prefill with patches through flash and xla, the decode engine's
tokens, ``launch/serve.run`` and the configs.  Params come from the
reference's ``init_params`` and cross by ``interop``; inputs are drawn
with numpy.  Tolerances are ``test_torch_models.py``'s: float32 at
atol = rtol = 2e-4, flash against xla at 3e-4, decode == prefill at
atol 0.11, rtol 0.05."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as JEng  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.kernels import flash  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import engine as TEng  # noqa: E402
from test_torch_models import DTYPES, TOL  # noqa: E402

FAMILY_ARCHS = ["xlstm_125m", "zamba2_2_7b", "whisper_base",
                "phi3_vision_4_2b"]
B, S = 2, 12


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


def _batch(cfg, b=B, s=S, seed=0) -> dict:
    """numpy tokens, plus frames (encdec) or patches (vlm) at the config's
    count, standard normal."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol=TOL["float32"], what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=what,
                               **tol)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scan", "unrolled"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_logits_match_reference(arch, scan_layers):
    jcfg, jparams, tcfg, tparams = _pair(arch, scan_layers=scan_layers)
    batch = _batch(jcfg)
    want = JM.prefill_logits(jcfg, jparams, _jax(batch))
    got = steps.make_prefill_step(tcfg, device="cpu")(tparams, batch)
    assert got.shape == (B, S, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    _close(got, want)


def _enc_out(jcfg, jparams, tcfg, tparams, frames):
    """(reference, port) encoder outputs of the same frames; they agree."""
    want = jencdec.encode(jcfg, jparams, jnp.asarray(frames), remat=False)
    with torch.no_grad():
        got = tencdec.encode(tcfg, tparams, torch.from_numpy(frames),
                             remat=False)
    _close(got, want, what="encoder output")
    return want, got


def _step_extras(jcfg, jparams, tcfg, tparams, batch):
    if jcfg.family != "encdec":
        return {}, {}
    jenc, tenc = _enc_out(jcfg, jparams, tcfg, tparams, batch["frames"])
    return {"enc_out": jenc}, {"enc_out": tenc}


def _state_leaves(cache) -> dict:
    if isinstance(cache, dict):
        return dict(pytree.items(cache))
    return {"/".join(str(k.key) for k in path): x
            for path, x in jax.tree_util.tree_flatten_with_path(cache)[0]}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_step_logits_and_states_match_reference(arch):
    """Every decode step's logits, and every leaf of the state or cache
    after it (xLSTM's matrix and scalar memories, Zamba2's per-group KV
    caches and per-layer Mamba2 states, Whisper's decoder cache)."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(jcfg)
    jx, tx = _step_extras(jcfg, jparams, tcfg, tparams, batch)
    jcache = JM.init_cache(jcfg, B, S + 4)
    tcache = TM.init_cache(tcfg, B, S + 4, device="cpu")
    assert sorted(_state_leaves(tcache)) == sorted(_state_leaves(jcache))
    jstep = jax.jit(functools.partial(JM.serve_step, jcfg))
    step = steps.make_serve_step(tcfg, device="cpu")
    toks = batch["tokens"]
    for i in range(S):
        want, jcache = jstep(jparams, jcache,
                             {"tokens": jnp.asarray(toks[:, i:i + 1]),
                              "pos": jnp.int32(i), **jx})
        got, tcache = step(tparams, tcache,
                           {"tokens": toks[:, i:i + 1], "pos": i, **tx})
        _close(got, want, what=f"logits at step {i}")
        want_st = _state_leaves(jcache)
        for key, leaf in _state_leaves(tcache).items():
            _close(leaf, want_st[key], what=f"{key} after step {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """serve_step token by token reproduces the prefill logits at every
    position (the reference's check, on the port alone; vlm decodes text
    only, so its prefill here has no patches)."""
    _, _, tcfg, tparams = _pair(arch, dtype, seed=1)
    batch = _torch(_batch(tcfg, seed=1))
    batch.pop("patches", None)
    with torch.no_grad():
        want = TM.prefill_logits(tcfg, tparams, batch)
        extra = {}
        if tcfg.family == "encdec":
            extra["enc_out"] = tencdec.encode(tcfg, tparams, batch["frames"])
        cache = TM.init_cache(tcfg, B, S + 4, device="cpu")
        for i in range(S):
            got, cache = TM.serve_step(
                tcfg, tparams, cache,
                {"tokens": batch["tokens"][:, i:i + 1], "pos": i, **extra})
            _close(got, want[:, i], TOL["bfloat16"], f"position {i}")


def _spy_flash(monkeypatch) -> list:
    """The [BH, S, d] shapes of every flash forward call from here on."""
    calls, fwd = [], flash.flash_fwd_lse

    def spy(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return fwd(q, *args, **kwargs)

    monkeypatch.setattr(flash, "flash_fwd_lse", spy)
    return calls


@pytest.mark.parametrize("arch", ["zamba2_2_7b", "whisper_base",
                                  "xlstm_125m"])
def test_flash_config_launches_no_flash(arch, monkeypatch):
    """These families never take the flash kernel, whatever attn_impl says
    (the reference's hybrid and encdec blocks never pass it on, and xLSTM
    has no attention); at S = 160 the dense path would."""
    _, _, tcfg, tparams = _pair(arch, attn_impl="flash")
    calls = _spy_flash(monkeypatch)
    steps.make_prefill_step(tcfg, device="cpu")(
        tparams, _batch(tcfg, s=160, seed=2))
    assert not calls


def test_vlm_flash_prefill_with_patches_matches_reference_and_xla(
        monkeypatch):
    """phi-3-vision with its 8 smoke patches and S = 120 (P + S = 128,
    where the reference's flash path starts): the port's flash path
    against the reference's (the Pallas kernel in interpret mode) and
    against the port's xla path; the patch positions' logits dropped."""
    jcfg, jparams, tcfg, tparams = _pair("phi3_vision_4_2b",
                                         attn_impl="flash")
    batch = _batch(jcfg, s=120, seed=3)
    assert jcfg.num_patches + 120 == 128
    want = JM.prefill_logits(jcfg, jparams, _jax(batch))
    calls = _spy_flash(monkeypatch)
    got = steps.make_prefill_step(tcfg, device="cpu")(tparams, batch)
    hd = tcfg.d_model // tcfg.num_heads
    assert calls == [(B * tcfg.num_heads, 128, hd)] * tcfg.num_layers
    assert got.shape == (B, 120, tcfg.padded_vocab)
    _close(got, want, dict(atol=3e-4, rtol=3e-4))
    xla = steps.make_prefill_step(dataclasses.replace(tcfg, attn_impl="xla"),
                                  device="cpu")(tparams, batch)
    _close(got, xla.numpy(), dict(atol=3e-4, rtol=3e-4))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_engine_tokens_match_reference(arch):
    """Greedy tokens of both engines (Whisper with the encoder output of
    the same frames passed as ``extra_batch``)."""
    jcfg, jparams, tcfg, tparams = _pair(arch)
    batch = _batch(jcfg, b=3, s=5, seed=4)
    jx, tx = _step_extras(jcfg, jparams, tcfg, tparams, batch)
    want = JEng.DecodeEngine(jcfg, jparams, max_len=24).generate(
        batch["tokens"], gen_len=8, extra_batch=jx)
    got = TEng.DecodeEngine(tcfg, tparams, max_len=24,
                            device="cpu").generate(batch["tokens"], 8,
                                                   extra_batch=tx)
    assert got.tokens.shape == (3, 8) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_run_serves_each_family(arch):
    """``launch/serve.run`` on the CPU: its plan equals the reference
    scheduler's, and its tokens are the port's engine's on the same
    weights (Whisper's against the encoding of zero frames)."""
    sched, plans, res = tserve.run(arch, requests=2, gen=4, prompt_len=4,
                                   device="cpu", verbose=False)
    js = jsched.RoutedScheduler(jserve.default_cluster())
    want = js.schedule([jsched.Request(arch, src=0, dst=5, seq_len=2048,
                                       name=f"req{i}") for i in range(2)])
    assert [(p.job_name, p.priority, p.bound_s, p.nodes_used)
            for p in plans] == [(p.job_name, p.priority, p.bound_s,
                                 p.nodes_used) for p in want]
    cfg = treg.smoke_config(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    extra = {}
    if cfg.family == "encdec":
        extra["enc_out"] = tencdec.encode(
            cfg, params, torch.zeros((2, cfg.num_frames, cfg.d_model),
                                     dtype=cfg.dtype), remat=False)
    prompts = np.tile(np.arange(4, dtype=np.int32)[None], (2, 1))
    again = TEng.DecodeEngine(cfg, params, max_len=16, device="cpu").generate(
        prompts, 4, extra_batch=extra)
    np.testing.assert_array_equal(res.tokens, again.tokens)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_configs_and_params_match_reference(arch):
    """Full and smoke configs equal the reference's field by field; the
    port's own init gives the reference's tree, shapes and dtypes (bf16,
    float32 where the reference keeps it), and its param count."""
    for getter in ("config", "smoke_config"):
        want = getattr(jreg, getter)(arch)
        got = getattr(treg, getter)(arch)
        for f in dataclasses.fields(want):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert str(b).split(".")[-1] == jnp.dtype(a).name
            else:
                assert a == b, (getter, f.name, a, b)
    jparams = JM.init_params(jreg.smoke_config(arch), jax.random.PRNGKey(0))
    tparams = TM.init_params(treg.smoke_config(arch),
                             torch.Generator().manual_seed(0), device="cpu")
    want = _state_leaves(jparams)
    got = dict(pytree.items(tparams))
    assert sorted(got) == sorted(want)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == want[key].shape, key
        assert str(leaf.dtype).split(".")[-1] == jnp.dtype(
            want[key].dtype).name, key
    assert TM.param_count(tparams) == JM.param_count(jparams)


def test_unknown_family_raises():
    cfg = TM.ModelConfig(name="x", family="rnn", num_layers=1, d_model=16,
                         num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64)
    with pytest.raises(ValueError, match="rnn"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="rnn"):
        TM.init_cache(cfg, 1, 4, device="cpu")
