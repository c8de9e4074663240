"""The port's MoE and MLA blocks (``repro_torch.models.moe``, ``.mla``) and
the olmoe-1b-7b / deepseek-v2 smoke models against the JAX reference on
the CPU: the mirror of ``tests/test_moe_mla.py``, plus parity with the
reference's functions on the same weights and inputs.

Tolerances are the reference's own: the dense oracle at atol 2e-4 /
rtol 2e-3, float32 logits at 2e-4 and the flash path at 3e-4
(``test_torch_models.TOL``), bf16 at atol 0.11 / rtol 0.05.

Top-k routing is discontinuous: where a token's k-th and (k+1)-th router
probabilities lie within rounding of each other, two correct evaluations
may pick different experts.  So the block test compares expert choices
and kept slots wherever that margin exceeds float32 rounding, and counts
the tokens inside it (0 at these seeds).  For the same reason the smoke
models' logits (``test_torch_moe_mla_models.py``) are compared in float32
only: in bf16 the reference's own
two forms of one model -- its layer scan and its unrolled loop
(``scan_layers``) -- round differently and route a token or two of 32 to
other experts, which moves their logits by 0.21 (olmoe) and 0.78
(deepseek-v2), beyond bf16's atol 0.11.  bf16 is held by the port's
decode against its own prefill at the reference's atol 0.11 / rtol 0.05,
as the reference holds itself."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import mla as JMLA, model as JM, moe as JMoE  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import mla as TMLA, model as TM, moe as TMoE  # noqa: E402
from test_torch_models import TOL  # noqa: E402

MOE_ARCHS = ["olmoe_1b_7b", "deepseek_v2_236b"]
B, S = 2, 16
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype="float32", **fields):
    jd, td = DTYPES[dtype]
    return (dataclasses.replace(jreg.smoke_config(arch), dtype=jd, **fields),
            dataclasses.replace(treg.smoke_config(arch), dtype=td, **fields))


def _to_np(tree):
    return jax.tree.map(np.asarray, jax.tree.map(
        lambda x: x.astype(jnp.float32), tree))


def _to_torch(tree, dtype):
    """A reference param subtree as port tensors (the router float32)."""
    def conv(x, key=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(
            torch.float32 if key == "router" else dtype)
    return conv(_to_np(tree))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32", seed=0):
    """(reference cfg, params, port cfg, params): the reference's
    ``init_params`` carried across by ``interop.lm_params_from_numpy``."""
    jcfg, tcfg = _cfgs(arch, dtype)
    params = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, params, tcfg, interop.lm_params_from_numpy(
        _to_np(params), tcfg, device="cpu")


def _tokens(cfg, b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# -- MoE ----------------------------------------------------------------------

def test_ranks_in_expert():
    e = torch.tensor([0, 0, 1, 1, 1, 3, 3, 5])
    assert TMoE._ranks_in_expert(e).tolist() == [0, 1, 0, 1, 2, 0, 1, 0]
    rng = np.random.default_rng(0)
    for n in (1, 7, 64, 300):
        ids = np.sort(rng.integers(0, 9, n))
        assert TMoE._ranks_in_expert(torch.from_numpy(ids)).tolist() == \
            np.asarray(JMoE._ranks_in_expert(jnp.asarray(ids))).tolist()


def test_moe_matches_dense_oracle():
    """With ample capacity, the sort/gather dispatch equals computing every
    token's top-k experts densely."""
    _, cfg = _cfgs("olmoe_1b_7b", moe_capacity_factor=8.0)
    p = TMoE.init_moe(torch.Generator().manual_seed(0), cfg,
                      torch.device("cpu"))
    _, x = _x((2, 5, cfg.d_model))
    got = TMoE.moe_block(p, x, cfg).reshape(-1, cfg.d_model)
    xf = x.reshape(-1, cfg.d_model)
    top_w, top_e, _ = TMoE.route(p, xf, cfg)
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(cfg.moe_top_k):
            e = int(top_e[t, j])
            h = torch.nn.functional.silu(xf[t] @ p["w_gate"][e]) \
                * (xf[t] @ p["w_up"][e])
            want[t] += float(top_w[t, j]) * (h @ p["w_down"][e])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=2e-3)


def test_moe_capacity_drops_are_bounded():
    """With capacity factor 1.0 the outputs stay finite, some pairs are
    dropped, and every token that kept all its k pairs equals its uncapped
    result (drops only zero out contributions).  128 tokens: at n <= 64
    every token gets capacity n and nothing drops."""
    _, cfg = _cfgs("olmoe_1b_7b", moe_capacity_factor=1.0)
    p = TMoE.init_moe(torch.Generator().manual_seed(0), cfg,
                      torch.device("cpu"))
    _, x = _x((4, 32, cfg.d_model))
    out = TMoE.moe_block(p, x, cfg).reshape(-1, cfg.d_model)
    assert torch.isfinite(out).all()
    full = TMoE.moe_block(p, x, dataclasses.replace(
        cfg, moe_capacity_factor=8.0)).reshape(-1, cfg.d_model)
    n, k = out.shape[0], cfg.moe_top_k
    _, top_e, _ = TMoE.route(p, x.reshape(n, -1), cfg)
    order, _, keep = TMoE.dispatch(top_e, cfg, n)
    kept = torch.empty_like(keep)
    kept[order] = keep
    whole = kept.reshape(n, k).all(1)
    assert 0 < int((~keep).sum()) < n * k
    np.testing.assert_allclose(out[whole].numpy(), full[whole].numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch,shape,cf", [
    ("olmoe_1b_7b", (2, 16), 1.25),    # n = 32 <= 64: capacity n
    ("olmoe_1b_7b", (4, 32), 1.25),    # n = 128: capacity drops
    ("olmoe_1b_7b", (4, 32), 0.5),
    ("deepseek_v2_236b", (4, 32), 1.25)])  # shared experts
def test_moe_block_matches_reference(arch, shape, cf):
    """float32: the port's block against the reference's on the same
    weights and input; expert choices and kept pairs equal wherever the
    k-th and (k+1)-th router probabilities lie more than float32 rounding
    apart (the count of tokens inside that margin is printed)."""
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf)
    jp = JMoE.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = _to_torch(jp, torch.float32)
    jx, tx = _x(shape + (jcfg.d_model,), seed=5)
    want = np.asarray(JMoE.moe_block(jp, jx, jcfg))
    got = TMoE.moe_block(tp, tx, tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL["float32"])

    n, k = shape[0] * shape[1], jcfg.moe_top_k
    jprobs = jax.nn.softmax(jx.reshape(n, -1) @ jp["router"], axis=-1)
    _, jtop_e = jax.lax.top_k(jprobs, k)
    jorder = jnp.argsort(jtop_e.reshape(-1), stable=True)
    cap = n if n <= 64 else int(cf * n * k / jcfg.moe_num_experts) + 1
    jkeep = np.asarray(JMoE._ranks_in_expert(
        jtop_e.reshape(-1)[jorder]) < cap)
    _, ttop_e, tprobs = TMoE.route(tp, tx.reshape(n, -1), tcfg)
    order, _, keep = TMoE.dispatch(ttop_e, tcfg, n)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    close = (srt[:, k - 1] - srt[:, k]) <= 4 * np.spacing(srt[:, k - 1])
    print(f"{arch} {shape} cf {cf}: {int(close.sum())} of {n} tokens "
          f"within float32 rounding of a routing tie")
    assert not close.any()
    assert ttop_e.numpy().tolist() == np.asarray(jtop_e).tolist()
    assert order.numpy().tolist() == np.asarray(jorder).tolist()
    assert keep.numpy().tolist() == jkeep.tolist()
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=1e-7, rtol=1e-6)


# -- MLA ----------------------------------------------------------------------

def test_mla_latent_cache_shape():
    """MLA decode caches latents, not per-head K/V -- the memory win."""
    cfg = treg.smoke_config("deepseek_v2_236b")
    cache = TM.init_cache(cfg, 2, 32, device="cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (cfg.num_layers, 2, 32, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (cfg.num_layers, 2, 32,
                                     cfg.qk_rope_head_dim)
    latent_w = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    per_head_w = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    assert latent_w < per_head_w
    jcache = JM.init_cache(jreg.smoke_config("deepseek_v2_236b"), 2, 32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_mla_full_config_cache_ratio():
    cfg = treg.config("deepseek_v2_236b")
    latent = cfg.kv_lora_rank + cfg.qk_rope_head_dim          # 576
    mha = cfg.num_heads * 2 * cfg.v_head_dim                  # 32768
    assert mha / latent > 50


@pytest.mark.parametrize("form,s,fields", [
    ("materialized", 16, {}),
    ("chunked", 16, dict(attn_chunk_q=4)),
    ("flash", 128, dict(attn_impl="flash")),
    ("chunked-long", 128, dict(attn_chunk_q=32))])
def test_mla_attention_forms_match_reference(form, s, fields):
    """float32 prefill forms on the same weights and input; the flash form
    runs the reference's Pallas kernel in interpret mode and the port's
    kernel's plain version (q/k width 24 against v width 16)."""
    jcfg, tcfg = _cfgs("deepseek_v2_236b", **fields)
    jp = JMLA.init_mla(jax.random.PRNGKey(7), jcfg)
    tp = _to_torch(jp, torch.float32)
    jx, tx = _x((2, s, jcfg.d_model), seed=s)
    pos = np.arange(s)[None, :]
    want, _ = JMLA.mla_attention(jp, jx, jnp.asarray(pos), jcfg)
    got, cache = TMLA.mla_attention(tp, tx, torch.from_numpy(pos), tcfg)
    assert cache is None
    tol = dict(atol=3e-4, rtol=3e-4) if form == "flash" else TOL["float32"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_mla_absorbed_decode_matches_reference():
    """The absorbed latent-cache decode, step by step, against the
    reference's: outputs and the cache contents."""
    jcfg, tcfg = _cfgs("deepseek_v2_236b")
    jp = JMLA.init_mla(jax.random.PRNGKey(8), jcfg)
    tp = _to_torch(jp, torch.float32)
    jx, tx = _x((2, S, jcfg.d_model), seed=9)
    layer = {k: v[0] for k, v in JMLA.init_mla_cache(jcfg, 2, S + 3).items()}
    tcache = {k: v[0] for k, v in TMLA.init_mla_cache(
        tcfg, 2, S + 3, torch.device("cpu")).items()}
    for i in range(S):
        want, layer = JMLA.mla_attention(
            jp, jx[:, i:i + 1], jnp.full((1, 1), i), jcfg, kv_cache=layer,
            cache_pos=i)
        got, tcache = TMLA.mla_attention(
            tp, tx[:, i:i + 1], torch.full((1, 1), i), tcfg,
            kv_cache=tcache, cache_pos=i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(layer[key]), **TOL["float32"])
    with pytest.raises(ValueError, match="exceeds the cache length"):
        TMLA.mla_attention(tp, tx[:, :1], torch.zeros((1, 1)), tcfg,
                           kv_cache=tcache, cache_pos=S + 3)
