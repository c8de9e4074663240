"""The port's architecture configs (``repro_torch.configs``) against the JAX
package's: every field of all ten full and smoke configs, the cost profiles
bit for bit at two sequence lengths and two batch sizes, the shape set and
its skip rule, and the registry's lists."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg, shapes as jshapes  # noqa: E402
from repro_torch.configs import registry as treg, shapes as tshapes  # noqa: E402
from repro_torch.costs.lm import cost_profile as lm_cost_profile  # noqa: E402


def test_registry_lists_equal_reference():
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert treg.PAPER_MODELS == jreg.PAPER_MODELS
    assert treg.get("gemma3-1b") is treg.get("gemma3_1b")
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("llama_70b")


@pytest.mark.parametrize("getter", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_match_reference(arch, getter):
    """Every field equal to the reference's; the dtype maps by name."""
    want = getattr(jreg, getter)(arch)
    got = getattr(treg, getter)(arch)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "dtype":
            assert isinstance(b, torch.dtype)
            assert str(b).split(".")[-1] == jnp.dtype(a).name
        else:
            assert a == b, (getter, f.name, a, b)
    assert got.padded_vocab == want.padded_vocab
    assert got.sub_quadratic == want.sub_quadratic


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("seq_len", [128, 2048])
@pytest.mark.parametrize("arch", jreg.ARCH_IDS + jreg.PAPER_MODELS)
def test_cost_profile_matches_reference(arch, seq_len, batch):
    """Bit for bit, through the registry's dispatch and the module's own
    entry point (the conv nets take ``batch`` only)."""
    want = jreg.cost_profile(arch, seq_len=seq_len, batch=batch)
    got = treg.cost_profile(arch, seq_len=seq_len, batch=batch)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if arch in jreg.ARCH_IDS:
        direct = treg.get(arch).cost_profile(seq_len=seq_len, batch=batch)
        for a, b in zip(direct, want):
            np.testing.assert_array_equal(a, b)


def test_shapes_match_reference():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, spec in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == \
            dataclasses.asdict(spec)
    for arch in jreg.ARCH_IDS:
        for name in jshapes.SHAPES:
            assert tshapes.shape_applicable(
                treg.config(arch), tshapes.SHAPES[name]) == \
                jshapes.shape_applicable(jreg.config(arch),
                                         jshapes.SHAPES[name])
    runs = [a for a in jreg.ARCH_IDS if tshapes.shape_applicable(
        treg.config(a), tshapes.SHAPES["long_500k"])[0]]
    assert runs == ["xlstm_125m", "zamba2_2_7b"]


def test_lm_cost_profile_consistency():
    """Mirror of ``tests/test_system.py::test_lm_cost_profile_consistency``."""
    cfg = treg.config("olmo_1b")
    comp, data = lm_cost_profile(cfg, seq_len=2048, batch=1)
    assert len(comp) == cfg.num_layers + 2
    assert len(data) == len(comp) + 1
    # forward flops approximately 2 * params * tokens
    assert 0.5 < comp.sum() / (2 * 1.18e9 * 2048) < 2.0
    # MLA arch moves less data per layer than an equivalent dense stack
    ds = treg.config("deepseek_v2_236b")
    comp_d, data_d = lm_cost_profile(ds, seq_len=2048, batch=1)
    assert data_d[1] == 2048 * ds.d_model * 2


def test_full_width_dense_configs_shapes():
    """The two dense configs the card drives at full width: minicpm-2b has
    no GQA repeat (36 KV heads over 36) and head_dim 64; gemma3-1b has
    head_dim 256 and a 5:1 local/global window pattern."""
    m = treg.config("minicpm_2b")
    assert (m.num_layers, m.d_model, m.num_heads, m.num_kv_heads,
            m.head_dim, m.d_ff, m.vocab_size) == (40, 2304, 36, 36, 64,
                                                  5760, 122753)
    g = treg.config("gemma3_1b")
    assert (g.num_layers, g.d_model, g.head_dim, g.num_kv_heads,
            g.local_global_pattern, g.sliding_window) == (26, 1152, 256, 1,
                                                          6, 512)
