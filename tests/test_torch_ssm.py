"""The blocks of the port's recurrent and encoder-decoder families
(``repro_torch.models.ssm``, the cross-attention and ungated MLP of
``repro_torch.models.common``) against the JAX reference on the CPU, in
float32: the same block params (the reference's init, carried across as
numpy) and the same numpy-seeded inputs and states through both packages,
at ``TOL["float32"]`` (atol = rtol = 2e-4; ``test_torch_models.py``).
Also the float32 leaves Mamba2 keeps under a bfloat16 config."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_models import TOL  # noqa: E402

B = 3


def _cfgs(arch, **fields):
    """(reference cfg, port cfg): the smoke config in float32."""
    return (dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32,
                                **fields),
            dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32,
                                **fields))


def _to_torch(tree):
    return pytree.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                           jax.tree.map(np.asarray, tree))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=what, **TOL["float32"])


def _close_trees(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        _close(got[k], want[k], f"{what}: {k}")


def _random_state(rng, fresh: dict, kind: str) -> dict:
    """A state of ``fresh``'s shapes: the fresh one, or random values
    (normalisers and memories of either sign, stabilisers around 0)."""
    if kind == "fresh":
        return fresh
    out = {}
    for k, v in fresh.items():
        x = rng.standard_normal(v.shape).astype(np.float32)
        out[k] = np.abs(x) + 0.5 if k == "n" else x
    return out


@pytest.mark.parametrize("kind", ["fresh", "random"])
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_steps_match_reference(block, kind):
    jcfg, tcfg = _cfgs("xlstm_125m")
    rng = np.random.default_rng(1)
    jinit = getattr(jssm, f"init_{block}")
    jp = jinit(jax.random.PRNGKey(2), jcfg)
    fresh = jax.tree.map(np.asarray, getattr(jssm, f"{block}_state")(jcfg, B))
    st = _random_state(rng, fresh, kind)
    x = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    want_st, want = getattr(jssm, f"_{block}_step")(
        jp, jax.tree.map(jnp.asarray, st), jnp.asarray(x), jcfg)
    got_st, got = getattr(tssm, f"_{block}_step")(
        _to_torch(jp), _to_torch(st), torch.from_numpy(x), tcfg)
    _close(got, want, f"{block} out")
    _close_trees(got_st, want_st, f"{block} state")


def test_mlstm_stabiliser_sentinel_drops_the_old_memory():
    """From m = -1e30 the forget term exp(log_f + m - m_new) is exactly 0,
    so whatever C and n hold is dropped, and nothing is NaN."""
    _, tcfg = _cfgs("xlstm_125m")
    p = tssm.init_mlstm(torch.Generator().manual_seed(0), tcfg,
                        torch.device("cpu"))
    fresh = tssm.mlstm_state(tcfg, B, torch.device("cpu"))
    junk = {**fresh, "C": torch.full_like(fresh["C"], 1e6),
            "n": torch.full_like(fresh["n"], -1e6)}
    x = torch.randn((B, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    a_st, a = tssm._mlstm_step(p, fresh, x, tcfg)
    b_st, b = tssm._mlstm_step(p, junk, x, tcfg)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    for k in a_st:
        assert torch.equal(a_st[k], b_st[k]), k


@pytest.mark.parametrize("kind", ["fresh", "random"])
def test_mamba2_step_matches_reference(kind):
    jcfg, tcfg = _cfgs("zamba2_2_7b")
    rng = np.random.default_rng(3)
    jp = jssm.init_mamba2(jax.random.PRNGKey(4), jcfg)
    # non-trivial A, dt bias and skip (the init's are 0, 0, 1)
    for k in ("a_log", "dt_bias", "d_skip"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape), jnp.float32)
    st = _random_state(rng, jax.tree.map(np.asarray,
                                         jssm.mamba2_state(jcfg, B)), kind)
    x = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    want_st, want = jssm._mamba2_step(jp, jax.tree.map(jnp.asarray, st),
                                      jnp.asarray(x), jcfg)
    got_st, got = tssm._mamba2_step(_to_torch(jp), _to_torch(st),
                                    torch.from_numpy(x), tcfg)
    _close(got, want, "mamba2 out")
    _close_trees(got_st, want_st, "mamba2 state")


def test_mamba2_sequence_matches_reference_scan():
    """The whole-sequence form (projections and conv over all tokens at
    once) against the reference's scan of its step from a zero state."""
    jcfg, tcfg = _cfgs("zamba2_2_7b")
    rng = np.random.default_rng(5)
    jp = jssm.init_mamba2(jax.random.PRNGKey(6), jcfg)
    for k in ("a_log", "dt_bias"):
        jp[k] = jnp.asarray(rng.standard_normal(jp[k].shape), jnp.float32)
    x = rng.standard_normal((B, 11, jcfg.d_model)).astype(np.float32)
    _, want = jax.lax.scan(
        lambda st, x_t: jssm._mamba2_step(jp, st, x_t, jcfg),
        jssm.mamba2_state(jcfg, B), jnp.swapaxes(jnp.asarray(x), 0, 1))
    got = tssm.mamba2_sequence(_to_torch(jp), torch.from_numpy(x), tcfg)
    _close(got, jnp.swapaxes(want, 0, 1), "mamba2 sequence")


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scan", "unrolled"])
def test_xlstm_scan_tokens_matches_reference(scan_layers):
    """Outputs and the final states of every layer (the branch a layer
    does not run keeps its fresh state) after 9 tokens."""
    jcfg, tcfg = _cfgs("xlstm_125m", scan_layers=scan_layers, num_layers=3)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    h = np.random.default_rng(8).standard_normal(
        (B, 9, jcfg.d_model)).astype(np.float32)
    want_h, want_st = jssm.xlstm_scan_tokens(jcfg, jparams, jnp.asarray(h))
    got_h, got_st = tssm.xlstm_scan_tokens(tcfg, tparams, torch.from_numpy(h))
    _close(got_h, want_h, "outputs")
    for br in ("m", "s"):
        _close_trees(got_st[br], want_st[br], f"final {br} state")


def test_cross_attention_matches_reference():
    rng = np.random.default_rng(9)
    d, h, hd = 48, 4, 12
    jp = jcm.init_cross_attention(jax.random.PRNGKey(10), d, h, hd,
                                  jnp.float32)
    x = rng.standard_normal((B, 5, d)).astype(np.float32)
    enc = rng.standard_normal((B, 17, d)).astype(np.float32)
    want = jcm.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc),
                               n_heads=h, head_dim=hd)
    got = tcm.cross_attention(_to_torch(jp), torch.from_numpy(x),
                              torch.from_numpy(enc), n_heads=h, head_dim=hd)
    assert got.shape == (B, 5, d)
    _close(got, want, "cross attention")


def test_sdpa_without_mask_matches_reference():
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, n, 4, 8)).astype(np.float32)
               for n in (6, 10, 10))
    want = jcm._sdpa(*map(jnp.asarray, (q, k, v)), None)
    got = tcm._sdpa(*map(torch.from_numpy, (q, k, v)), None)
    _close(got, want, "unmasked sdpa")


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_mlp_matches_reference(gated):
    """Whisper's ungated MLP with the reference's ``jax.nn.gelu`` (the tanh
    approximation, which the port's ``gelu_tanh`` is; the erf form lands
    more than twice the tolerance away at these inputs), and the gated
    SiLU MLP."""
    rng = np.random.default_rng(12)
    jp = jcm.init_mlp(jax.random.PRNGKey(13), 32, 64, jnp.float32,
                      gated=gated)
    assert ("w_gate" in jp) == gated
    x = 2 * rng.standard_normal((B, 7, 32)).astype(np.float32)
    act = dict(gated=True) if gated else dict(gated=False, act=jax.nn.gelu)
    want = jcm.mlp(jp, jnp.asarray(x), **act)
    tact = dict(gated=True) if gated else dict(gated=False,
                                               act=tcm.gelu_tanh)
    got = tcm.mlp(_to_torch(jp), torch.from_numpy(x), **tact)
    _close(got, want, "mlp")
    if not gated:
        erf = tcm.mlp(_to_torch(jp), torch.from_numpy(x), gated=False,
                      act=torch.nn.functional.gelu)
        assert float((erf - got).abs().max()) > 2 * TOL["float32"]["atol"]


def test_port_mlp_init_matches_reference_structure():
    gen = torch.Generator().manual_seed(0)
    for gated in (True, False):
        p = tcm.init_mlp(gen, 8, 16, torch.float32, gated=gated)
        want = jcm.init_mlp(jax.random.PRNGKey(0), 8, 16, jnp.float32,
                            gated=gated)
        assert {k: tuple(v.shape) for k, v in p.items()} == \
            {k: v.shape for k, v in want.items()}


def test_mamba2_float32_leaves_stay_float32():
    """Under the bfloat16 zamba2 config, ``a_log``, ``dt_bias`` and
    ``d_skip`` are float32 after ``init_params`` and after a round trip
    through interop (every other leaf bfloat16), and the param count is
    the reference's."""
    jcfg = jreg.smoke_config("zamba2_2_7b")
    tcfg = treg.smoke_config("zamba2_2_7b")
    assert tcfg.dtype == torch.bfloat16
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    crossed = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jax.tree.map(
            lambda x: x.astype(jnp.float32), jparams)),
        tcfg, device="cpu")
    back = interop.lm_params_from_numpy(interop.lm_params_to_numpy(tparams),
                                        tcfg, device="cpu")
    for tree in (tparams, crossed, back):
        for path, leaf in pytree.items(tree):
            f32 = path.split("/")[-1] in ("a_log", "dt_bias", "d_skip")
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), \
                path
    back = dict(pytree.items(back))
    for path, leaf in pytree.items(tparams):
        assert back[path].dtype == leaf.dtype, path
        assert torch.equal(back[path], leaf), path
    for key in ("a_log", "dt_bias", "d_skip"):
        assert jparams["mamba"][key].dtype == jnp.float32
    assert TM.param_count(tparams) == JM.param_count(jparams)
