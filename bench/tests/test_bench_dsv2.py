"""CPU tests of the DeepSeek-V2 cell's own files: the port against the
plain reference (``bench/reference/deepseek_v2.py``) at small widths, the
share of the expert layer one chip computes against the uncut layer, the
configuration file as the program runs it, and the frozen arithmetic at
the cell's shapes."""
from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from bench import harness, models, yardstick  # noqa: E402
from bench.tests.test_bench_harness import tiny  # noqa: E402

CELL = "dsv2-prefill-16k"
CPU = torch.device("cpu")


def small(impl: str = "xla", **over) -> dict:
    """The cell's tiny configuration (one dense and three expert layers,
    16 experts in 4 groups, group 1 held, YaRN past 16 positions, float32)
    with ``over`` laid on it."""
    cfg = dict(tiny(CELL).config)
    cfg["program"] = {**cfg["program"], "attn_impl": impl}
    for key, value in over.items():
        cfg[key] = {**cfg[key], **value} if isinstance(value, dict) \
            else value
    return cfg


def tokens(b: int, s: int, vocab: int) -> torch.Tensor:
    return torch.randint(0, vocab, (b, s),
                         generator=torch.Generator().manual_seed(11))


# float32 on both sides, summed in other orders (the port's einsums, its
# expert buffer and sorted combine, and on the flash path the kernel's
# online softmax; the reference's query blocks and per-expert loop): ~1e-5
# at logits of a few units, measured; a departure of the mathematics (a
# plain rotary, another scale, another group or scaling) moves them by
# tenths
ATOL = RTOL = 1e-4


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_the_port_matches_the_reference(impl):
    """Prefill logits of B=2 x 128 (past the 16 original positions, past
    the 64 tokens under which every choice fits) and each kind of block."""
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    cfg = small(impl)
    prog = models.program_config(cfg)
    params = models.make_weights(cfg, prog, 7, CPU)
    tok = tokens(2, 128, cfg["vocab_size"])
    ref = models.arch(cfg).Model(cfg, params)
    got = M.prefill_logits(prog, params, {"tokens": tok})
    torch.testing.assert_close(got, ref.forward(tok), atol=ATOL, rtol=RTOL)
    h = torch.randn(2, 128, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(3))
    pos = torch.arange(128)
    layers = list(transformer._layers(prog, params))
    assert "mlp" in layers[0][0] and "moe" in layers[1][0]
    for i in (0, 1):
        out = transformer._block_apply(prog, layers[i][0], h, pos[None],
                                       layers[i][1])[0]
        torch.testing.assert_close(out, ref.block(i, h, pos), atol=ATOL,
                                   rtol=RTOL)


def test_yarn_is_what_the_reference_computes():
    from repro_torch.models import common as cm
    from repro_torch.models import mla
    from bench.reference import deepseek_v2 as ref
    cfg = models.harness.load_json(harness.BENCH /
                                   "configs/deepseek-v2-15l.json")
    prog = models.program_config(cfg)
    assert torch.equal(cm.rope_inv_freq(prog, 64),
                       ref.yarn_inv_freq(64, 1e4, cfg["rope_scaling"]))
    model = ref.Model(cfg, {})
    assert mla.softmax_scale(prog) == pytest.approx(model.scale, rel=1e-15)
    assert round(model.scale * math.sqrt(192), 5) == 1.58963
    assert model.cos_sin_scale == 1.0


def test_every_groups_share_adds_up_to_the_uncut_layer():
    """Each of the 4 chips of the expert group computes its 4 experts'
    part of the layer for 128 tokens (past capacity, so some choices are
    dropped); the four parts and the shared expert, counted once, add up
    to the reference's layer holding all 16."""
    from repro_torch.models import moe
    fewer = {"capacity_factor": 0.75}
    whole = small(n_routed_experts=16, deployment={"expert_group": 0},
                  departures=fewer)
    prog = models.program_config(whole)
    params = models.make_weights(whole, prog, 9, CPU)
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()
         if k != "shared"}
    shared = {k: v[0] for k, v in params["blocks"]["moe"]["shared"].items()}
    x = torch.randn(1, 128, whole["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    parts = torch.zeros_like(x)
    for g in range(4):
        cfg_g = models.program_config(small(deployment={"expert_group": g},
                                            departures=fewer))
        assert (cfg_g.moe_expert_first, cfg_g.moe_experts_held) == (4 * g, 4)
        held = {k: (v if k == "router" else v[4 * g:4 * g + 4])
                for k, v in p.items()}
        parts = parts + moe.moe_block(held, x, cfg_g)
    from repro_torch.models import common as cm
    got = parts + cm.mlp(shared, x)
    ref = models.arch(whole).Model(whole, params)
    want = ref.moe({**p, "shared": shared}, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    top_e = moe.route(p, x.reshape(128, -1), prog)[1]
    assert not moe.dispatch(top_e, prog, 128)[2].all()    # choices dropped


def test_the_file_is_the_published_model_as_run():
    cfg = harness.load_json(harness.BENCH / "configs/deepseek-v2-15l.json")
    prog = models.program_config(cfg)
    assert (prog.num_layers, prog.d_model, prog.num_heads) == (15, 5120, 128)
    assert (prog.moe_num_experts, prog.moe_experts_held,
            prog.moe_expert_first) == (160, 20, 0)
    assert (prog.moe_top_k, prog.moe_num_shared, prog.moe_d_ff) == (6, 2, 1536)
    assert (prog.moe_n_group, prog.moe_topk_group) == (8, 3)
    assert (prog.moe_norm_topk, prog.moe_routed_scale) == (False, 16.0)
    assert (prog.first_dense_layers, prog.dense_d_ff) == (1, 12288)
    assert (prog.q_lora_rank, prog.kv_lora_rank) == (1536, 512)
    assert (prog.qk_nope_head_dim, prog.qk_rope_head_dim,
            prog.v_head_dim) == (128, 64, 128)
    assert (prog.rope_yarn_factor, prog.rope_yarn_original_max) == (40, 4096)
    assert prog.rope_yarn_mscale_all_dim == 0.707
    assert prog.moe_capacity_factor == 1.25 and prog.attn_impl == "flash"
    from repro_torch.models import model as M
    assert M.param_count(M.param_shapes(prog)) == 10_753_991_680
    for bad in ({"scoring_func": "sigmoid"}, {"hidden_act": "gelu"},
                {"topk_method": "noaux_tc"},
                {"rope_scaling": {"type": "linear", "factor": 4}},
                {"rope_scaling": {**cfg["rope_scaling"], "beta_fast": 16}},
                {"rope_scaling": {**cfg["rope_scaling"], "beta_slow": 2}},
                {"rope_scaling": {**cfg["rope_scaling"], "mscale": 1.0}}):
        with pytest.raises(ValueError):
            models.program_config({**cfg, **bad})


@pytest.mark.parametrize("path,shape,norm", [
    ("blocks/attn/q_a_norm/w", (14, 1536), True),
    ("dense_blocks/attn/kv_a_norm/w", (1, 512), True),
    ("dense_blocks/ln2/w", (1, 5120), True),
    ("ln_f/w", (5120,), True),
    ("blocks/attn/w_q_a", (14, 5120, 1536), False),
    ("blocks/moe/router", (14, 5120, 160), False),
])
def test_norm_leaves(path, shape, norm):
    cfg = harness.load_json(harness.BENCH / "configs/deepseek-v2-15l.json")
    assert models.arch(cfg).is_norm_leaf(path, shape) == norm


def test_flash_bound_and_flops_at_the_cells_shapes():
    assert round(yardstick.flash_bound(128, 16384, 192, 128) * 1e3, 3) == \
        11.118
    cfg = harness.load_json(harness.BENCH / "configs/deepseek-v2-15l.json")
    arch = models.arch(cfg)
    parts = arch.flops_parts(cfg, 1, 16384)
    assert parts["mla_attention"] == 2 * 128 * (16384 * 16385 // 2) \
        * 320 * 15
    assert math.isclose(parts["mla_attention"], 1.64936810496e14,
                        rel_tol=1e-12)
    assert math.isclose(parts["mla_projections"], 7.334730399744e13,
                        rel_tol=1e-12)
    assert math.isclose(arch.forward_flops(cfg, 1, 16384),
                        2.9178866958336e14, rel_tol=1e-12)
    assert dataclasses.is_dataclass(models.program_config(cfg))


# -- the cell's check: the reference on the program's own expert choices --------

def test_the_watched_router_gives_each_expert_layers_choices():
    from repro_torch.models import moe
    from bench.drivers import prefill_routed
    cfg = small()
    prog = models.program_config(cfg)
    params = models.make_weights(cfg, prog, 7, CPU)
    real = moe.route
    tok = tokens(1, 80, cfg["vocab_size"])
    from repro_torch.models import model as M
    with prefill_routed.watched_router() as chosen:
        M.prefill_logits(prog, params, {"tokens": tok})
    assert moe.route is real
    assert [tuple(c.shape) for c in chosen] == [(80, 3)] * 3
    ref = models.arch(cfg).Model(cfg, params)
    ref.forward(tok, experts=chosen)
    assert prefill_routed.differing(chosen, ref.choices) == (0, 240)
    swapped = [c.flip(-1) for c in chosen]      # the same sets
    assert prefill_routed.differing(swapped, chosen) == (0, 240)
    other = [c.clone() for c in chosen]
    other[1][5, 0] = (other[1][5].max() + 1) % 16
    assert prefill_routed.differing(other, chosen)[0] == 1


def test_a_router_that_ignores_the_groups_is_not_correct(monkeypatch):
    """Plain top-3 over all 16 experts: the reference follows the choices,
    so the logits agree, and the share of choices it would not make
    fails."""
    from repro_torch.models import moe
    from bench.tests.test_bench_harness import checked
    real = moe.route

    def ungrouped(p, xf, cfg):
        return real(p, xf, dataclasses.replace(cfg, moe_n_group=1,
                                               moe_topk_group=1))
    monkeypatch.setattr(moe, "route", ungrouped)
    cell = tiny(CELL)
    run = checked(cell)
    got = {name: (v, lim) for name, v, lim in run.checks}
    assert set(got) == {"prefill_logit_gap", "prefill_route_share"}
    v, lim = got["prefill_route_share"]
    assert v > lim and not run.correct


def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from repro_torch.models import common
    from bench.tests.test_bench_harness import checked
    real = common.unembed

    def rolled(params, x):
        return real(params, x).roll(1, dims=-1)
    monkeypatch.setattr(common, "unembed", rolled)
    run = checked(tiny(CELL))
    got = {name: v for name, v, _ in run.checks}
    assert got["prefill_route_share"] == 0 and not run.correct
