"""The port's DeepSeek-V2 settings (``models.model.PortConfig``): YaRN's
frequencies and softmax scale against the published formulas, group-
limited routing with routed scaling, the leading dense layer in prefill
and decode, the spans of a prefill, and the defaults, which leave a
plain ``ModelConfig``'s expert path as it was: the same numbers, bit for
bit, from the same operators."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

CPU = torch.device("cpu")


# -- YaRN, transcribed from DeepSeek-V2's modeling_deepseek.py ---------------

def published_correction_range(low_rot, high_rot, dim, base, max_pos):
    def find(num_rotations):
        return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
            2 * math.log(base))
    low = math.floor(find(low_rot))
    high = math.ceil(find(high_rot))
    return max(low, 0), min(high, dim - 1)


def published_get_mscale(scale=1, mscale=1):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def published_inv_freq(dim, base, scaling_factor, original_max, beta_fast,
                       beta_slow):
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (scaling_factor * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    low, high = published_correction_range(beta_fast, beta_slow, dim, base,
                                           original_max)
    if low == high:
        high += 0.001
    linear = (torch.arange(dim // 2, dtype=torch.float32) - low) / (
        high - low)
    inv_freq_mask = 1.0 - torch.clamp(linear, 0, 1)
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def dsv2_yarn(**kw) -> M.PortConfig:
    """The published rope settings on a small MLA config."""
    base = registry.smoke_config("deepseek_v2_236b")
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields.update(qk_rope_head_dim=64, rope_yarn_factor=40.0,
                  rope_yarn_original_max=4096, rope_yarn_mscale_all_dim=0.707)
    fields.update(kw)
    return M.PortConfig(**fields)


def test_yarn_frequencies_and_scale_are_the_published_ones():
    assert cm.yarn_range(64, 1e4, 4096) == (10, 23)
    assert published_correction_range(32, 1, 64, 1e4, 4096) == (10, 23)
    cfg = dsv2_yarn()
    got = cm.rope_inv_freq(cfg, 64)
    want = published_inv_freq(64, 1e4, 40, 4096, 32, 1)
    assert torch.equal(got, want)
    plain = cm.rope_freqs(64, 1e4)
    assert torch.equal(got[:11], plain[:11])             # kept to low
    torch.testing.assert_close(got[23:], plain[23:] / 40)  # interpolated
    assert (got[11:23] < plain[11:23]).all()            # the ramp
    # cos and sin: mscale(40, 0.707) / mscale(40, 0.707), which the port omits
    assert published_get_mscale(40, 0.707) / published_get_mscale(
        40, 0.707) == 1.0
    ms = published_get_mscale(40, 0.707)
    assert round(ms * ms, 5) == 1.58963
    full = dsv2_yarn(qk_nope_head_dim=128)
    assert mla.softmax_scale(full) == pytest.approx(192 ** -0.5 * ms * ms,
                                                    rel=1e-15)


def test_plain_rope_is_untouched_by_the_defaults():
    cfg = registry.smoke_config("deepseek_v2_236b")
    assert torch.equal(cm.rope_inv_freq(cfg, 8), cm.rope_freqs(8, 1e4))
    assert mla.softmax_scale(cfg) == 1 / math.sqrt(16 + 8)
    x = torch.randn(2, 5, 3, 8)
    pos = torch.arange(5)[None]
    assert torch.equal(cm.apply_rope(x, pos, 1e4),
                       cm.apply_rope(x, pos, 1e4,
                                     inv_freq=cm.rope_freqs(8, 1e4)))


# -- group-limited routing ----------------------------------------------------

def grouped(**kw) -> M.PortConfig:
    base = dict(name="g", family="moe", num_layers=1, d_model=1, num_heads=1,
                num_kv_heads=1, d_ff=4, vocab_size=16, moe_num_experts=16,
                moe_top_k=3, moe_d_ff=4, moe_n_group=4, moe_topk_group=2,
                moe_norm_topk=False, moe_routed_scale=16.0)
    return M.PortConfig(**{**base, **kw})


def test_group_limited_routing_keeps_the_best_groups_unnormalised():
    """The best experts lie in four groups; only the two groups with the
    best maxima are kept, the top 3 taken among their experts, and the
    weights are the probabilities times 16."""
    logits = torch.full((16,), -2.0)
    logits[[0, 5, 10, 15]] = torch.tensor([5.0, 4.9, 4.8, 4.7])
    logits[1] = 3.0                      # group 0's second best
    logits[11] = 4.0                     # better, but in group 2
    p = {"router": logits[None]}
    top_w, top_e, probs = moe.route(p, torch.ones(1, 1), grouped())
    assert top_e.tolist() == [[0, 5, 1]]
    assert torch.equal(top_w, probs[0, [0, 5, 1]][None] * 16)
    plain_e = moe.route(p, torch.ones(1, 1), grouped(moe_n_group=1,
                                                     moe_topk_group=1))[1]
    assert plain_e.tolist() == [[0, 5, 10]]          # ungrouped: across groups
    norm_w = moe.route(p, torch.ones(1, 1), grouped(moe_norm_topk=True,
                                                    moe_routed_scale=1.0))[0]
    assert torch.allclose(norm_w.sum(), torch.tensor(1.0))


def test_a_routed_scale_needs_unnormalised_weights():
    """As published, the top-k weights are renormalised or scaled, never
    both: a config asking for both is refused."""
    with pytest.raises(ValueError, match="unnormalised"):
        grouped(moe_norm_topk=True, moe_routed_scale=16.0)
    w = moe.route({"router": torch.zeros(1, 16)}, torch.ones(1, 1),
                  grouped(moe_norm_topk=True, moe_routed_scale=1.0))[0]
    assert torch.allclose(w, torch.full((1, 3), 1 / 3))


def test_group_ties_go_to_the_lower_group_and_expert():
    logits = torch.zeros(16)
    p = {"router": logits[None]}
    top_w, top_e, _ = moe.route(p, torch.ones(1, 1), grouped())
    assert top_e.tolist() == [[0, 1, 2]]
    assert torch.allclose(top_w, torch.full((1, 3), 16 / 16))


def test_a_layer_keeps_only_the_choices_of_the_experts_it_holds():
    cfg = grouped(moe_expert_first=4, moe_experts_held=4, moe_top_k=2)
    top_e = torch.tensor([[4, 0], [7, 5], [3, 8], [6, 4]])
    order, slot, keep = moe.dispatch(top_e, cfg, 4)
    flat = top_e.reshape(-1)[order]
    assert keep.tolist() == ((flat >= 4) & (flat < 8)).tolist()
    cap = moe.capacity(cfg, 4)
    assert slot[keep].tolist() == [0, 1, cap, 2 * cap, 3 * cap]
    assert (slot[~keep] == 4 * cap).all()
    # each held expert gets the slots it would get in the deployment
    assert moe.capacity(cfg, 16384) == int(1.25 * 16384 * 2 / 16) + 1


def test_the_config_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="held"):
        grouped(moe_expert_first=12, moe_experts_held=8)
    with pytest.raises(ValueError, match="groups"):
        grouped(moe_n_group=3)
    with pytest.raises(ValueError, match="groups"):
        grouped(moe_topk_group=5)
    with pytest.raises(ValueError, match="dense"):
        grouped(first_dense_layers=2)
    with pytest.raises(ValueError, match="MLA"):
        grouped(rope_yarn_factor=4.0)


def test_port_defaults_are_a_plain_configs_behaviour():
    own = {f.name: f.default for f in dataclasses.fields(M.PortConfig)
           if f.name not in {g.name for g in dataclasses.fields(M.ModelConfig)}}
    assert len(own) == 11
    cfg = registry.config("olmoe_1b_7b")
    assert all(cm.setting(cfg, k) == v for k, v in own.items())
    assert all(cm.setting(as_port(cfg), k) == v for k, v in own.items())
    assert cm.experts_held(cfg) == 64


# -- the defaults leave the expert path as it was -------------------------------

def route_before(p, xf, cfg):
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.moe_top_k], top_e[:, :cfg.moe_top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_e, probs


def dispatch_before(top_e, cfg, n):
    e, cap = cfg.moe_num_experts, moe.capacity(cfg, n)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ranks = moe._ranks_in_expert(sorted_e)
    keep = ranks < cap
    slot = torch.where(keep, sorted_e * cap + ranks, e * cap)
    return order, slot, keep


def moe_block_before(p, x, cfg):
    """``moe.moe_block`` as it was before the port's settings."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.moe_num_experts, cfg.moe_top_k
    cap = moe.capacity(cfg, n)
    xf = x.reshape(n, d)
    top_w, top_e, _ = route_before(p, xf, cfg)
    order, slot, keep = dispatch_before(top_e, cfg, n)
    tok = order // k
    buf = torch.zeros((e * cap, d), dtype=x.dtype, device=x.device)
    buf[slot[keep]] = xf[tok[keep]]
    buf = buf.reshape(e, cap, d)
    gate = F.silu(torch.bmm(buf, p["w_gate"]))
    up = torch.bmm(buf, p["w_up"])
    out = torch.bmm(gate * up, p["w_down"]).reshape(e * cap, d)
    rows = torch.where(keep[:, None], out[torch.clamp(slot, max=e * cap - 1)],
                       0)
    w_sorted = top_w.reshape(-1)[order].to(x.dtype)
    contrib = rows * w_sorted[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=x.device)
    y = contrib[inv].reshape(n, k, d).sum(1)
    if "shared" in p:
        y = y + cm.mlp(p["shared"], xf)
    return y.reshape(b, s, d)


class Ops(TorchDispatchMode):
    """The aten operators a block calls, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def as_port(cfg) -> M.PortConfig:
    return M.PortConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "deepseek_v2_236b"])
@pytest.mark.parametrize("port", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_defaults_route_and_dispatch_as_before_bit_for_bit(arch, port, dtype):
    """OLMoE's (and the registry DeepSeek's) expert layer, at more tokens
    than its capacity holds: the same choices, slots and output bit for
    bit as before, from the same operators in the same order, under a
    plain ``ModelConfig`` and under a ``PortConfig`` at its defaults."""
    cfg = dataclasses.replace(registry.smoke_config(arch), dtype=dtype,
                              moe_capacity_factor=0.5)
    cfg = as_port(cfg) if port else cfg
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg, CPU)
    x = torch.randn(2, 96, cfg.d_model,
                    generator=torch.Generator().manual_seed(4)).to(dtype)
    xf = x.reshape(-1, cfg.d_model)
    for a, b in zip(moe.route(p, xf, cfg), route_before(p, xf, cfg)):
        assert torch.equal(a, b)
    top_e = moe.route(p, xf, cfg)[1]
    for a, b in zip(moe.dispatch(top_e, cfg, 192),
                    dispatch_before(top_e, cfg, 192)):
        assert torch.equal(a, b)
    assert not moe.dispatch(top_e, cfg, 192)[2].all()     # drops happen
    with Ops() as now:
        y = moe.moe_block(p, x, cfg)
    with Ops() as before:
        want = moe_block_before(p, x, cfg)
    assert torch.equal(y, want)
    assert now.ops == before.ops


# -- the leading dense layer, decode, spans -------------------------------------

def small_dsv2(**kw) -> M.PortConfig:
    """DeepSeek-V2's block at small widths: a dense layer, then expert
    layers holding group 1 of 4 over 16 experts, YaRN past 8 positions."""
    base = registry.smoke_config("deepseek_v2_236b")
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    fields.update(num_layers=3, dtype=torch.float32, moe_num_experts=16,
                  moe_top_k=3, moe_expert_first=4, moe_experts_held=4,
                  moe_n_group=4, moe_topk_group=2, moe_norm_topk=False,
                  moe_routed_scale=16.0, first_dense_layers=1, dense_d_ff=96,
                  rope_yarn_factor=4.0, rope_yarn_original_max=8,
                  rope_yarn_mscale_all_dim=0.707)
    fields.update(kw)
    return M.PortConfig(**fields)


def test_the_dense_layer_leads_the_stacked_tree():
    cfg = small_dsv2()
    shapes = M.param_shapes(cfg)
    assert list(shapes) == ["dense_blocks", "blocks", "embed", "ln_f"]
    assert shapes["dense_blocks"]["mlp"]["w_up"].shape == (1, 64, 96)
    assert "moe" not in shapes["dense_blocks"]
    assert shapes["blocks"]["moe"]["w_up"].shape == (2, 4, 64, 32)
    assert shapes["blocks"]["moe"]["router"].shape == (2, 64, 16)
    cache = M.init_cache(cfg, 1, 8, device=CPU)
    assert cache["c_kv"].shape[0] == 3
    plain = M.param_shapes(registry.smoke_config("deepseek_v2_236b"))
    assert list(plain) == ["blocks", "embed", "ln_f"]


def test_decode_through_the_latent_cache_equals_prefill():
    """Every layer, the dense one first, writes its own cache entry; each
    decode step's logits equal the prefill's at that position (float32;
    at most 64 tokens, so no choice is dropped in either)."""
    cfg = small_dsv2()
    params = M.init_params(cfg, torch.Generator().manual_seed(5), device=CPU)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(6))
    full = M.prefill_logits(cfg, params, {"tokens": tokens})
    cache = M.init_cache(cfg, 2, 12, device=CPU)
    for t in range(12):
        step, cache = M.serve_step(cfg, params, cache,
                                   {"tokens": tokens[:, t:t + 1], "pos": t})
        torch.testing.assert_close(step, full[:, t], atol=2e-5, rtol=2e-5)
    assert cache["c_kv"].abs().sum((1, 2, 3)).gt(0).all()


@pytest.fixture
def _stopped():
    tracing.stop()
    yield
    tracing.stop()


def test_a_prefill_records_its_spans(_stopped):
    cfg = small_dsv2()
    params = M.init_params(cfg, torch.Generator().manual_seed(5), device=CPU)
    step = steps.make_prefill_step(cfg, device=CPU)
    tokens = torch.zeros((1, 16), dtype=torch.long)
    tracing.start()
    step(params, {"tokens": tokens})
    step(params, {"tokens": tokens})
    spans = tracing.stop()
    names = [s.name for s in spans]
    assert names.count("steps.prefill") == 2
    assert names.count("mla.attention") == 2 * 3
    for name in ("moe.route", "moe.experts", "moe.shared"):
        assert names.count(name) == 2 * 2
    roots = [s for s in spans if s.name == "steps.prefill"]
    assert [s.rid for s in roots] == [0, 1]
    assert all(s.rid in (0, 1) for s in spans)
    assert all(spans[s.parent].name == "steps.prefill" for s in spans
               if s.name == "mla.attention")
