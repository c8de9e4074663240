"""The fused AdamW's dispatch rule on the CPU: the device alone chooses
the path; every tree off the card takes ``AdamW``'s per-leaf PyTorch code,
with the same numbers as before the kernel existed; a tree on the card
goes to the kernel of ``repro_torch.kernels.adamw``, whose wrappers name
and refuse what it does not take.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adamw as kadamw  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402


ROOT = pathlib.Path(__file__).resolve().parents[1]


class _Sub(torch.Tensor):
    """A tensor subclass, as a DTensor is one."""


class _OnCard(torch.Tensor):
    """A tensor subclass that says it is on a card, as a DTensor over CUDA
    shards does."""

    @property
    def is_cuda(self):
        return True


def _leaf(n=7, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=gen).to(dtype)
    g = (torch.randn(n, generator=gen) * 1e-2).to(dtype)
    m = torch.randn(n, generator=gen) * 1e-3
    v = torch.rand(n, generator=gen) * 1e-5
    return p, g, m, v


def _tree(dtype=torch.bfloat16):
    """params, grads, state of a two-leaf tree (``w`` [3, 5] and ``b`` [5])."""
    (pw, gw, mw, vw), (pb, gb, mb, vb) = (_leaf(15, dtype, 1),
                                          _leaf(5, torch.float32, 2))
    shape = (3, 5)
    params = {"w": pw.view(shape), "b": pb}
    grads = {"w": gw.view(shape), "b": gb}
    state = {"m": {"w": mw.view(shape), "b": mb},
             "v": {"w": vw.view(shape), "b": vb},
             "step": torch.tensor(41, dtype=torch.int32)}
    return params, grads, state


@pytest.mark.parametrize("case,reason", [
    ("cpu", "not on one CUDA device"),
    ("fp16", "p not bfloat16 or float32, or g not of p's dtype"),
    ("g_fp32_of_bf16", "p not bfloat16 or float32, or g not of p's dtype"),
    ("m_bf16", "m or v not float32"),
    ("v_shape", "shapes differ"),
    ("transposed", "not on one CUDA device"),
    ("subclass", "not a plain tensor"),
])
def test_refusal_names_what_the_leaf_shows(case, reason):
    p, g, m, v = _leaf(12, torch.bfloat16)
    if case == "fp16":
        p, g = p.half(), g.half()
    elif case == "g_fp32_of_bf16":
        g = g.float()
    elif case == "m_bf16":
        m = m.bfloat16()
    elif case == "v_shape":
        v = v.view(3, 4)
    elif case == "transposed":
        p, g, m, v = (x.view(3, 4).t() for x in (p, g, m, v))
    elif case == "subclass":
        g = g.as_subclass(_Sub)
    assert kadamw.refusal(p, g, m, v) == reason
    assert kadamw.tree_refusal([p], [g], [m], [v]) == reason


def test_a_plain_float32_leaf_is_refused_only_for_its_device():
    """A leaf the kernel would take on a card: only the device refuses it."""
    for dtype in (torch.float32, torch.bfloat16):
        assert kadamw.refusal(*_leaf(9, dtype)) == "not on one CUDA device"
    assert kadamw.tree_refusal([], [], [], []) == \
        "no leaves, or trees of different sizes"
    p, g, m, v = _leaf(9, torch.float32)
    assert kadamw.tree_refusal([p], [g], [m], []) == \
        "no leaves, or trees of different sizes"
    assert kadamw.tree_refusal([p, p], [g, g.half()], [m, m], [v, v]) == \
        "not on one CUDA device"   # the first leaf's reason comes first


@pytest.mark.parametrize("tree", ["cpu", "mixed_dtype", "non_contiguous"])
def test_refused_trees_take_the_per_leaf_path(tree):
    """A CPU tree takes the per-leaf path whatever its leaves show: plain,
    with a leaf whose gradient is not of its dtype, or with a
    non-contiguous leaf.  One per-leaf apply, no fused apply, no kernel
    launch; the gradient's dtype does not change the numbers."""
    params, grads, state = _tree()
    if tree == "mixed_dtype":
        grads["w"] = grads["w"].float()
    elif tree == "non_contiguous":
        params["w"] = params["w"].t().contiguous().t()
        grads["w"] = grads["w"].t().contiguous().t()
    opt = AdamW(schedule=lambda s: 1e-3)
    kadamw.reset_launch_count()
    new_p, new_state, info = opt.apply(params, grads, state)
    assert kadamw.apply_count("per_leaf") == 1
    assert kadamw.apply_count("fused") == 0
    assert kadamw.launch_count() == 0
    want_p, want_state, _ = opt.apply(*_tree())
    for key in ("w", "b"):
        assert torch.equal(new_p[key], want_p[key])
        assert torch.equal(new_state["m"][key], want_state["m"][key])
    assert info["lr"] == 1e-3 and int(new_state["step"]) == 42


def test_a_meta_device_tree_takes_the_per_leaf_path():
    """The dry-run's trees lie on the meta device: they take the per-leaf
    path, shapes and dtypes kept, with no kernel launch."""
    def meta(x, dtype=None):
        return torch.empty(x.shape, dtype=dtype or x.dtype, device="meta")

    params, grads, _ = _tree()
    params = {k: meta(x) for k, x in params.items()}
    grads = {k: meta(x) for k, x in grads.items()}
    state = {"m": {k: meta(x, torch.float32) for k, x in params.items()},
             "v": {k: meta(x, torch.float32) for k, x in params.items()},
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    kadamw.reset_launch_count()
    new_p, new_state, info = AdamW(schedule=lambda s: 1e-3).apply(
        params, grads, state)
    assert kadamw.apply_count("per_leaf") == 1
    assert kadamw.apply_count("fused") == 0 and kadamw.launch_count() == 0
    for key, x in params.items():
        assert new_p[key].device.type == "meta"
        assert new_p[key].shape == x.shape and new_p[key].dtype == x.dtype
        assert new_state["m"][key].dtype == torch.float32
    assert info["grad_norm"].device.type == "meta"


@pytest.mark.parametrize("leaf", ["p", "g"])
def test_a_tree_on_the_card_the_kernel_refuses_raises(leaf):
    """A tree whose first leaf is on a card goes to the kernel whatever the
    other leaves show; a leaf the kernel refuses (here a tensor subclass,
    as a DTensor over CUDA shards) raises before any launch, and no
    per-leaf apply is counted: nothing falls back."""
    params, grads, state = _tree()
    params["b"] = params["b"].as_subclass(_OnCard)   # the first leaf
    if leaf == "g":
        grads["w"] = grads["w"].as_subclass(_Sub)
    kadamw.reset_launch_count()
    with pytest.raises(ValueError, match="one CUDA device"):
        AdamW(schedule=lambda s: 1e-3).apply(params, grads, state)
    assert kadamw.apply_count() == 0 and kadamw.launch_count() == 0


@pytest.mark.parametrize("clip_norm", [1.0, 1e-3])
def test_per_leaf_path_keeps_the_expressions_it_had(clip_norm):
    """The per-leaf path equals, bit for bit, the expressions AdamW ran
    before the fused path existed (norm, clip and each update inline),
    with clipping off (norm ~0.03) and on; the inputs are left as they
    were."""
    params, grads, state = _tree()
    before = [x.clone() for x in (*params.values(), *grads.values(),
                                  *state["m"].values(), *state["v"].values())]
    opt = AdamW(schedule=lambda s: 3e-4, clip_norm=clip_norm)
    new_p, new_state, info = opt.apply(params, grads, state)

    step = state["step"] + 1
    t = step.float()
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in (grads["b"], grads["w"])))
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    assert torch.equal(info["grad_norm"], gnorm)
    for key in ("w", "b"):
        p, m, v = params[key], state["m"][key], state["v"][key]
        g = grads[key].float() * scale
        m = opt.b1 * m + (1 - opt.b1) * g
        v = opt.b2 * v + (1 - opt.b2) * g * g
        delta = (m / (1 - opt.b1 ** t)) / (torch.sqrt(v / (1 - opt.b2 ** t))
                                           + opt.eps) \
            + opt.weight_decay * p.float()
        assert torch.equal(new_p[key], (p.float() - 3e-4 * delta).to(p.dtype))
        assert torch.equal(new_state["m"][key], m)
        assert torch.equal(new_state["v"][key], v)
    after = [*params.values(), *grads.values(), *state["m"].values(),
             *state["v"].values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_reset_launch_count_zeroes_both_counters():
    opt = AdamW(schedule=lambda s: 1e-3)
    opt.apply(*_tree())
    kadamw._launches["update"] += 3   # as a card run would leave them
    assert kadamw.apply_count() >= 1 and kadamw.launch_count("update") >= 3
    kadamw.reset_launch_count()
    assert kadamw.apply_count() == 0 and kadamw.launch_count() == 0
    assert {e: kadamw.launch_count(e) for e in kadamw.ENTRIES} == dict.fromkeys(
        kadamw.ENTRIES, 0)
    assert {p: kadamw.apply_count(p) for p in kadamw.PATHS} == dict.fromkeys(
        kadamw.PATHS, 0)


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take():
    """The wrappers check before they load the library or launch."""
    p, g, m, v = _leaf(8)
    one = torch.ones(())
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="one CUDA device"):
        kadamw.global_norm([g], 1.0)
    with pytest.raises(ValueError, match="not on one CUDA device"):
        kadamw.update([p], [g], [m], [v], one, one, one, one, **hyper)
    with pytest.raises(ValueError, match="g not of p's dtype"):
        kadamw.update([p], [g.float()], [m], [v], one, one, one, one,
                      **hyper)


def test_importing_the_kernel_module_builds_nothing():
    """Nothing is built or loaded at import (the CPU has no nvcc)."""
    code = ("import repro_torch.kernels.adamw as k, repro_torch.optim.adamw\n"
            "assert k._lib is None and k.build_log == ''\n"
            "assert k.SOURCE.is_file()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
