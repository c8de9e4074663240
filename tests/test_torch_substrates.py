"""The port's training substrates against the JAX reference on the CPU,
mirroring ``tests/test_substrates.py``: the data pipeline (tokens bit-equal
to the reference's), LR schedules (rtol 1e-6), AdamW, checkpoints (the same
on-disk layout: either package restores the other's, bfloat16 leaves
included) and the fault-tolerant restart of ``launch/train.py``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.optim import schedules as jschedules  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro_torch import interop, pytree  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.distributed.fault import StragglerMonitor  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402


def test_data_determinism_and_sharding():
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=8, seed=3)
    s0 = SyntheticStream(cfg, shard_id=0, num_shards=2, device="cpu")
    s1 = SyntheticStream(cfg, shard_id=1, num_shards=2, device="cpu")
    a = s0.batch_at(5)
    b = s0.batch_at(5)
    assert torch.equal(a["tokens"], b["tokens"])                # pure fn
    c = s1.batch_at(5)
    assert not torch.equal(a["tokens"], c["tokens"])            # disjoint
    assert a["tokens"].shape == (4, 32)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError, match="shards"):
        SyntheticStream(cfg, num_shards=3, device="cpu")


@pytest.mark.parametrize("seed,shard,num_shards,step", [
    (0, 0, 1, 0), (3, 1, 2, 5), (7, 2, 4, 123)])
def test_tokens_bit_equal_to_reference(seed, shard, num_shards, step):
    kw = dict(vocab_size=512, seq_len=64, global_batch=8, seed=seed)
    want = JStream(JDataConfig(**kw), shard_id=shard,
                   num_shards=num_shards).batch_at(step)
    got = SyntheticStream(DataConfig(**kw), shard_id=shard,
                          num_shards=num_shards, device="cpu").batch_at(step)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_schedules():
    wsd = schedules.wsd(torch.tensor([0, 100, 5000, 10500]), peak_lr=1.0,
                        warmup_steps=200, stable_steps=9800,
                        decay_steps=1000)
    assert float(wsd[0]) == 0.0
    assert float(wsd[1]) == 0.5
    assert float(wsd[2]) == 1.0
    assert float(wsd[3]) < 1.0
    cos = schedules.warmup_cosine(torch.tensor([0, 100, 100000]),
                                  peak_lr=1.0, warmup_steps=200,
                                  total_steps=100000)
    assert float(cos[2]) <= 0.11


@pytest.mark.parametrize("name,kw", [
    ("warmup_cosine", dict(peak_lr=3e-4, warmup_steps=2000,
                           total_steps=100_000)),
    ("warmup_cosine", dict(peak_lr=1e-3, warmup_steps=5, total_steps=60,
                           min_ratio=0.2)),
    ("wsd", dict(peak_lr=1e-2, warmup_steps=2000, stable_steps=40_000,
                 decay_steps=5_000))])
def test_schedules_match_reference(name, kw):
    steps = np.array([0, 1, 3, 7, 60, 1999, 2000, 2001, 30_000, 42_000,
                      44_500, 47_000, 100_000, 120_000], np.int32)
    want = getattr(jschedules, name)(jnp.asarray(steps), **kw)
    got = getattr(schedules, name)(torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_adamw_step():
    opt = AdamW(schedule=lambda s: 0.1)
    params = {"w": torch.ones((4,))}
    grads = {"w": torch.full((4,), 0.5)}
    st = opt.init(params)
    p2, st2, info = opt.apply(params, grads, st)
    assert float(info["grad_norm"]) == 1.0
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32
    assert bool((p2["w"] < 1.0).all())
    assert torch.equal(params["w"], torch.ones((4,)))   # inputs untouched


def test_adamw_matches_reference():
    """Three AdamW steps on a bf16/f32 tree with clipping active and a
    warmup-cosine schedule: float32 params and the moments per leaf within
    rtol 1e-5, atol 1e-7; the bf16 leaf within one bf16 ulp (rtol 2^-7:
    float32 values a last ulp apart may round to neighbouring bf16s)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32),
                    "d": rng.standard_normal((2, 2, 4)).astype(np.float32)}}

    def sched(mod):
        return lambda s: mod.warmup_cosine(s, peak_lr=0.05, warmup_steps=2,
                                           total_steps=10)

    jopt, topt = JAdamW(schedule=sched(jschedules)), \
        AdamW(schedule=sched(schedules))
    jp = {"a": jnp.asarray(params["a"], jnp.bfloat16),
          "b": jax.tree.map(jnp.asarray, params["b"])}
    tp = {"a": torch.from_numpy(params["a"]).bfloat16(),
          "b": pytree.tree_map(torch.from_numpy, params["b"])}
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = {"a": rng.standard_normal((3, 5)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal(7).astype(np.float32),
                   "d": rng.standard_normal((2, 2, 4)).astype(np.float32)}}
        jp, js, jinfo = jopt.apply(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tinfo = topt.apply(tp, pytree.tree_map(torch.from_numpy, g),
                                   ts)
        assert float(tinfo["grad_norm"]) > 1.0            # clipping active
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6)
    assert tp["a"].dtype == torch.bfloat16
    for key, x in pytree.items(tp):
        want = np.asarray(jnp.asarray(
            jp["a"] if key == "a" else jp["b"][key[2:]], jnp.float32))
        tol = dict(rtol=2 ** -7) if key == "a" else dict(rtol=1e-5,
                                                          atol=1e-7)
        np.testing.assert_allclose(x.float().numpy(), want, **tol)
    for part in ("m", "v"):
        for key, x in pytree.items(ts[part]):
            want = js[part]["a"] if key == "a" else js[part]["b"][key[2:]]
            np.testing.assert_allclose(x.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16) * 1.5,
                  "s": torch.tensor(3, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    out = ckpt.restore(tmp_path, 7, tree)
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["s"].dtype == torch.int32 and int(out["b"]["s"]) == 3
    placed = ckpt.place(out, "cpu")
    assert torch.equal(placed["a"], tree["a"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, 7, {**tree, "a": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(tmp_path, 7, {**tree, "z": torch.zeros(1)})


def test_checkpoint_atomicity(tmp_path):
    tree = {"x": torch.zeros((3,))}
    ckpt.save(tmp_path, 1, tree)
    # a stale tmp dir (simulated crash) must not confuse latest_step
    (tmp_path / ".tmp_dead").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    ckpt.save(tmp_path, 2, tree)
    assert ckpt.latest_step(tmp_path) == 2
    ckpt.prune(tmp_path, keep=1)
    assert ckpt.latest_step(tmp_path) == 2
    assert not (tmp_path / "step_00000001").exists()
    assert ckpt.latest_step(tmp_path / "absent") is None


def _jax_tree():
    return {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
            "b": {"c": jnp.ones((4,), jnp.bfloat16) * 1.5,
                  "s": jnp.int32(3)}}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_in_the_other_package(tmp_path, writer):
    """The same layout both ways: a checkpoint written by either package
    restores in the other, bf16 leaves (stored as a uint16 view with the
    "bfloat16" tag) and the int32 step included."""
    if writer == "port":
        ckpt.save(tmp_path, 4, _tree())
        out = jckpt.restore(tmp_path, 4, _jax_tree())
        assert out["b"]["c"].dtype.name == "bfloat16"
        np.testing.assert_array_equal(np.asarray(out["b"]["c"], np.float32),
                                      np.full(4, 1.5, np.float32))
        np.testing.assert_array_equal(np.asarray(out["a"]),
                                      np.arange(6).reshape(2, 3))
        assert int(out["b"]["s"]) == 3
    else:
        jckpt.save(tmp_path, 4, _jax_tree())
        out = ckpt.restore(tmp_path, 4, _tree())
        for key, x in pytree.items(_tree()):
            got = dict(pytree.items(out))[key]
            assert got.dtype == x.dtype and torch.equal(got, x), key
    manifest = json.loads((tmp_path / "step_00000004" /
                           "manifest.json").read_text())
    assert manifest["dtypes"] == {"b/c": "bfloat16"}
    assert manifest["keys"] == ["a", "b/c", "b/s"] and manifest["complete"]


def test_checkpoint_with_a_tag_the_port_lacks_is_refused(tmp_path):
    """A float8 leaf (which the reference can store, tagged) is refused by
    name rather than restored as its raw integer view."""
    jckpt.save(tmp_path, 1, {"w": jnp.ones((3,), jnp.float8_e4m3fn)})
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        ckpt.restore(tmp_path, 1, {"w": torch.zeros(3)})


def test_train_restart_bit_identical(tmp_path):
    """Kill at step 35, restart, final losses equal an uninterrupted run
    (the port's ``train`` on the CPU, the reference test's arguments)."""
    from repro_torch.launch.train import train
    kw = dict(preset="smoke", steps=60, batch=2, seq=32, ckpt_every=20,
              log_every=1000, device="cpu")
    full = train("smollm_135m", **kw)
    with pytest.raises(RuntimeError, match="injected node failure"):
        train("smollm_135m", ckpt_dir=tmp_path, fail_at=35, **kw)
    resumed = train("smollm_135m", ckpt_dir=tmp_path, **kw)
    assert resumed.resumed_from == 20
    assert len(full.losses) == 60 and len(resumed.losses) == 40
    np.testing.assert_allclose(resumed.losses[-1], full.losses[-1],
                               rtol=1e-4)


def test_train_cli_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr("sys.argv", ["train", "--steps", "3", "--batch", "2",
                                     "--seq", "16", "--device", "cpu"])
    train.main()
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] done" in out


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=20, k=5.0)
    assert not any(mon.record(1.0 + 0.01 * (i % 3)) for i in range(15))
    assert mon.record(10.0) and mon.flagged == 1


def test_adamw_state_from_numpy_shapes():
    tree = {"m": {"w": np.ones((2, 3), np.float32)},
            "v": {"w": np.zeros((2, 3), np.float32)},
            "step": np.int32(5)}
    st = interop.adamw_state_from_numpy(tree, device="cpu")
    assert st["m"]["w"].dtype == torch.float32 and st["m"]["w"].shape == (2, 3)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 5
