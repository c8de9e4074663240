"""``repro_torch.distributed.sharding`` and ``repro_torch.launch.mesh``
against the JAX reference on the CPU, on shapes only (no full config is
ever allocated: the reference's trees come from ``jax.eval_shape``, the
port's from ``models.model.param_shapes`` on the meta device).

The param specs equal the reference's leaf by leaf for every arch of the
registry on both production meshes (and under the 'dp_only' and
'dp_attn' layouts for a dense, an MoE and a hybrid arch), and pass the
reference's legality check; batch, cache and optimizer-state specs equal
the reference's on the same shapes; ``param_shardings`` gives one
placement per mesh axis that says what the spec says."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _abstract_mesh(sizes, names):
    """AbstractMesh across jax versions: (sizes, names) vs ((name, size),...)."""
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def _meshes(which):
    sizes, names = MESHES[which]
    port = tmesh.make_production_mesh(multi_pod=which == "multi")
    return _abstract_mesh(sizes, names), port


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference ShapeDtypeStruct tree, port meta-tensor tree)."""
    jcfg = jreg.config(arch)
    jtree = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                           jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jtree, TM.param_shapes(treg.config(arch))


def _as_meta(jtree):
    """A reference shape tree (nested dicts) as port meta tensors."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jtree)


def _flat(spec_tree):
    """{path: spec tuple} of a reference spec tree."""
    return {"/".join(str(k.key) for k in path): tuple(s) for path, s in
            jax.tree_util.tree_flatten_with_path(
                spec_tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _assert_specs_equal(got, want, what):
    want = _flat(want)
    got = dict(pytree.items(got))
    assert sorted(got) == sorted(want), what
    for key, w in want.items():
        assert got[key] == w, f"{what}: {key}: {got[key]} != {w}"


@pytest.mark.parametrize("which", list(MESHES))
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_match_reference(arch, which):
    """Every leaf's spec, and the reference's legality check (each sharded
    dim divides by its axes' size) on the port's own meta tree, whose
    shapes equal the reference's."""
    jmesh_, tmesh_ = _meshes(which)
    jtree, ttree = _shapes(arch)
    got = tsh.param_specs(ttree, tmesh_)
    _assert_specs_equal(got, jsh.param_specs(jtree, jmesh_), arch)
    shapes = dict(pytree.items(ttree))
    for key, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name = "/".join(str(k.key) for k in key)
        assert tuple(shapes[name].shape) == leaf.shape, name
        assert shapes[name].device.type == "meta"
    for key, spec in pytree.items(got):
        for i, axis in enumerate(spec):
            if axis is not None:
                parts = axis if isinstance(axis, tuple) else (axis,)
                size = int(np.prod([tmesh_.shape[a] for a in parts]))
                assert shapes[key].shape[i] % size == 0, (arch, key, spec)


@pytest.mark.parametrize("layout", ["dp_only", "dp_attn"])
@pytest.mark.parametrize("arch", ["smollm_135m", "deepseek_v2_236b",
                                  "zamba2_2_7b"])
def test_param_specs_layouts_match_reference(arch, layout):
    jmesh_, tmesh_ = _meshes("multi")
    jtree, ttree = _shapes(arch)
    _assert_specs_equal(tsh.param_specs(ttree, tmesh_, layout=layout),
                        jsh.param_specs(jtree, jmesh_, layout=layout),
                        f"{arch} {layout}")


def test_some_params_are_sharded():
    specs = tsh.param_specs(TM.param_shapes(treg.config("olmo_1b")),
                            tmesh.make_production_mesh())
    assert sum(any(a is not None for a in s)
               for s in pytree.leaves(specs)) >= 5


@pytest.mark.parametrize("layout", ["2d", "dp_only"])
@pytest.mark.parametrize("which", list(MESHES))
def test_batch_and_cache_specs_match_reference(which, layout):
    """Batches (a divisible batch, batch 1, a scalar, the vlm and encdec
    stubs) and the decode caches and recurrent states of every family, at
    batch 32 (the reference's cache trees by ``eval_shape``, handed to the
    port as meta tensors of the same shapes)."""
    jmesh_, tmesh_ = _meshes(which)
    assert tsh.batch_axes(tmesh_, layout=layout) == \
        jsh.batch_axes(jmesh_, layout=layout)
    batch = {"tokens": jax.ShapeDtypeStruct((256, 128), jnp.int32),
             "labels": jax.ShapeDtypeStruct((1, 128), jnp.int32),
             "patches": jax.ShapeDtypeStruct((96, 576, 64), jnp.float32),
             "frames": jax.ShapeDtypeStruct((128, 1500, 64), jnp.float32),
             "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    _assert_specs_equal(tsh.batch_specs(_as_meta(batch), tmesh_,
                                        layout=layout),
                        jsh.batch_specs(batch, jmesh_, layout=layout),
                        "batch")
    for arch in treg.ARCH_IDS:
        jcfg = jreg.config(arch)
        cache = jax.eval_shape(lambda: JM.init_cache(jcfg, 32, 8))
        _assert_specs_equal(tsh.cache_specs(_as_meta(cache), tmesh_,
                                            layout=layout),
                            jsh.cache_specs(cache, jmesh_, layout=layout),
                            f"{arch} cache")


def test_opt_state_specs_match_reference():
    jmesh_, tmesh_ = _meshes("single")
    jtree, ttree = _shapes("olmoe_1b_7b")
    want = jsh.opt_state_specs(jsh.param_specs(jtree, jmesh_), jmesh_)
    got = tsh.opt_state_specs(tsh.param_specs(ttree, tmesh_), tmesh_)
    assert sorted(got) == sorted(want) == ["m", "step", "v"]
    for part in ("m", "v"):
        _assert_specs_equal(got[part], want[part], part)
    assert got["step"] == tuple(want["step"]) == ()


@pytest.mark.parametrize("layout", ["2d", "dp_only"])
def test_param_shardings_place_each_axis(layout):
    """One placement per mesh axis: ``Shard(i)`` where the axis (alone or
    in a tuple) shards dim i, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    tmesh_ = tmesh.make_production_mesh(multi_pod=True)
    ttree = _shapes("olmoe_1b_7b")[1]
    specs = dict(pytree.items(tsh.param_specs(ttree, tmesh_, layout=layout)))
    places = dict(pytree.items(tsh.param_shardings(ttree, tmesh_,
                                                   layout=layout)))
    assert sorted(places) == sorted(specs)
    for key, spec in specs.items():
        assert len(places[key]) == 3
        for name, placement in zip(tmesh_.axis_names, places[key]):
            dims = [i for i, a in enumerate(spec)
                    if name in (a if isinstance(a, tuple) else (a,))]
            assert placement == (Shard(dims[0]) if dims else Replicate()), \
                (key, spec)
    # [L, E, D, F]: the reference's rules take the first match, and
    # "(w_up|w_gate|w_in)$" comes before "moe/w_(gate|up)$", so the experts'
    # D and F shard as a dense MLP's, not E
    w = places["blocks/moe/w_gate"]
    if layout == "2d":
        assert w == (Replicate(), Shard(2), Shard(3))
    else:
        assert w == (Replicate(), Shard(2), Shard(2))


def test_meshes_match_reference():
    """The production meshes' names and sizes; a debug mesh over the
    visible devices, refused (ValueError, as the reference's) when it
    needs more than there are."""
    for which, (sizes, names) in MESHES.items():
        m = tmesh.make_production_mesh(multi_pod=which == "multi")
        assert (m.axis_sizes, m.axis_names) == (sizes, names)
        assert m.size == int(np.prod(sizes)) and m.device_type is None
    want = jmesh.make_debug_mesh(1, 1)
    got = tmesh.make_debug_mesh(1, 1, device="cpu")
    assert got.shape == dict(want.shape) and got.device_type == "cpu"
    with pytest.raises(ValueError, match="Number of devices"):
        jmesh.make_debug_mesh(2, 2)
    with pytest.raises(ValueError, match="Number of devices"):
        tmesh.make_debug_mesh(2, 2, device="cpu")
