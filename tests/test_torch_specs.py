"""The port's public names that mirror the reference's, and its input
specs: ``smoke_config``/``config`` of every model, ``active_param_count``,
``ops.minplus_matvec``, ``routing.extract_paths_ref``, the package
re-exports, and each LM config's ``input_specs`` against the live
reference over every admitted (arch x shape) cell, every leaf on the meta
device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import shape_applicable as j_applicable  # noqa: E402
from repro.core import network as jnet, routing as jrouting  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.shapes import shape_applicable as t_applicable  # noqa: E402
from repro_torch.core import network as tnet, routing as trouting  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


@pytest.mark.parametrize("getter", ["config", "smoke_config"])
@pytest.mark.parametrize("arch", jreg.PAPER_MODELS)
def test_paper_model_configs_match_reference(arch, getter):
    """The conv nets' ``config`` and ``smoke_config`` (the LM configs'
    fields are held in ``test_torch_configs.py``)."""
    assert getattr(treg, getter)(arch) == getattr(jreg, getter)(arch)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_active_param_count_matches_reference(arch):
    want_cfg = jreg.smoke_config(arch)
    params = jax.eval_shape(lambda k: JM.init_params(want_cfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    cfg = treg.smoke_config(arch)
    shapes = TM.param_shapes(cfg)
    assert TM.param_count(shapes) == JM.param_count(params)
    assert TM.active_param_count(cfg, shapes) == \
        JM.active_param_count(want_cfg, params)


def test_minplus_matvec_bitwise():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 17, 23)).astype(np.float32)
    x = rng.standard_normal((3, 23)).astype(np.float32)
    want = np.asarray(jops.minplus_matvec(jnp.asarray(a), jnp.asarray(x)))
    got = tops.minplus_matvec(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_extract_paths_ref_matches_reference():
    """The seed's per-hop loop on the paper's 5-node net, queues loaded so
    that some layers take multi-hop paths."""
    rng = np.random.default_rng(1)
    jn, tn = jnet.small_topology()[0], tnet.small_topology(device="cpu")[0]
    q_node = rng.uniform(0, 5, 5).astype(np.float32)
    q_link = rng.uniform(0, 5, (5, 5)).astype(np.float32)
    jn = jn.with_queues(jnp.asarray(q_node), jnp.asarray(q_link))
    tn = tn.with_queues(torch.from_numpy(q_node), torch.from_numpy(q_link))
    comp = rng.uniform(1, 5, 4).astype(np.float32)
    data = rng.uniform(1, 9, 5).astype(np.float32)
    hops = 0
    for assign in ([1, 2, 2, 3], [3, 3, 0, 1], [0, 0, 0, 0], [4, 4, 4, 4]):
        want = jrouting.extract_paths_ref(jn, comp, data, 0, 4, 4,
                                          np.asarray(assign, np.int32))
        got = trouting.extract_paths_ref(tn, comp, data, 0, 4, 4,
                                         np.asarray(assign, np.int32))
        assert got == want
        hops = max(hops, max(len(h) for h in got))
    assert hops > 1


def test_package_reexports():
    import repro.configs as jc
    import repro.costs as jcost
    import repro.models as jm
    import repro_torch.configs as tc
    import repro_torch.costs as tcost
    import repro_torch.models as tm
    assert tc.__all__ == jc.__all__
    assert tc.ARCH_IDS == jc.ARCH_IDS and tc.PAPER_MODELS == jc.PAPER_MODELS
    assert tc.registry is treg and tc.shapes.SHAPES is TSHAPES
    assert tcost.__all__ == jcost.__all__
    assert tcost.lm.cost_profile and tcost.convnets.vgg19_profile
    assert tm.__all__ == jm.__all__
    assert tm.active_param_count is TM.active_param_count
    assert tops.minplus_matvec and trouting.extract_paths_ref


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) \
        else jnp.dtype(dtype).name


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_input_specs_match_reference(arch, shape):
    """Keys in order, shapes and dtypes equal; the same cells admitted
    (with the same reason) and every leaf a meta tensor."""
    jcfg, tcfg = jreg.config(arch), treg.config(arch)
    ok, reason = j_applicable(jcfg, JSHAPES[shape])
    assert t_applicable(tcfg, TSHAPES[shape]) == (ok, reason)
    if not ok:
        return
    want = jreg.get(arch).input_specs(JSHAPES[shape], jcfg)
    got = treg.get(arch).input_specs(TSHAPES[shape], tcfg)
    assert list(got) == list(want)
    for key, leaf in got.items():
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "meta"
        assert tuple(leaf.shape) == want[key].shape, key
        assert _dtype_name(leaf.dtype) == _dtype_name(want[key].dtype), key
    # the cfg argument is the one used (here: a float32 smoke config)
    small = dataclasses.replace(treg.smoke_config(arch), dtype=torch.float32)
    jsmall = dataclasses.replace(jreg.smoke_config(arch), dtype=jnp.float32)
    got = treg.get(arch).input_specs(TSHAPES[shape], small)
    want = jreg.get(arch).input_specs(JSHAPES[shape], jsmall)
    assert {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in got.items()} == \
        {k: (v.shape, _dtype_name(v.dtype)) for k, v in want.items()}
