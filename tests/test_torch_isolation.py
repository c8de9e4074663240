"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU silently."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.interop\n"
            "import repro_torch.launch.route, repro_torch.kernels.ops\n"
            "import repro_torch.launch.serve, repro_torch.launch.steps\n"
            "import repro_torch.kernels.flash, repro_torch.models\n"
            "import repro_torch.serving.engine\n"
            "import repro_torch.serving.scheduler, repro_torch.costs.lm\n"
            "import repro_torch.launch.train, repro_torch.pytree\n"
            "import repro_torch.optim.adamw, repro_torch.optim.schedules\n"
            "import repro_torch.data.pipeline, repro_torch.checkpoint.ckpt\n"
            "import repro_torch.distributed.fault\n"
            "import repro_torch.scenarios, repro_torch.configs.shapes\n"
            "import repro_torch.core.eventsim, repro_torch.core.arrivals\n"
            "import repro_torch.core.completions\n"
            "import repro_torch.configs.registry as r\n"
            "[r.get(a) for a in r.PAPER_MODELS + r.ARCH_IDS]\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.', 'jaxlib'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch)"
    r"|from\s+\.+\s+import\s+.*\brepro\b)", re.M)


def test_sources_never_import_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_default_device_entry_points_refuse_without_cuda(monkeypatch):
    from repro_torch import interop
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import registry
    from repro_torch.core import Plan, jobs, network
    from repro_torch.core.completions import CommittedWork
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.launch import route, serve, steps, train
    from repro_torch.models import model
    from repro_torch.scenarios import make_scenario
    from repro_torch.serving.engine import DecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = jobs.synthetic_job("j", 0, 1, 3)
    cfg = registry.smoke_config("smollm_135m")
    calls = [
        lambda: network.make_network(2, [(0, 1, 1.0)], [1.0, 1.0]),
        lambda: network.small_topology(),
        lambda: network.us_backbone(capacity_scale=1e-4),
        lambda: make_scenario("star"),
        lambda: CommittedWork.empty(3).queue_state(),
        lambda: jobs.batch_jobs([job]),
        lambda: Plan.from_dict({"assign": [[0]], "priority": [0],
                                "bounds": [1.0]}),
        lambda: interop.network_from_numpy([1.0], [[0.0]], [0.0], [[0.0]],
                                           device="cuda"),
        lambda: route.run("small", "resnet34:1", 1e-3, "greedy", 0,
                          verbose=False),
        lambda: serve.run("smollm_135m", 1, 1, verbose=False),
        lambda: serve.default_cluster(),
        lambda: DecodeEngine(cfg, {}),
        lambda: steps.make_prefill_step(cfg),
        lambda: steps.make_serve_step(cfg),
        lambda: model.init_params(cfg, torch.Generator()),
        lambda: model.init_cache(cfg, 1, 4),
        lambda: interop.lm_params_from_numpy({}, cfg, device="cuda"),
        lambda: steps.make_train_step(cfg),
        lambda: train.train("smollm_135m", steps=1),
        lambda: SyntheticStream(DataConfig(vocab_size=8, seq_len=4,
                                           global_batch=1)),
        lambda: ckpt.place({}),
        lambda: interop.adamw_state_from_numpy(
            {"m": {}, "v": {}, "step": 0}, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # the same calls run when the CPU is asked for
    net, _ = network.small_topology(device="cpu")
    assert net.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repository(tmp_path):
    """Here (no CUDA) and alone in a directory, ``chip_smoke.py`` exits
    nonzero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            timeout=300, cwd=script.parent,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
