"""The port stands alone: ``nerrf_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package, and the entry points raise rather than
move to the CPU when CUDA is asked for and missing."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from nerrf_tpu_torch import device as port_device
from nerrf_tpu_torch import pipeline
from nerrf_tpu_torch.data import SimConfig, simulate_trace
from nerrf_tpu_torch.models import JointConfig, build_nerrfnet

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nerrf_tpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port_sources():
    files = sorted((ROOT / "nerrf_tpu_torch").rglob("*.py"))
    assert len(files) > 10
    return files + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
def test_port_sources_import_nothing_of_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_module():
    # only what importing the port adds counts: an interpreter's own start-up
    # hooks are not the port's doing
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import nerrf_tpu_torch.pipeline, nerrf_tpu_torch.convert\n"
        "import nerrf_tpu_torch.ops.kernels, nerrf_tpu_torch.train.loop\n"
        "import nerrf_tpu_torch.config, nerrf_tpu_torch.train.checkpoint\n"
        "import nerrf_tpu_torch.train.run\n"
        f"bad = sorted(m for m in set(sys.modules) - before\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from nerrf_tpu_torch.train.run import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_nerrfnet(JointConfig().small, seed=0)
    model = build_nerrfnet(JointConfig().small, seed=0, device="cpu")
    trace = simulate_trace(SimConfig(duration_sec=30.0, attack=False,
                                     num_target_files=2, benign_rate_hz=5.0,
                                     seed=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.model_detect(trace, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.calibrate_file_thresholds(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment("toy-graphsage", tmp_path / "run")
    assert not (tmp_path / "run").exists()


def test_training_raises_without_cuda(monkeypatch):
    from nerrf_tpu_torch.train.data import WindowDataset
    from nerrf_tpu_torch.train.loop import TrainConfig, train_nerrfnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = WindowDataset({"node_feat": torch.zeros(1, 4, 24).numpy()})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_nerrfnet(ds, cfg=TrainConfig(model=JointConfig().small, num_steps=1))


def test_entry_points_take_only_cuda_or_cpu():
    with pytest.raises(ValueError, match="runs on 'cuda' or 'cpu'"):
        port_device.resolve_device("meta")
