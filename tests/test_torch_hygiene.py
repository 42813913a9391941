"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ggrs_tpu_torch
from ggrs_tpu_torch import (
    BatchedSessions,
    BoxGame,
    ChipVM,
    DeviceRequestExecutor,
    DeviceSyncTestSession,
)
from ggrs_tpu_torch.core.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ggrs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ggrs_tpu'] = None\n"
        "import ggrs_tpu_torch, ggrs_tpu_torch.ops.replay, ggrs_tpu_torch.parallel.batch\n"
        "import ggrs_tpu_torch.sessions.device_synctest, ggrs_tpu_torch._build\n"
        "import ggrs_tpu_torch.ops.executor, ggrs_tpu_torch.sessions.builder\n"
        "import ggrs_tpu_torch.utils.checkpoint, ggrs_tpu_torch.core.sync_layer\n"
        "import chip_smoke\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "ggrs_tpu"), f"{path.name} imports {mod}"


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    game = BoxGame(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceSyncTestSession(game.advance, game.init_state_np(), np.zeros(2, np.uint8))
    vm = ChipVM(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedSessions(vm.advance, vm.init_state_np(), np.zeros(2, np.uint8), batch_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        game.init_state()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceRequestExecutor(game.advance, game.init_state_np(), lambda pairs: None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_public_surface():
    for name in ggrs_tpu_torch.__all__:
        assert hasattr(ggrs_tpu_torch, name), name
