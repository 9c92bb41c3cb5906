"""The port stands alone: pio_tpu_torch and chip_smoke.py import neither
``jax`` nor anything of the ``pio_tpu`` package, and run on CUDA unless the
caller asks for the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from pio_tpu_torch import resolve_device
from pio_tpu_torch.parallel.context import ComputeContext

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "pio_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "pio_tpu")


def _forbidden(module: str) -> bool:
    # "pio_tpu_torch" starts with "pio_tpu" but is not the JAX package
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("pio_tpu") and _forbidden("pio_tpu.data.bimap")
    assert not _forbidden("pio_tpu_torch") and not _forbidden("pio_tpu_torch.ops")
    assert not _forbidden("jaxlike")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_no_jax_or_reference_imports(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert bad == []


#: every source of the port: Python, C++ and CUDA, and chip_smoke.py
PORT_SOURCES = sorted(
    path for path in (REPO / "pio_tpu_torch").rglob("*")
    if path.suffix in (".py", ".cpp", ".cu", ".cuh")
) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize(
    "path", PORT_SOURCES, ids=[str(p.relative_to(REPO)) for p in PORT_SOURCES]
)
def test_no_source_names_the_reference_native_sources(path):
    """The port builds its own copies of the native sources; none of its
    files points at the reference's (``pio_tpu/native``), by path or as
    a module."""
    text = path.read_text()
    assert "pio_tpu/native" not in text and "pio_tpu.native" not in text


def test_importing_the_port_loads_no_jax():
    # a fresh interpreter: this test process has jax loaded already
    code = (
        "import importlib, pkgutil, sys, pio_tpu_torch\n"
        "for m in pkgutil.walk_packages(pio_tpu_torch.__path__, 'pio_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pio_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ComputeContext.local(0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_entry_point_raises_without_cuda(monkeypatch):
    from pio_tpu_torch.models.mlp import MLPModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        MLPModel([[0.0]], [0.0], [[0.0]], [0.0])


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError):
        resolve_device("meta")


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


#: the pool plane and the router, each under the reference's name
POOL_PLANE_MODULES = (
    "obs/shm.py", "obs/promparse.py", "obs/fleet.py", "server/fleetd.py",
    "server/dashboard.py", "server/admin.py", "server/routerd.py",
    "router/__init__.py", "router/ring.py", "router/core.py",
    "router/deploy.py", "router/rollout.py",
)


@pytest.mark.parametrize("module", POOL_PLANE_MODULES)
def test_pool_plane_module_stands_alone(module):
    """Each has its reference counterpart, and imports neither ``jax`` nor
    ``pio_tpu`` (also held by the walk above, which covers every file)."""
    path = REPO / "pio_tpu_torch" / module
    assert (REPO / "pio_tpu" / module).exists()
    bad = [mod for _, mod in _imports(path) if _forbidden(mod)]
    assert bad == []


def test_cli_verbs_leave_no_exports_behind(monkeypatch, tmp_path, capsys):
    """``--qos`` / ``--slo`` / ``--faults`` are exported for the workers a
    verb spawns, and given back when the verb returns, so a process that
    runs a verb in-line serves its later servers without them."""
    from pio_tpu_torch import faults
    from pio_tpu_torch.tools import cli

    for name in cli.EXPORTED_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    from pio_tpu_torch.workflow.engine_json import EngineJsonError

    assert faults.snapshot()["enabled"] is False
    # no engine.json: the verb fails after exporting and arming its specs
    with pytest.raises(EngineJsonError):
        cli.main(["deploy", "--device", "cpu", "--qos", "rps=5",
                  "--slo", "p99=50ms:99.9",
                  "--faults", "worker.serve=latency:0us"])
    capsys.readouterr()
    assert [os.environ.get(n) for n in cli.EXPORTED_ENV] == [None] * 3
    assert faults.snapshot()["enabled"] is False
