"""The checks that keep JAX and the JAX package out of a run, and that
make a run fail rather than measure something else."""

import os
import subprocess
import sys

import pytest

from portbench import guard, spec


@pytest.mark.parametrize("name,found", [
    ("pio_tpu_torch", False), ("pio_tpu_torch.models.seqrec", False),
    ("portbench.run", False), ("numpy", False), ("pio_tpu", True),
    ("pio_tpu.models", True), ("jax", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jax_extra", False)])
def test_top_level_names_are_compared_whole(name, found):
    assert bool(guard.forbidden_modules([name])) is found


def test_a_run_loads_nothing_of_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import run, spec, guard\n"
        "from portbench.tests.conftest import TINY\n"
        "b = spec.load_benchmark()\n"
        "for c in TINY:\n"
        "    run.execute(b, spec.cell(b, c), 5, 0.1, False, device='cpu',"
        " config=TINY[c][0], mix=TINY[c][1])\n"
        "print(guard.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_prints_no_result(capsys, monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sasrec.train", "--seed", str(2**31 + 5),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout of the benchmark's files alone: no result, exit not 0."""
    import shutil

    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    code = (
        "from portbench import run, spec\n"
        "from portbench.tests.conftest import TINY\n"
        "b = spec.load_benchmark()\n"
        "r, _ = run.execute(b, spec.cell(b, 'sasrec.train'), 1, 0.1, False,"
        " device='cpu', config=TINY['sasrec.train'][0],"
        " mix=TINY['sasrec.train'][1])\n"
        "print(__import__('json').dumps(r))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert "pio_tpu_torch" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
