"""Tests of the benchmark harness. They run on the CPU at tiny sizes;
those marked ``cuda`` need the card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: each cell's configuration and mix at a size the CPU runs in a second
TINY = {
    "sasrec.train": (
        dict(d_model=10, n_heads=1, n_layers=2, ffn=10, max_len=16,
             n_items=50, n_users=70, learning_rate=1e-3),
        dict(driver="seqrec_train", batch_size=16, epochs=1, len_min=3,
             len_mean=9.0, len_sigma=1.14, zipf_s=0.55)),
}


#: limits at the tiny sizes, each at or above the cell's own: with a few
#: rows a table's single component carries a visible share of a leaf's
#: change under Adam, so sound runs spread wider than at the cell's size;
#: every planted fault still reads 1e-2 or more
TINY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1.5e-2, "change_gap": 1e-2,
               "head_grad_gap": 1e-4, "init_gap": 0.0, "tf32_allowed": 0.0}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available()"
        " is false")


@pytest.fixture()
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture()
def tiny_run():
    """``tiny_run(cell, seed=...)``: one run of a cell on the CPU at its
    tiny size, held to ``TINY_LIMITS``: the result object."""
    from portbench import run, spec

    bench = spec.load_benchmark()

    def go(cell, seed=20240607, seconds=0.2, traced=False):
        config, mix = TINY[cell]
        result, _ = run.execute(bench, spec.cell(bench, cell), seed, seconds,
                                traced, device="cpu", config=config,
                                mix=mix, limits=TINY_LIMITS)
        return result

    return go
