"""The plain reference against the port at a tiny size on the CPU. Only
this test imports both: the reference files import nothing of the port."""

import ast
from pathlib import Path

import pytest
import torch

from portbench import compare, gen
from portbench.reference import flat, seqrec as ref_seq
from portbench.reference.train import follow
from portbench.training import CHECK_STEPS, Tap, observe

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def test_reference_files_import_nothing_of_the_port_or_jax():
    for path in REFERENCE.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "pio_tpu", "pio_tpu_torch", "jax", "jaxlib", "flax"), path


def test_the_init_is_the_ports_bits():
    from pio_tpu_torch.models import seqrec

    cfg = seqrec.SeqRecConfig(d_model=10, n_heads=1, n_layers=2, ffn=10,
                              max_len=8)
    g = torch.Generator().manual_seed(91)
    port = flat(seqrec.init_params(51, cfg, g))
    mine = ref_seq.init_params(51, 10, 2, 10, 8, 91)
    assert list(port) == list(mine)
    assert all(torch.equal(port[k], mine[k]) for k in port)


def _histories(seed, n=40, width=12):
    lens = gen.lengths(gen.rng(seed, 1), n, 3, 7.0, 1.14, width)
    return gen.histories(seed, lens, 50, 0.55, width)


@pytest.mark.parametrize("seed,heads,block", [(3, 2, 0), (2**40 + 7, 1, 3)])
def test_seqrec_steps_follow_the_reference(seed, heads, block):
    from pio_tpu_torch.models.seqrec import SeqRecConfig, train_seqrec
    from pio_tpu_torch.obs import trainwatch

    seqs = _histories(seed)
    cfg = SeqRecConfig(d_model=16, n_heads=heads, n_layers=2, ffn=32,
                       max_len=12, steps=4, seed=seed, batch_size=8)
    rec = trainwatch.StepRecorder("t", loss_window=64)
    tap = Tap()
    with trainwatch.recording(rec):
        train_seqrec(None, seqs, 50, cfg, checkpoint=tap, checkpoint_every=1,
                     device="cpu")
    obs = observe(tap, list(rec.losses))
    _, batch = ref_seq.feed(seqs, 8, 12)
    ref = follow(ref_seq.init_params(51, 16, 2, 32, 12, seed),
                 lambda p, b: ref_seq.loss_sum(p, b, heads), ref_seq.count,
                 lambda s: tuple(map(torch.from_numpy, batch(s))),
                 CHECK_STEPS, 1e-3, "cpu", block_rows=block)
    got = compare.training(obs, ref)
    assert got["init_gap"] == 0.0
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4
    assert got["change_gap"] < 1e-3


def test_blocks_of_rows_give_the_whole_batchs_step():
    seqs = _histories(11)
    _, batch = ref_seq.feed(seqs, 8, 12)
    p0 = ref_seq.init_params(51, 16, 2, 32, 12, 5)

    def run(block):
        return follow(p0, lambda p, b: ref_seq.loss_sum(p, b, 2),
                      ref_seq.count,
                      lambda s: tuple(map(torch.from_numpy, batch(s))),
                      CHECK_STEPS, 1e-3, "cpu", block_rows=block)

    whole, blocks = run(0), run(3)
    assert whole.losses == pytest.approx(blocks.losses, rel=1e-6)
    for k in whole.grad_norms:
        assert whole.grad_norms[k] == pytest.approx(blocks.grad_norms[k],
                                                    rel=1e-5)


def test_the_head_gap_reads_the_head_leaves_alone():
    from portbench.reference.train import Observation

    ref = Observation(losses=[1.0], grad_norms={"a": 1.0, "b": 2.0, "h": 3.0},
                      change_norms={"a": 1.0, "b": 1.0, "h": 1.0}, start={})
    prog = Observation(losses=[1.0],
                       grad_norms={"a": 1.0 + 1e-3, "b": 2.0, "h": 3.0},
                       change_norms=dict(ref.change_norms), start={})
    got = compare.training(prog, ref, head=("h",))
    assert got["grad_gap"] == pytest.approx(5e-4)  # over the median, 2
    assert got["head_grad_gap"] == 0.0
    assert "head_grad_gap" not in compare.training(prog, ref)
    prog.grad_norms["h"] = 3.0 * (1 + 1e-5)
    assert compare.training(prog, ref, head=("h",))["head_grad_gap"] == \
        pytest.approx(1e-5)
