"""The control, at each cell's own size on the card: the reference in
the next precision down (TF32 products) put in the program's place has to
fail the cell's limits, on three seeds, where the program passes them."""

import pytest

from portbench import readings, run, spec

SEEDS = (5000000001, 5000000002, 5000000003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sasrec.train"])
def test_control_fails_where_the_program_passes(cell, cuda_device):
    bench = spec.load_benchmark()
    limits = spec.load_limits(cell)
    for seed in SEEDS:
        got = readings.read_seed(bench, spec.cell(bench, cell), seed,
                                 ["program", "control"], device=cuda_device)
        program = run.within(got["program"], limits)
        control = run.within(got["control"], limits)
        assert all(ok for *_, ok in program), (seed, program)
        assert not all(ok for *_, ok in control), (seed, control)
