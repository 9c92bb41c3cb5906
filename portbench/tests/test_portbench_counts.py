"""The FLOP and byte laws against hand-worked values."""

import pytest

from portbench import counts, peaks


def bench_seqrec_step(n, t, d, layers, ffn, vocab):
    """The JAX package benchmark's law: every position of every row."""
    fwd_per_token = layers * (8 * d * d + 4 * t * d + 4 * d * ffn) + 2 * d * vocab
    return 3 * fwd_per_token * n * t


@pytest.mark.parametrize("vocab", [20000, 20001])
def test_full_seqrec_step_is_the_documented_count(vocab):
    got = counts.seqrec_train_step_flops([128] * 256, 256, 4, 1024, vocab)
    assert got == bench_seqrec_step(256, 128, 256, 4, 1024, vocab)
    assert got == pytest.approx(1.6767e12, rel=1e-4)


def test_seqrec_counts_real_positions_only():
    full = counts.seqrec_train_step_flops([128], 256, 4, 1024, 20001)
    half = counts.seqrec_train_step_flops([64], 256, 4, 1024, 20001)
    assert half < full / 2  # the attention term falls with the square
    assert counts.seqrec_train_step_flops([0], 256, 4, 1024, 20001) == 0


def test_the_cells_full_step_at_every_position():
    got = counts.seqrec_train_step_flops([200] * 256, 50, 2, 50, 59048)
    assert got == bench_seqrec_step(256, 200, 50, 2, 50, 59048)
    # the logits, 3 * 2 * 50 * 59,048 a position, are 98% of it
    assert got == pytest.approx(9.285e11, rel=1e-3)


def test_every_seed_draws_the_same_lengths_in_another_order():
    from portbench import gen

    a = gen.lengths(gen.rng(1, 1), 162541, 20, 153.81, 1.1403, 10**6)
    b = gen.lengths(gen.rng(2**40 + 3, 1), 162541, 20, 153.81, 1.1403, 10**6)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.mean() == pytest.approx(153.81, rel=1e-3)
    assert a.min() == 20
    cut = gen.lengths(gen.rng(1, 1), 162541, 20, 153.81, 1.1403, 200)
    assert cut.max() == 200 and cut.mean() == pytest.approx(107.2, rel=1e-2)


def test_the_zipf_law_gives_the_top_items_share():
    from portbench import gen

    cdf = gen.zipf_cdf(59047, 0.5512)
    assert cdf[0] == pytest.approx(81491 / 25000095, rel=1e-3)
    lens = gen.lengths(gen.rng(4, 1), 300, 3, 9.0, 1.14, 16)
    h = gen.histories(4, lens, 50, 0.55, 16)
    assert h.shape == (300, 16) and h.dtype.name == "int32"
    assert ((h > 0).sum(axis=1) == lens).all()
    assert h.max() <= 50 and (h[h > 0] >= 1).all()
    assert (gen.histories(4, lens, 50, 0.55, 16) == h).all()


def test_least_seconds_takes_the_larger_bound():
    peak = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert counts.least_seconds(67e12, 0, peak) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12, peak) == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 6.7e12, peak) == pytest.approx(2.0)
    assert counts.least_seconds(1.0, 1.0, None) is None
    assert counts.adam_step_bytes(10) == 240


def test_peaks_know_the_h100_and_nothing_else():
    assert peaks.for_device("NVIDIA H100 80GB HBM3")["f32_flops"] == 67e12
    assert peaks.for_device("NVIDIA A100-SXM4-80GB") is None
