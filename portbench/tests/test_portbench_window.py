"""Busy time, idle share and rates from synthetic records."""

import pytest

from portbench import readers, trace
from portbench.trace import Op

MS = 1_000_000


def test_union_merges_overlaps_and_drops_empty():
    assert trace.union([(5, 9), (0, 3), (2, 4), (9, 9), (8, 12)]) == [
        (0, 4), (5, 12)]


def test_idle_share_of_overlapping_intervals():
    busy = trace.union(trace.clip([(0, 40), (30, 60), (100, 150)], 10, 120))
    assert busy == [(10, 60), (100, 120)]
    assert trace.idle_gaps(busy, 10, 120) == [(60, 100)]
    assert sum(e - s for s, e in busy) == 70


def _ops(offset):
    """Head sentinels, a window of work with copies, tail sentinels; the
    records' clock runs ``offset`` ns behind the host's."""
    ops = [Op("spin_kernel(long)", i * 10, i * 10 + 5) for i in range(300)]
    base = 10 * MS
    ops += [Op("sgemm", base + 0 * MS, base + 4 * MS),
            Op("Memcpy HtoD", base + 3 * MS, base + 5 * MS),
            Op("add", base + 20 * MS, base + 30 * MS),
            Op("sgemm", base + 80 * MS, base + 90 * MS)]
    ops += [Op("spin_kernel(long)", base + 200 * MS + i * 10,
               base + 200 * MS + i * 10 + 5) for i in range(300)]
    return [Op(o.name, o.start_ns - offset, o.end_ns - offset) for o in ops]


@pytest.mark.parametrize("offset", [0, 17 * MS])
def test_reduce_reads_busy_idle_kernels_and_gaps(offset):
    head_end = 299 * 10 + 5
    t0, t1 = 10 * MS, 110 * MS
    spans = [("train", t0, t0 + 50 * MS), ("train", t0 + 50 * MS, t1)]
    out = trace.reduce(_ops(offset), spans, t0, t1, head_host_ns=head_end)
    assert out["window_s"] == pytest.approx(0.1)
    assert out["busy_s"] == pytest.approx(0.025)
    assert out["kernels"] == 3
    assert out["sentinels"] == [300, 300]
    assert out["device_ops"][0][0] == "sgemm"
    assert out["device_ops"][0][1] == pytest.approx(0.014)
    assert out["idle_gaps"][0] == ["train", pytest.approx(0.05)]
    assert [g[0] for g in out["idle_gaps"]] == ["train", "train", "train"]
    assert len(out["idle_gaps"]) <= trace.TOP


def _run(**kw):
    base = dict(cell="c", setup_s=9.0, window_s=20.0, units=10, steps=300,
                totals={}, flops=6.7e14, least_s=5.0,
                peak={"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
                trace={"busy_s": 15.0, "window_s": 20.0, "kernels": 3000})
    base.update(kw)
    return readers.Run(**base)


def test_rates_are_over_the_whole_window():
    from portbench import spec

    run = _run()
    assert spec.load_metric("train_step_ms").read(run) == pytest.approx(
        20.0 * 1e3 / 300)
    # one run that outlasts the asked-for seconds: the whole run counts
    one = _run(units=1, steps=635, window_s=47.6)
    assert spec.load_metric("train_step_ms").read(one) == pytest.approx(
        47.6e3 / 635)
    assert spec.load_metric("train_step_ms").read(_run(steps=0)) is None
    assert spec.load_metric("setup_s").read(run) == 9.0


def test_shares_of_the_peak_the_roofline_and_the_idle_time():
    from portbench import spec

    run = _run()
    assert spec.load_metric("mfu.train").read(run) == pytest.approx(50.0)
    assert spec.load_metric("kernel_roofline_pct.train").read(run) == \
        pytest.approx(100 * 5 / 15)
    assert spec.load_metric("device_idle_pct.train").read(run) == \
        pytest.approx(25.0)
    assert spec.load_metric("launches_per_step.train").read(run) == 10
    # nothing to read: no trace, no peak, not this kind of cell
    assert spec.load_metric("device_idle_pct.train").read(_run(trace=None)) is None
    assert spec.load_metric("mfu.train").read(_run(peak=None)) is None
    assert spec.load_metric("mfu.train").read(_run(steps=0)) is None


@pytest.mark.parametrize("head,tail,whole", [
    (trace.SENTINELS, trace.SENTINELS, True),
    (trace.SENTINELS, trace.SENTINELS - 1, False),
    (trace.SENTINELS // 4, trace.SENTINELS, False),
    (0, 0, False)])
def test_a_window_is_whole_only_with_both_sentinel_groups_whole(head, tail,
                                                                 whole):
    t0, t1 = 10 * MS, 110 * MS
    ops = [Op("spin_kernel(long)", i * 10, i * 10 + 5) for i in range(head)]
    ops += [Op("sgemm", t0 + MS, t0 + 2 * MS)]
    ops += [Op("spin_kernel(long)", t1 + 5 * MS + i * 10,
               t1 + 5 * MS + i * 10 + 5) for i in range(tail)]
    assert trace.reduce(ops, [], t0, t1, None)["complete"] is whole


def test_a_traced_run_with_a_broken_window_prints_no_result(monkeypatch,
                                                             capsys):
    import torch

    from portbench import run

    def execute(*a, **kw):
        return {"correct": True, "trace": {"complete": False,
                                           "sentinels": [256, 40]}}, []

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "execute", execute)
    rc = run.main(["--workload", "sasrec.train", "--seed", "7",
                   "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "sentinels" in out.err
