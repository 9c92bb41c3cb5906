"""The port's streamed epoch feed (``pio_tpu_torch/parallel/stream.py``)
against the JAX package's, on the CPU.

- The sizing and schedule helpers (``n_stream_chunks``, ``span_bounds``,
  ``epoch_spans``) and ``record_overlap_ratio`` equal the reference's
  exactly over a grid.
- ``stream_feed`` gives one carry in every mode (queue-ahead,
  double-buffered, the serialized ``stats`` mode, the overlap probe of a
  recorded run), the reference's carry on the same chunks (sums of small
  integers in float32: exact), keeps at most ``lookahead + 1`` chunks in
  flight, hands ``finalize`` every chunk, and fires each of its three
  failpoints once a chunk, as the reference does.
- On the card (``cuda`` tests): the copies run from pinned buffers on the
  copy stream without a ``torch.cuda.synchronize()``, the ring holds
  ``lookahead + 1`` buffers a leaf, and the carry is the CPU's.

The streamed trainers' parity (streamed against staged bit for bit, and
against the reference within the staged runs' tolerances) is in
``test_torch_two_tower.py``, ``test_torch_seqrec.py`` and, over a data
axis of 2 ranks, ``test_torch_mesh_neural.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pio_tpu import faults as ref_faults
from pio_tpu.parallel import stream as R
from pio_tpu_torch import faults
from pio_tpu_torch.obs import trainwatch
from pio_tpu_torch.parallel import stream as S

MB = 2 ** 20


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("PIO_TPU_FAULTS", raising=False)
    faults.uninstall()
    ref_faults.uninstall()
    yield
    faults.uninstall()
    ref_faults.uninstall()


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("mb", ["64", "1", "0.25", "0", "-1"])
@pytest.mark.parametrize("cap", [8, 256])
def test_n_stream_chunks_matches_reference(monkeypatch, mb, cap):
    monkeypatch.setenv("PIO_TPU_TRAIN_STREAM_MB", mb)
    for nbytes in (0, 1, MB // 2, MB, 3 * MB + 1, 100 * MB, 10 ** 10):
        assert S.n_stream_chunks(nbytes, "PIO_TPU_TRAIN_STREAM_MB",
                                 cap=cap) == \
            R.n_stream_chunks(nbytes, "PIO_TPU_TRAIN_STREAM_MB", cap=cap)


def test_n_stream_chunks_default_matches_reference(monkeypatch):
    """Unset, the declared default (64 MB) in both."""
    monkeypatch.delenv("PIO_TPU_TRAIN_STREAM_MB", raising=False)
    for nbytes in (MB, 200 * MB, 10 ** 10):
        assert S.n_stream_chunks(nbytes, "PIO_TPU_TRAIN_STREAM_MB",
                                 cap=256) == \
            R.n_stream_chunks(nbytes, "PIO_TPU_TRAIN_STREAM_MB", cap=256)
    assert S.n_stream_chunks(200 * MB, "PIO_TPU_TRAIN_STREAM_MB",
                             cap=256) == 4


@pytest.mark.parametrize("n_batches", [1, 2, 5, 7, 16, 123])
def test_spans_match_reference(n_batches):
    for n_stream in (1, 2, 3, 8, 200):
        bounds = S.span_bounds(n_batches, n_stream)
        assert bounds == R.span_bounds(n_batches, n_stream)
        for step0 in (0, 1, n_batches - 1, 2 * n_batches + 3):
            for n in (1, n_batches, 2 * n_batches + 1):
                work = S.epoch_spans(step0, n, n_batches, bounds)
                assert work == R.epoch_spans(step0, n, n_batches, bounds)
                # the staged batch order, replayed
                assert [b for b0, b1 in work for b in range(b0, b1)] == \
                    [(step0 + k) % n_batches for k in range(n)]


def test_record_overlap_ratio_matches_reference():
    for h2d, dev, wall in ((2.0, 3.0, 3.0), (2.0, 3.0, 5.0),
                           (2.0, 3.0, 4.0), (0.0, 3.0, 3.0),
                           (1.5, 0.25, 1.6), (4.0, 4.0, 9.0)):
        got = S.record_overlap_ratio(h2d, dev, wall)
        assert got == R.record_overlap_ratio(h2d, dev, wall)
        assert S._OVERLAP.value() == got


# ------------------------------------------------------------ the executor
CHUNKS = [np.arange(4, dtype=np.float32) + 10 * c for c in range(5)]


def _run(lookahead=0, stats=None, finalize=None, put=None, device="cpu"):
    return S.stream_feed(
        list(range(len(CHUNKS))),
        encode=lambda c: CHUNKS[c],
        dispatch=lambda carry, dev, i: carry + dev.sum(),
        init_carry=lambda: torch.zeros((), device=device),
        put=put, finalize=finalize, lookahead=lookahead, stats=stats,
        device=device,
    )


def _ref_run(lookahead=0, stats=None):
    return float(R.stream_feed(
        list(range(len(CHUNKS))),
        encode=lambda c: CHUNKS[c],
        dispatch=lambda carry, dev, i: carry + jnp.sum(dev),
        init_carry=lambda: jnp.float32(0.0),
        lookahead=lookahead, stats=stats,
    ))


def test_modes_agree_with_each_other_and_the_reference():
    want = _ref_run()
    assert float(_run(lookahead=0)) == want
    assert float(_run(lookahead=1)) == want
    assert float(_run(lookahead=2)) == want
    assert float(_run(stats={})) == want == _ref_run(stats={})
    # a recorded run probes its overlap on chunk 0: the same carry
    rec = trainwatch.StepRecorder("stream-test")
    with trainwatch.recording(rec):
        assert float(_run(lookahead=2)) == want
    assert rec.h2d_bytes == 5 * 4 * 4
    assert rec.overlap_ratio is not None and 0.0 <= rec.overlap_ratio <= 1.0


def test_stats_keys_accumulate_as_the_reference_does():
    got, want = {}, {}
    _run(stats=got)
    _run(stats=got)
    _ref_run(stats=want)
    _ref_run(stats=want)
    assert set(got) == set(want) == {"encode_s", "h2d_s", "device_s",
                                     "h2d_bytes"}
    assert got["h2d_bytes"] == want["h2d_bytes"] == 2 * 5 * 4 * 4


def test_h2d_counter_increments():
    before = S._H2D_BYTES.value()
    _run(lookahead=2)
    assert S._H2D_BYTES.value() == before + 5 * 4 * 4


@pytest.mark.parametrize("lookahead", [1, 2, 3])
def test_at_most_lookahead_plus_one_chunks_in_flight(lookahead):
    """Counted through ``put``: a chunk is in flight from its put until
    its dispatch has returned (on the CPU its compute is done then)."""
    inflight, peak, order = [0], [0], []

    def put(host, i):
        inflight[0] += 1
        peak[0] = max(peak[0], inflight[0])
        order.append(("put", i))
        return torch.from_numpy(host)

    def dispatch(carry, dev, i):
        order.append(("dispatch", i))
        inflight[0] -= 1
        return carry + dev.sum()

    n = 12
    chunks = [np.full(3, c, np.float32) for c in range(n)]
    got = S.stream_feed(list(range(n)), encode=lambda c: chunks[c],
                        dispatch=dispatch, init_carry=lambda: 0.0, put=put,
                        lookahead=lookahead, device="cpu")
    assert float(got) == 3 * sum(range(n))
    assert peak[0] <= lookahead + 1
    assert [i for kind, i in order if kind == "put"] == list(range(n))
    # chunk i is shipped before its own dispatch, never more than
    # `lookahead` chunks ahead of it
    for j, (kind, i) in enumerate(order):
        if kind == "dispatch":
            shipped = {k for kd, k in order[:j] if kd == "put"}
            assert i in shipped and max(shipped) < i + lookahead + 1


def test_finalize_receives_every_chunk():
    for kwargs in ({"lookahead": 0}, {"lookahead": 2}, {"stats": {}}):
        carry, devs = _run(finalize=lambda c, d: (c, d), **kwargs)
        assert len(devs) == len(CHUNKS)
        for dev, host in zip(devs, CHUNKS):
            assert torch.equal(dev, torch.from_numpy(host))
        assert float(carry) == _ref_run()


def test_cpu_chunks_are_plain_tensors_without_pinning():
    before = S.pinned_buffers_allocated()
    carry, devs = _run(lookahead=2, finalize=lambda c, d: (c, d))
    assert all(d.device.type == "cpu" and not d.is_pinned() for d in devs)
    assert S.pinned_buffers_allocated() == before


@pytest.mark.parametrize("lookahead", [0, 2])
def test_failpoints_fire_once_a_chunk_a_phase(lookahead):
    """``stream.*=latency:0us`` counts every trigger without changing the
    run: each point fires once a chunk, in both packages."""
    spec = "stream.*=latency:0us"
    faults.install(spec)
    ref_faults.install(spec)
    assert float(_run(lookahead=lookahead)) == _ref_run(lookahead=lookahead)
    n = len(CHUNKS)
    want = {(p, "latency"): n for p in ("stream.encode", "stream.put",
                                        "stream.dispatch")}
    assert faults.trigger_counts() == want
    assert ref_faults.trigger_counts() == want


@pytest.mark.parametrize("point", ["stream.encode", "stream.put",
                                   "stream.dispatch"])
def test_an_injected_error_raises_from_the_feed(point):
    faults.install(f"{point}=error:once")
    with pytest.raises(faults.FaultInjected, match=point):
        _run(lookahead=1)
    # once: the next run is clean and gives the same carry
    assert float(_run(lookahead=1)) == _ref_run(lookahead=1)


def test_stream_ledger_returns_to_zero():
    from pio_tpu_torch.obs import devicewatch

    watch = devicewatch.DeviceWatch(device=torch.device("cpu"))
    with devicewatch.watching(watch, sample=False):
        _run(lookahead=2)
        _run(finalize=lambda c, d: (c, d))
        assert watch.ledger_bytes() == 0
        assert watch.compile_counts()["stream_dispatch"] == 1


# ------------------------------------------------------------------ the card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lookahead", [0, 2])
def test_card_copies_from_the_pinned_ring_without_a_device_sync(
        cuda_device, monkeypatch, lookahead):
    def no_sync(*a, **k):
        raise AssertionError("stream_feed called torch.cuda.synchronize")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    before = S.pinned_buffers_allocated()
    got = _run(lookahead=lookahead, device=cuda_device)
    assert got.device.type == "cuda"
    assert float(got) == _ref_run()
    assert S.pinned_buffers_allocated() - before == lookahead + 1
    carry, devs = _run(lookahead=lookahead, device=cuda_device,
                       finalize=lambda c, d: (c, d))
    for dev, host in zip(devs, CHUNKS):
        assert torch.equal(dev.cpu(), torch.from_numpy(host))


@pytest.mark.cuda
def test_card_holds_at_most_lookahead_plus_one_chunks(cuda_device):
    """16 chunks of 8 MiB through a slow dispatch: the peak of
    ``memory_allocated`` above the start stays within ``lookahead + 1``
    chunks and one chunk of the dispatch's temporaries (plus the
    carry)."""
    n, rows, lookahead = 16, 2 * MB, 2
    host = [np.full(rows, c, np.float32) for c in range(n)]

    def dispatch(carry, dev, i):
        x = torch.sin(dev)  # one chunk of temporaries
        for _ in range(20):  # enough work that copies run ahead
            torch.sin(x, out=x)
        return carry + x.sum()

    torch.cuda.synchronize(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    S.stream_feed(list(range(n)), encode=lambda c: host[c],
                  dispatch=dispatch,
                  init_carry=lambda: torch.zeros((), device=cuda_device),
                  lookahead=lookahead, device=cuda_device,
                  stage_bytes=(rows * 4,))
    torch.cuda.synchronize(cuda_device)
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak <= (lookahead + 1) * rows * 4 + rows * 4 + MB
